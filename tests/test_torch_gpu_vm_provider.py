"""GPU-VM provider: async provisioning + node-group atomicity, case for case
``test_tpu_vm_provider.py``'s, with a group of GPU hosts in place of a TPU
slice.

Driven entirely through a fake GpuVmApi; reference analog:
autoscaler/_private/gcp/node_provider.py operation-polling tests.
"""

from typing import Dict

from ray_tpu_torch.autoscaler.gpu_vm_provider import (FAILED, PENDING, READY,
                                                      GpuCapacityError,
                                                      GpuVmApi,
                                                      GPUVMNodeProvider)
from ray_tpu_torch.autoscaler.node_provider import NodeTypeConfig


class FakeGpuVmApi(GpuVmApi):
    def __init__(self):
        self.ops: Dict[str, Dict] = {}
        self.deleted = []
        self.capacity_failures = 0      # fail this many creates first
        self._n = 0

    def create_node_group(self, machine_type, hosts, labels):
        if self.capacity_failures > 0:
            self.capacity_failures -= 1
            raise GpuCapacityError("no capacity in pool")
        self._n += 1
        op = f"op{self._n}"
        self.ops[op] = {"state": PENDING,
                        "hosts": [f"{op}-h{i}" for i in range(hosts)],
                        "error": None}
        return op

    def get_operation(self, op_id):
        return dict(self.ops[op_id])

    def delete_node_group(self, group_id):
        self.deleted.append(group_id)


# Four 8-card hosts on one fabric, created and ended together.
H100X8_X4 = NodeTypeConfig(name="h100x8-x4",
                           resources={"hosts": 4, "GPU": 8, "CPU": 208})


def test_group_surfaces_only_when_ready():
    api = FakeGpuVmApi()
    p = GPUVMNodeProvider(api)
    (op,) = p.create_node(H100X8_X4, 1)
    assert p.non_terminated_nodes() == []          # still PENDING
    api.ops[op]["state"] = READY
    nodes = p.non_terminated_nodes()
    assert len(nodes) == 4                          # the whole group at once
    assert all(n.node_type == "h100x8-x4" for n in nodes)


def test_failed_operation_tears_down_partial_group():
    api = FakeGpuVmApi()
    p = GPUVMNodeProvider(api)
    (op,) = p.create_node(H100X8_X4, 1)
    api.ops[op]["state"] = FAILED
    api.ops[op]["error"] = "stockout mid-create"
    assert p.non_terminated_nodes() == []
    assert api.deleted == [op]                      # partial hosts reclaimed
    assert p.failed_launches[0]["error"] == "stockout mid-create"


def test_capacity_errors_retry_with_backoff_then_succeed():
    api = FakeGpuVmApi()
    api.capacity_failures = 2
    p = GPUVMNodeProvider(api, retry_backoff_s=0.0)
    p.create_node(H100X8_X4, 1)
    # two polls consume the backoff retries, third create succeeds
    for _ in range(4):
        p.non_terminated_nodes()
    assert api.ops                                  # create finally landed
    op = next(iter(api.ops))
    api.ops[op]["state"] = READY
    assert len(p.non_terminated_nodes()) == 4
    assert not p.failed_launches


def test_capacity_errors_exhaust_budget():
    api = FakeGpuVmApi()
    api.capacity_failures = 99
    p = GPUVMNodeProvider(api, max_create_retries=2, retry_backoff_s=0.0)
    p.create_node(H100X8_X4, 1)
    for _ in range(6):
        p.non_terminated_nodes()
    assert p.failed_launches and "capacity" in p.failed_launches[0]["error"]
    assert p.non_terminated_nodes() == []


def test_terminating_one_host_removes_whole_group():
    api = FakeGpuVmApi()
    p = GPUVMNodeProvider(api)
    (op,) = p.create_node(H100X8_X4, 1)
    api.ops[op]["state"] = READY
    nodes = p.non_terminated_nodes()
    p.terminate_node(nodes[2].node_id)
    assert p.non_terminated_nodes() == []           # no 3-host "group"
    assert api.deleted == [op]

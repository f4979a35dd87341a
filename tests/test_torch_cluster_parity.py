"""The cluster layer and tools of both packages on the same inputs.

* ``ResourceDemandScheduler.get_nodes_to_launch`` on 200 seeded random
  sets of node types, demands, free capacity and counts: the port's with
  ``GPU`` and ``accelerator_type:H100`` where the reference's has ``TPU``
  and ``tpu-slice:v4-8``, the same launches.
* ``GPUVMNodeProvider`` and ``TPUVMNodeProvider`` under one scripted fake
  cloud (capacity errors, pending, ready, failed and partial operations,
  a terminated host): the same node lists and failed launches after every
  step.
* ``ray_dask_get`` on the reference's graphs, each package in local mode:
  the same values.
* ``inspect_serializability``: the same verdict and failure names.
* The CLI's ``status`` JSON: the same keys, each package's head started by
  its own CLI in a private session directory.
"""

import json
import operator
import os
import subprocess
import sys
import threading

import numpy as np

from ray_tpu.autoscaler import tpu_vm_provider as tpu
from ray_tpu.autoscaler.node_provider import NodeTypeConfig as TpuNodeType
from ray_tpu.autoscaler.resource_demand_scheduler import (
    ResourceDemandScheduler as TpuScheduler)
from ray_tpu_torch.autoscaler import gpu_vm_provider as gpu
from ray_tpu_torch.autoscaler.node_provider import (
    NodeTypeConfig as GpuNodeType)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
    ResourceDemandScheduler as GpuScheduler)

# The port's resource names and the reference's they stand for.
NAMES = {"CPU": "CPU", "GPU": "TPU", "memory": "memory",
         "accelerator_type:H100": "tpu-slice:v4-8"}


def _to_tpu(res):
    return {NAMES[k]: v for k, v in res.items()}


def _random_case(rng):
    names = list(NAMES)
    types = []
    for i in range(int(rng.integers(1, 5))):
        keys = ["CPU"] + [k for k in names[1:] if rng.random() < 0.5]
        types.append((f"t{i}", {k: float(rng.integers(1, 9)) for k in keys},
                      int(rng.integers(0, 3)), int(rng.integers(1, 6))))
    demands = []
    for _ in range(int(rng.integers(0, 12))):
        keys = [k for k in names if rng.random() < 0.4] or ["CPU"]
        demands.append({k: float(rng.integers(1, 6)) for k in keys})
    free = [{k: float(rng.integers(0, 5)) for k in names
             if rng.random() < 0.6} for _ in range(int(rng.integers(0, 3)))]
    counts = {name: int(rng.integers(0, 3)) for name, *_ in types
              if rng.random() < 0.5}
    return types, demands, free, counts, int(rng.integers(1, 12))


def test_demand_scheduler_launches_the_same_nodes():
    rng = np.random.default_rng(0)
    launched = 0
    for _ in range(200):
        types, demands, free, counts, max_workers = _random_case(rng)
        port = GpuScheduler([GpuNodeType(n, dict(r), lo, hi)
                             for n, r, lo, hi in types], max_workers)
        ref = TpuScheduler([TpuNodeType(n, _to_tpu(r), lo, hi)
                            for n, r, lo, hi in types], max_workers)
        got = port.get_nodes_to_launch(free, demands, counts)
        want = ref.get_nodes_to_launch([_to_tpu(f) for f in free],
                                       [_to_tpu(d) for d in demands],
                                       counts)
        assert got == want, (types, demands, free, counts)
        assert port.min_workers_to_launch(counts) == \
            ref.min_workers_to_launch(counts)
        launched += sum(got.values())
    assert launched > 100        # the cases launch, not only drop


class _ScriptedCloud:
    """One fake cloud behind both providers' API names."""

    def __init__(self, capacity_error):
        self.capacity_error = capacity_error
        self.ops, self.deleted = {}, []
        self.capacity_failures = 0
        self._n = 0

    def _create(self, machine, hosts, labels):
        if self.capacity_failures > 0:
            self.capacity_failures -= 1
            raise self.capacity_error("no capacity in pool")
        self._n += 1
        op = f"op{self._n}"
        self.ops[op] = {"state": "PENDING", "error": None,
                        "hosts": [f"{op}-h{i}" for i in range(hosts)]}
        return op

    create_slice = create_node_group = _create

    def get_operation(self, op_id):
        return dict(self.ops[op_id])

    def _delete(self, group_id):
        self.deleted.append(group_id)

    delete_slice = delete_node_group = _delete


SCRIPT = [
    ("create", 2), ("poll",), ("ready", "op1"), ("poll",),
    ("capacity", 2), ("create", 1), ("poll",), ("poll",), ("poll",),
    ("fail", "op2", "stockout mid-create"), ("poll",),
    ("ready", "op3"), ("poll",), ("terminate", "op1-h1"), ("poll",),
    ("capacity", 9), ("create", 1), ("poll",), ("poll",), ("poll",),
    ("poll",), ("terminate", "op3-h0"), ("poll",),
]


def _run_script(provider, cloud, node_type):
    trace = []
    for step in SCRIPT:
        kind = step[0]
        if kind == "create":
            provider.create_node(node_type, step[1])
        elif kind == "capacity":
            cloud.capacity_failures = step[1]
        elif kind == "ready":
            cloud.ops[step[1]]["state"] = "READY"
        elif kind == "fail":
            cloud.ops[step[1]].update(state="FAILED", error=step[2])
        elif kind == "terminate":
            provider.terminate_node(step[1])
        nodes = sorted((n.node_id, n.node_type)
                       for n in provider.non_terminated_nodes())
        trace.append((nodes, [dict(f) for f in provider.failed_launches],
                      list(cloud.deleted)))
    return trace


def test_vm_providers_track_the_same_nodes_and_failures():
    gcloud = _ScriptedCloud(gpu.GpuCapacityError)
    tcloud = _ScriptedCloud(tpu.TpuCapacityError)
    port = gpu.GPUVMNodeProvider(gcloud, max_create_retries=2,
                                 retry_backoff_s=0.0)
    ref = tpu.TPUVMNodeProvider(tcloud, max_create_retries=2,
                                retry_backoff_s=0.0)
    got = _run_script(port, gcloud, GpuNodeType(
        "group", {"hosts": 3, "GPU": 8, "CPU": 208}))
    want = _run_script(ref, tcloud, TpuNodeType(
        "group", {"hosts": 3, "TPU": 4, "CPU": 208}))
    assert got == want
    assert got[-1][1] and any(nodes for nodes, _, _ in got)


GRAPHS = [
    ({"x": 1, "y": (operator.add, "x", 2), "z": (operator.mul, "y", "y"),
      "alias": "z"}, ["x", "y", "z", "alias"]),
    ({"a": 2, "b": (sum, [(operator.mul, "a", 3), "a", 1])},
     [["a"], ["b", "a"]]),
    ({("x", 0): 10, ("x", 1): (operator.add, ("x", 0), 5),
      ("sum", 0): (operator.add, ("x", 1), ("x", 0))},
     [[("x", 1), ("sum", 0)]]),
    ({"x": 5, "mid": (operator.neg, "x"),
      "l": (operator.mul, "mid", 10), "r": (operator.add, "mid", 100)},
     ["l", "r"]),
]


def _dask_values(pkg, get):
    pkg.init(local_mode=True)
    try:
        return [get(graph, keys) for graph, keys in GRAPHS]
    finally:
        pkg.shutdown()


def test_dask_get_gives_the_same_values():
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.util.dask_shim import ray_dask_get as ref_get
    from ray_tpu_torch.util.dask_shim import ray_dask_get as port_get
    got = _dask_values(ray_tpu_torch, port_get)
    want = _dask_values(ray_tpu, ref_get)
    assert got == want == [[1, 3, 9, 9], [[2], [9, 2]], [[15, 25]],
                           [-50, 95]]


class _Holder:
    def __init__(self, lock):
        self.fine = 42
        self.bad = lock
        self.nested = {"ok": [1, 2], "inner": [lock]}


def test_inspect_serializability_gives_the_same_report():
    from ray_tpu.util.check_serialize import inspect_serializability as ref
    from ray_tpu_torch.util.check_serialize import (
        inspect_serializability as port)
    lock = threading.Lock()

    def closure_fn():
        return lock

    for obj in (closure_fn, _Holder(lock), lambda x: x + 1, [1, lock],
                {"k": _Holder(lock)}):
        (ok_p, fails_p), (ok_r, fails_r) = port(obj), ref(obj)
        assert ok_p == ok_r
        assert [(f.name, f.parent, type(f.obj)) for f in fails_p] == \
            [(f.name, f.parent, type(f.obj)) for f in fails_r]


def _status_keys(package, tmp_path):
    env = {**os.environ, "RT_SESSION_DIR": str(tmp_path / package),
           "JAX_PLATFORMS": "cpu"}

    def cli(*argv):
        r = subprocess.run([sys.executable, "-m", package, *argv], env=env,
                           capture_output=True, text=True, timeout=180)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    cli("start", "--head", "--num-cpus", "2", "--port", "0",
        "--dashboard-port", "-1")
    try:
        summary = json.loads(cli("status"))
    finally:
        cli("stop")
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in summary.items()}


def test_cli_status_json_has_the_same_keys(tmp_path):
    keys = _status_keys("ray_tpu_torch", tmp_path)
    assert keys == _status_keys("ray_tpu", tmp_path)
    assert keys["resources"] == ["available", "total"]

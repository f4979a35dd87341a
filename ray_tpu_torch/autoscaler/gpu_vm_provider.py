"""GPU-VM node provider: group-atomic provisioning against a cloud API.

Port of ``ray_tpu/autoscaler/tpu_vm_provider.py``, with GPU machines in
place of TPU slices.  Design analog: reference
``python/ray/autoscaler/_private/gcp/node_provider.py`` (GCPNodeProvider:
API-backed create/terminate with operation polling) — reshaped for GPU
machines that train together, where the provisioning unit is a NODE GROUP
(one or more GPU hosts created together on one interconnect), not an
instance:

  * group atomicity — a group of 4 hosts on one NVLink/InfiniBand fabric
    exists whole or not at all; a partially-created group is torn down,
    never surfaced.
  * async provisioning — the cloud API returns long-running operations;
    the provider polls them off the autoscaler's critical path and
    surfaces nodes only when the whole group is READY.
  * error taxonomy — QUOTA/CAPACITY errors (common for GPU pools) are
    retried with backoff up to a budget; permanent errors mark the launch
    failed so the autoscaler's demand loop can pick a different shape.

The cloud API is injected (``GpuVmApi`` protocol) so the provisioning
state machine is fully testable without a cloud: tests drive it with a
fake API that injects capacity errors and partial-group failures.  Wiring
an actual cloud client is a deployment concern (create_node_group/
delete_node_group/get_operation are 1:1 with a cloud's create, delete and
operation-status verbs).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (NODE_TYPE_LABEL,
                                                    NodeProvider,
                                                    NodeTypeConfig,
                                                    ProviderNode)

# operation states reported by GpuVmApi.get_operation
PENDING, READY, FAILED = "PENDING", "READY", "FAILED"


class GpuCapacityError(RuntimeError):
    """Transient: no capacity / quota right now — retry with backoff."""


class GpuVmApi:
    """Injected cloud surface (1:1 with a cloud's VM verbs)."""

    def create_node_group(self, machine_type: str, hosts: int,
                          labels: Dict[str, str]) -> str:
        """Begin creating one node group (all its hosts); returns the
        operation id.  Raises GpuCapacityError when the pool has no
        capacity."""
        raise NotImplementedError

    def get_operation(self, op_id: str) -> Dict:
        """{"state": PENDING|READY|FAILED, "hosts": [host_id, ...],
        "error": str|None}.  READY means EVERY host of the group is up."""
        raise NotImplementedError

    def delete_node_group(self, group_id: str) -> None:
        raise NotImplementedError


@dataclass
class _Launch:
    op_id: str
    node_type: str
    labels: Dict[str, str]
    attempts: int = 0
    next_poll: float = 0.0
    # retry bookkeeping for capacity-failed creates (op_id == "")
    machine_type: str = ""
    hosts: int = 1


@dataclass
class _Group:
    group_id: str
    node_type: str
    hosts: List[str]
    labels: Dict[str, str] = field(default_factory=dict)


class GPUVMNodeProvider(NodeProvider):
    """Group-atomic async provider over an injected GpuVmApi."""

    def __init__(self, api: GpuVmApi, *,
                 machine_types: Optional[Dict[str, str]] = None,
                 max_create_retries: int = 5,
                 retry_backoff_s: float = 2.0):
        self._api = api
        self._machine = machine_types or {}
        self._max_retries = max_create_retries
        self._backoff = retry_backoff_s
        self._lock = threading.Lock()
        self._groups: Dict[str, _Group] = {}
        self._launches: List[_Launch] = []
        self.failed_launches: List[Dict] = []   # surfaced to the monitor

    # -- NodeProvider surface --------------------------------------------

    def non_terminated_nodes(self) -> List[ProviderNode]:
        self._poll_launches()
        with self._lock:
            out = []
            for g in self._groups.values():
                for h in g.hosts:
                    out.append(ProviderNode(node_id=h,
                                            node_type=g.node_type,
                                            labels=dict(g.labels)))
            return out

    def create_node(self, node_type: NodeTypeConfig, count: int,
                    labels: Optional[Dict[str, str]] = None) -> List[str]:
        """Begin `count` group launches; returns operation ids (nodes
        surface via non_terminated_nodes once their group is READY)."""
        labels = {**(labels or {}), NODE_TYPE_LABEL: node_type.name}
        machine = self._machine.get(node_type.name, node_type.name)
        hosts = max(1, int(node_type.resources.get("hosts", 1)))
        ops = []
        for _ in range(count):
            op = self._begin_launch(machine, hosts, node_type.name, labels)
            if op is not None:
                ops.append(op)
        return ops

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            for gid, g in self._groups.items():
                if node_id in g.hosts:
                    break
            else:
                return
        # Terminating ANY host tears down the whole group — a group with a
        # missing host is not a smaller group, it's a broken one (its
        # collectives span every host).  Delete FIRST, untrack after: a
        # failed delete must leave the group visible so it can be
        # re-terminated, not orphan a live (billing) group.
        self._api.delete_node_group(gid)
        with self._lock:
            self._groups.pop(gid, None)

    # -- provisioning state machine --------------------------------------

    def _begin_launch(self, machine, hosts, type_name, labels,
                      attempts: int = 0) -> Optional[str]:
        try:
            op_id = self._api.create_node_group(machine, hosts, labels)
        except GpuCapacityError as e:
            if attempts >= self._max_retries:
                self.failed_launches.append(
                    {"node_type": type_name, "error": str(e)})
                return None
            with self._lock:
                self._launches.append(_Launch(
                    op_id="", node_type=type_name, labels=labels,
                    attempts=attempts + 1,
                    next_poll=time.monotonic() +
                    self._backoff * (2 ** attempts),
                    machine_type=machine, hosts=hosts))
            return None
        with self._lock:
            self._launches.append(_Launch(op_id=op_id, node_type=type_name,
                                          labels=labels, attempts=attempts))
        return op_id

    def _poll_launches(self) -> None:
        now = time.monotonic()
        with self._lock:
            launches, self._launches = self._launches, []
        for ln in launches:
            if ln.op_id == "":
                # a backoff-scheduled retry of a capacity failure
                if now >= ln.next_poll:
                    self._begin_launch(ln.machine_type, ln.hosts,
                                       ln.node_type, ln.labels,
                                       attempts=ln.attempts)
                else:
                    with self._lock:
                        self._launches.append(ln)
                continue
            op = self._api.get_operation(ln.op_id)
            if op["state"] == PENDING:
                with self._lock:
                    self._launches.append(ln)
            elif op["state"] == READY:
                with self._lock:
                    self._groups[ln.op_id] = _Group(
                        group_id=ln.op_id, node_type=ln.node_type,
                        hosts=list(op["hosts"]), labels=ln.labels)
            else:  # FAILED — tear down any partially-created hosts
                try:
                    self._api.delete_node_group(ln.op_id)
                except Exception:
                    pass
                self.failed_launches.append(
                    {"node_type": ln.node_type,
                     "error": op.get("error") or "operation failed"})

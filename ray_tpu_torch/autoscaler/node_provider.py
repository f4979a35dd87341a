"""Node providers: the pluggable "cloud" behind the autoscaler.

Port of ``ray_tpu/autoscaler/node_provider.py``.

Design analog: reference ``python/ray/autoscaler/node_provider.py:13``
(NodeProvider base: non_terminated_nodes / create_node / terminate_node /
node_tags) and ``autoscaler/_private/fake_multi_node/node_provider.py:237``
(FakeMultiNodeProvider -- nodes as local processes, the test backend).
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Label key carrying the provider node-type name on launched nodes; the
# autoscaler uses it to map live GCS nodes back to provider node types
# (reference: TAG_RAY_USER_NODE_TYPE).
NODE_TYPE_LABEL = "rt-node-type"
LAUNCH_ID_LABEL = "rt-launch-id"


@dataclass
class NodeTypeConfig:
    """One launchable node shape (reference: available_node_types entries in
    the cluster YAML, ray-schema.json).

    A node type may be one GPU machine (e.g. ``{"CPU": 208, "GPU": 8,
    "accelerator_type:H100": 1}``) or a *group* of them on one
    interconnect: `resources` then describes one host and ``hosts`` the
    group's size, and the provider brings up all of its hosts atomically
    -- a group is all-or-nothing.
    """
    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class ProviderNode:
    node_id: str
    node_type: str
    labels: Dict[str, str] = field(default_factory=dict)


class NodeProvider:
    """Abstract provider. Implementations must be thread-safe: the monitor
    loop calls from its own thread."""

    def non_terminated_nodes(self) -> List[ProviderNode]:
        raise NotImplementedError

    def create_node(self, node_type: NodeTypeConfig, count: int,
                    labels: Optional[Dict[str, str]] = None) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError


class MockNodeProvider(NodeProvider):
    """Records create/terminate calls; for unit tests (reference:
    test_autoscaler.py MockProvider)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.nodes: Dict[str, ProviderNode] = {}
        self.create_calls: List[tuple] = []
        self.terminate_calls: List[str] = []

    def non_terminated_nodes(self) -> List[ProviderNode]:
        with self._lock:
            return list(self.nodes.values())

    def create_node(self, node_type, count, labels=None):
        created = []
        with self._lock:
            self.create_calls.append((node_type.name, count))
            for _ in range(count):
                nid = uuid.uuid4().hex[:12]
                self.nodes[nid] = ProviderNode(
                    node_id=nid, node_type=node_type.name,
                    labels=dict(labels or {},
                                **{NODE_TYPE_LABEL: node_type.name}))
                created.append(nid)
        return created

    def terminate_node(self, node_id):
        with self._lock:
            self.terminate_calls.append(node_id)
            self.nodes.pop(node_id, None)


class LocalNodeProvider(NodeProvider):
    """Launches real node daemons on this machine via `cluster_utils.Cluster`
    -- the FakeMultiNodeProvider equivalent, used for end-to-end autoscaler
    tests and local elastic clusters."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self._nodes: Dict[str, object] = {}   # provider id -> ClusterNode

    def non_terminated_nodes(self) -> List[ProviderNode]:
        with self._lock:
            out = []
            for pid, cn in list(self._nodes.items()):
                if cn.proc.poll() is None:
                    out.append(ProviderNode(
                        node_id=pid,
                        node_type=cn.info.get("labels", {}).get(
                            NODE_TYPE_LABEL, ""),
                        labels=cn.info.get("labels", {})))
                else:
                    del self._nodes[pid]
            return out

    def create_node(self, node_type, count, labels=None):
        created = []
        for _ in range(count):
            pid = uuid.uuid4().hex[:12]
            merged = dict(labels or {})
            merged[NODE_TYPE_LABEL] = node_type.name
            merged[LAUNCH_ID_LABEL] = pid
            cn = self._cluster.add_node(
                resources=dict(node_type.resources), labels=merged)
            cn.info.setdefault("labels", merged)
            with self._lock:
                self._nodes[pid] = cn
            created.append(pid)
        return created

    def terminate_node(self, node_id):
        with self._lock:
            cn = self._nodes.pop(node_id, None)
        if cn is not None:
            self._cluster.remove_node(cn)

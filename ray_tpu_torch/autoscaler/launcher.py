"""Port of ``ray_tpu/autoscaler/launcher.py``.  Cluster launcher:
``ray_tpu_torch up / down`` from a YAML config.

Design analog: reference ``python/ray/autoscaler/_private/commands.py``
(``create_or_update_cluster`` behind ``ray up``, ``teardown_cluster``
behind ``ray down``) and the cluster YAML schema
(``autoscaler/ray-schema.json``).  Deltas: a node type may be a group of
GPU hosts on one interconnect, created atomically by the provider, and
instead of SSH-bootstrapping cloud VMs the launcher drives a NodeProvider
— GPUVMNodeProvider for GPU machines behind a cloud API, mock / local
providers for tests and laptops.

YAML shape::

    cluster_name: my-cluster
    max_workers: 8
    idle_timeout_s: 120
    provider:
      type: mock          # mock | gpu_vm
      # provider-specific keys (gpu_vm: machine_types, ...)
    available_node_types:
      h100x8:
        resources: {"CPU": 208, "GPU": 8, "accelerator_type:H100": 1}
        min_workers: 1
        max_workers: 4
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import AutoscalerConfig
from ray_tpu_torch.autoscaler.monitor import Monitor
from ray_tpu_torch.autoscaler.node_provider import (NodeProvider,
                                                    NodeTypeConfig)


@dataclasses.dataclass
class ClusterConfig:
    cluster_name: str
    provider: Dict[str, Any]
    node_types: List[NodeTypeConfig]
    max_workers: int = 20
    idle_timeout_s: float = 120.0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ClusterConfig":
        for key in ("cluster_name", "provider", "available_node_types"):
            if key not in d:
                raise ValueError(f"cluster config missing '{key}'")
        if "type" not in d["provider"]:
            raise ValueError("provider config needs a 'type'")
        node_types = []
        for name, spec in d["available_node_types"].items():
            unknown = set(spec) - {"resources", "min_workers",
                                   "max_workers"}
            if unknown:
                raise ValueError(f"node type {name!r}: unknown keys "
                                 f"{sorted(unknown)}")
            node_types.append(NodeTypeConfig(
                name=name,
                resources=dict(spec.get("resources", {})),
                min_workers=int(spec.get("min_workers", 0)),
                max_workers=int(spec.get("max_workers", 10))))
        return ClusterConfig(
            cluster_name=d["cluster_name"],
            provider=dict(d["provider"]),
            node_types=node_types,
            max_workers=int(d.get("max_workers", 20)),
            idle_timeout_s=float(d.get("idle_timeout_s", 120.0)))

    @staticmethod
    def from_file(path: str) -> "ClusterConfig":
        import yaml
        with open(path) as f:
            return ClusterConfig.from_dict(yaml.safe_load(f))


def _make_provider(cfg: ClusterConfig) -> NodeProvider:
    ptype = cfg.provider["type"]
    if ptype == "mock":
        from ray_tpu_torch.autoscaler.node_provider import MockNodeProvider
        return MockNodeProvider()
    if ptype == "gpu_vm":
        from ray_tpu_torch.autoscaler.gpu_vm_provider import (
            GPUVMNodeProvider)
        kwargs = {k: v for k, v in cfg.provider.items() if k != "type"}
        api = kwargs.pop("api", None)
        if api is None:
            raise ValueError(
                "provider type 'gpu_vm' needs an 'api' object (a GpuVmApi "
                "implementation bound to your cloud credentials); pass it "
                "via ClusterLauncher(config, provider=...) or the "
                "provider dict")
        return GPUVMNodeProvider(api, **kwargs)
    raise ValueError(f"unknown provider type {ptype!r} "
                     f"(available: mock, gpu_vm)")


class ClusterLauncher:
    """Owns one launched cluster: provider + autoscaler monitor.

    ``up()`` satisfies every node type's min_workers immediately (the
    reference's ``ray up`` bootstrap) and starts the monitor so demand
    scaling continues; ``down()`` stops the monitor and terminates every
    provider node.
    """

    def __init__(self, config: ClusterConfig,
                 provider: Optional[NodeProvider] = None,
                 load_source=None):
        self.config = config
        self.provider = provider or _make_provider(config)
        self._monitor: Optional[Monitor] = None
        self._load_source = load_source or (lambda: {
            "nodes": [], "pending_tasks": [], "pending_actors": [],
            "pending_pg_bundles": []})

    def up(self, start_monitor: bool = True) -> Dict[str, int]:
        launched: Dict[str, int] = {}
        counts: Dict[str, int] = {}
        for pn in self.provider.non_terminated_nodes():
            counts[pn.node_type] = counts.get(pn.node_type, 0) + 1
        for ntype in self.config.node_types:
            short = ntype.min_workers - counts.get(ntype.name, 0)
            if short > 0:
                self.provider.create_node(ntype, short)
                launched[ntype.name] = short
        if start_monitor:
            self._monitor = Monitor(
                self.provider,
                AutoscalerConfig(
                    node_types=self.config.node_types,
                    max_workers=self.config.max_workers,
                    idle_timeout_s=self.config.idle_timeout_s),
                load_source=self._load_source).start()
        return launched

    def down(self) -> int:
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None
        nodes = self.provider.non_terminated_nodes()
        for pn in nodes:
            self.provider.terminate_node(pn.node_id)
        return len(nodes)

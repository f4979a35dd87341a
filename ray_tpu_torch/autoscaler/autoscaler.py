"""StandardAutoscaler: one update() = read load, launch shortfall, reap idle.

Port of ``ray_tpu/autoscaler/autoscaler.py``.

Design analog: reference ``autoscaler/_private/autoscaler.py:167``
(StandardAutoscaler.update: launch from ResourceDemandScheduler output,
terminate nodes idle past idle_timeout, enforce min/max workers).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (NODE_TYPE_LABEL,
                                                    NodeProvider,
                                                    NodeTypeConfig)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
    ResourceDemandScheduler)

logger = logging.getLogger(__name__)


@dataclass
class AutoscalerConfig:
    node_types: List[NodeTypeConfig] = field(default_factory=list)
    max_workers: int = 20
    idle_timeout_s: float = 60.0
    # Scale-up batching: at most this many nodes launched per update.
    max_launch_batch: int = 5


class StandardAutoscaler:
    """Drives a NodeProvider from a load-metrics callable.

    `load_source()` must return the GCS `get_load_metrics` dict:
    {nodes: [...], pending_tasks: [...], pending_actors: [...],
     pending_pg_bundles: [...]}.
    """

    def __init__(self, provider: NodeProvider, config: AutoscalerConfig,
                 load_source: Callable[[], dict]):
        self.provider = provider
        self.config = config
        self.load_source = load_source
        self.scheduler = ResourceDemandScheduler(
            config.node_types, max_workers=config.max_workers)
        # GCS node hex -> monotonic time it became idle (demand-free).
        self._idle_since: Dict[str, float] = {}

    def update(self) -> Dict[str, int]:
        """One reconciliation pass. Returns {node_type: launched_count}."""
        load = self.load_source()
        provider_nodes = self.provider.non_terminated_nodes()
        counts: Dict[str, int] = {}
        for pn in provider_nodes:
            counts[pn.node_type] = counts.get(pn.node_type, 0) + 1

        demands = (list(load.get("pending_tasks", [])) +
                   list(load.get("pending_actors", [])) +
                   list(load.get("pending_pg_bundles", [])))
        alive = [n for n in load.get("nodes", []) if n.get("alive")]
        free = [dict(n.get("resources_available", {})) for n in alive]

        to_launch = self.scheduler.get_nodes_to_launch(free, demands, counts)
        for name, short in self.scheduler.min_workers_to_launch(
                counts).items():
            to_launch[name] = max(to_launch.get(name, 0), short)

        launched: Dict[str, int] = {}
        budget = self.config.max_launch_batch
        for name, n in to_launch.items():
            n = min(n, budget)
            if n <= 0:
                continue
            t = self.scheduler.node_types[name]
            logger.info("autoscaler: launching %d x %s for %d pending "
                        "demands", n, name, len(demands))
            self.provider.create_node(t, n)
            launched[name] = n
            budget -= n

        self._terminate_idle(alive, demands, provider_nodes, counts)
        return launched

    # ------------------------------------------------------------ scale down

    def _terminate_idle(self, alive_gcs_nodes: List[dict],
                        demands: List[dict], provider_nodes, counts) -> None:
        """Terminate provider nodes that have been fully idle (all resources
        free, no pending demand anywhere) past idle_timeout, keeping each
        type's min_workers."""
        now = time.monotonic()
        by_launch_label: Dict[str, dict] = {}
        for n in alive_gcs_nodes:
            lid = (n.get("labels") or {}).get("rt-launch-id")
            if lid:
                by_launch_label[lid] = n

        for pn in provider_nodes:
            gcs_node = by_launch_label.get(pn.node_id) or \
                by_launch_label.get(pn.labels.get("rt-launch-id", ""))
            if gcs_node is None:
                continue  # not yet registered; never kill during startup
            total = gcs_node.get("resources_total", {})
            availd = gcs_node.get("resources_available", {})
            busy = any(availd.get(k, 0.0) < v for k, v in total.items())
            if busy or demands:
                self._idle_since.pop(pn.node_id, None)
                continue
            first = self._idle_since.setdefault(pn.node_id, now)
            ntype = self.scheduler.node_types.get(pn.node_type)
            floor = ntype.min_workers if ntype else 0
            if (now - first >= self.config.idle_timeout_s and
                    counts.get(pn.node_type, 0) > floor):
                logger.info("autoscaler: terminating idle node %s (%s)",
                            pn.node_id, pn.node_type)
                self.provider.terminate_node(pn.node_id)
                counts[pn.node_type] -= 1
                self._idle_since.pop(pn.node_id, None)

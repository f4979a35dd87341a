"""Demand -> nodes-to-launch bin packing.

Port of ``ray_tpu/autoscaler/resource_demand_scheduler.py``.

Design analog: reference
``autoscaler/_private/resource_demand_scheduler.py:103``
(get_nodes_to_launch: pack pending task/actor/PG demands onto existing free
capacity first, then onto hypothetical new nodes of the configured types).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ray_tpu_torch.autoscaler.node_provider import NodeTypeConfig


def fits(demand: Dict[str, float], available: Dict[str, float]) -> bool:
    return all(available.get(k, 0.0) >= v for k, v in demand.items())


def subtract(available: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        available[k] = available.get(k, 0.0) - v


class ResourceDemandScheduler:
    def __init__(self, node_types: List[NodeTypeConfig],
                 max_workers: int = 20):
        self.node_types = {t.name: t for t in node_types}
        self.max_workers = max_workers

    def get_nodes_to_launch(
        self,
        existing_free: List[Dict[str, float]],
        demands: List[Dict[str, float]],
        current_counts: Dict[str, int],
    ) -> Dict[str, int]:
        """First-fit demands onto existing free capacity, then bin-pack the
        unmet remainder onto new nodes, respecting per-type and global
        max_workers. Returns {node_type_name: count_to_launch}.

        `existing_free` is mutated-by-copy; `current_counts` is the number of
        non-terminated provider nodes per type.
        """
        free = [dict(f) for f in existing_free]
        unmet: List[Dict[str, float]] = []
        # Biggest demands first: classic FFD gives tighter packing and makes
        # gang shapes (PG bundles, whole-machine actors) claim whole nodes
        # before small tasks fragment them.
        for d in sorted(demands, key=lambda d: -sum(d.values())):
            for f in free:
                if fits(d, f):
                    subtract(f, d)
                    break
            else:
                unmet.append(d)

        to_launch: Dict[str, int] = {}
        counts = dict(current_counts)
        total = sum(counts.values())
        new_free: List[Tuple[str, Dict[str, float]]] = []
        for d in unmet:
            placed = False
            for ntype, f in new_free:
                if fits(d, f):
                    subtract(f, d)
                    placed = True
                    break
            if placed:
                continue
            # Launch the cheapest (smallest) node type that can hold the
            # demand at all.
            for t in sorted(self.node_types.values(),
                            key=lambda t: sum(t.resources.values())):
                if not fits(d, dict(t.resources)):
                    continue
                if counts.get(t.name, 0) >= t.max_workers:
                    continue
                if total >= self.max_workers:
                    continue
                f = dict(t.resources)
                subtract(f, d)
                new_free.append((t.name, f))
                to_launch[t.name] = to_launch.get(t.name, 0) + 1
                counts[t.name] = counts.get(t.name, 0) + 1
                total += 1
                placed = True
                break
            # Infeasible demands (fit no node type) are dropped here; the
            # reference logs them as infeasible and so do we at the caller.
        return to_launch

    def min_workers_to_launch(
            self, current_counts: Dict[str, int]) -> Dict[str, int]:
        """Nodes needed to satisfy each type's min_workers floor."""
        out = {}
        for t in self.node_types.values():
            short = t.min_workers - current_counts.get(t.name, 0)
            if short > 0:
                out[t.name] = short
        return out

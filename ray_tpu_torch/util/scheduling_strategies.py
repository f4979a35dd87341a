"""Scheduling strategies for tasks/actors.

Design analog: reference ``python/ray/util/scheduling_strategies.py``
(PlacementGroupSchedulingStrategy:15, NodeAffinitySchedulingStrategy:41).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.util.placement_group import PlacementGroup


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: PlacementGroup
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


# String strategies "DEFAULT" / "SPREAD" are passed through as-is.
DEFAULT = "DEFAULT"
SPREAD = "SPREAD"

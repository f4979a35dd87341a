"""Placement groups: gang-reserved resource bundles.

Design analog: reference ``python/ray/util/placement_group.py``
(PlacementGroup:33, placement_group():128) with PACK/SPREAD/STRICT_PACK/
STRICT_SPREAD strategies; GCS-side scheduling in gcs.py (_schedule_pg).

On GPU nodes, bundles shaped {"GPU": 1} gang-reserve cards; the raylet
gives each task or actor placed in such a bundle a card id of its own.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import get_core
from ray_tpu_torch.exceptions import GetTimeoutError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None):
        self.id = pg_id
        self._bundles = bundles

    def ready(self, timeout: Optional[float] = None) -> bool:
        core = get_core()
        try:
            info = core.gcs_request({"type": "pg_wait_ready",
                                     "pg_id": self.id.hex(),
                                     "timeout": timeout}, timeout=timeout)
        except Exception:
            return False
        return info is not None and info["state"] == "CREATED"

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            info = get_core().gcs_request({"type": "get_placement_group",
                                           "pg_id": self.id.hex()})
            self._bundles = info["bundles"] if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def allocations(self) -> Dict[int, str]:
        info = get_core().gcs_request({"type": "get_placement_group",
                                       "pg_id": self.id.hex()})
        return {int(k): v for k, v in (info or {}).get("allocations", {}).items()}

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    core = get_core()
    pg_id = PlacementGroupID.from_random()
    core.gcs_request({"type": "create_placement_group",
                      "pg_id": pg_id.hex(),
                      "bundles": [dict(b) for b in bundles],
                      "strategy": strategy})
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup):
    get_core().gcs_request({"type": "remove_placement_group",
                            "pg_id": pg.id.hex()})


def get_placement_group_state(pg: PlacementGroup) -> Optional[str]:
    info = get_core().gcs_request({"type": "get_placement_group",
                                   "pg_id": pg.id.hex()})
    return info["state"] if info else None

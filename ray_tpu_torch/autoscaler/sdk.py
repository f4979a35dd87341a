"""Programmatic autoscaler API.

Port of ``ray_tpu/autoscaler/sdk.py``.

Design analog: reference ``python/ray/autoscaler/sdk.py``
(``request_resources(num_cpus=..., bundles=[...])``): inject standing
resource demand into the GCS load view so the autoscaler scales up ahead
of the workload.  Each call REPLACES the previous request; clear with
``request_resources()``.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def request_resources(*, num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None
                      ) -> None:
    """Set the cluster's standing resource request.

    ``num_cpus=N`` is shorthand for N single-CPU bundles; ``bundles``
    are resource dicts (e.g. ``[{"GPU": 8, "accelerator_type:H100": 1}]``).
    Passing neither clears the request.
    """
    out: List[Dict[str, float]] = []
    if num_cpus:
        out.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    if bundles:
        out.extend(dict(b) for b in bundles)
    from ray_tpu_torch._private.worker import get_core
    get_core().gcs_request({"type": "set_resource_request",
                            "bundles": out})

"""Usage reporting: what the cluster is and which libraries it exercised.

Design analog: reference ``python/ray/_private/usage/usage_lib.py`` —
cluster metadata + library-usage tags collected at runtime.  The reference
phones home (opt-out); this environment has zero egress by design, so the
report is LOCAL-ONLY: a JSON document written to the head node's log dir
at shutdown (RT_USAGE_STATS=0 disables even that) and accessible via
``ray_tpu_torch.usage_report()`` / the ``usage`` CLI subcommand.  Deployments
that want aggregation ship the file themselves.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Set

_LIBRARIES: Set[str] = set()


def record_library_usage(name: str) -> None:
    """Tag a library as used (importing serve/tune/... calls this)."""
    _LIBRARIES.add(name)


def usage_report() -> Dict[str, Any]:
    """Snapshot of cluster shape + exercised surfaces (local only)."""
    report: Dict[str, Any] = {
        "timestamp": time.time(),
        "libraries": sorted(_LIBRARIES),
        "schema_version": 1,
    }
    try:
        import ray_tpu_torch
        if ray_tpu_torch.is_initialized():
            nodes = ray_tpu_torch.nodes()
            report["cluster"] = {
                "num_nodes": len(nodes),
                "alive_nodes": sum(1 for n in nodes if n["alive"]),
                "total_resources": ray_tpu_torch.cluster_resources(),
            }
    except Exception:
        pass
    # Report the card only if this process ALREADY initialised CUDA:
    # initialising it here would claim a card at shutdown.
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        report["torch"] = {
            "version": torch.__version__,
            "cuda": torch.version.cuda,
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())],
        }
    return report


def write_report_at_shutdown() -> str:
    """Write the report under the log dir; returns the path ('' if off)."""
    if os.environ.get("RT_USAGE_STATS", "1") == "0":
        return ""
    try:
        import tempfile
        d = os.environ.get("RT_LOG_DIR") or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "usage_report.json")
        with open(path, "w") as f:
            json.dump(usage_report(), f, indent=2)
        return path
    except Exception:
        return ""

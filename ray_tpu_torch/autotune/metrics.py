"""Autotune observability counters.

Port of ``ray_tpu/autotune/metrics.py``: one in-process dict of the three
counters (``stats()``), bumped by the cache (hits and misses) and by the
search (tuning wall time).  The reference feeds a second sink from the
same ``bump()``, ``ray_tpu.util.metrics`` Counters that the GCS folds
across processes into ``/api/metrics``; that sink waits for the port's
runtime (ROADMAP A9) and is left out here.
"""

from __future__ import annotations

import threading
from typing import Dict

COUNTER_NAMES = ("autotune_cache_hits", "autotune_cache_misses",
                 "autotune_tune_ms")

_lock = threading.Lock()
_stats: Dict[str, float] = {k: 0.0 for k in COUNTER_NAMES}


def bump(name: str, value: float = 1.0) -> None:
    with _lock:
        _stats[name] = _stats.get(name, 0.0) + value


def stats() -> Dict[str, float]:
    """Snapshot of this process's autotune counters (ints where whole)."""
    with _lock:
        return {k: (int(v) if float(v).is_integer() else round(v, 3))
                for k, v in _stats.items()}


def reset() -> None:
    """Test hook."""
    with _lock:
        for k in list(_stats):
            _stats[k] = 0.0

"""Autotune observability counters (port of ``ray_tpu/autotune/metrics.py``).

Two sinks from one ``bump()``, fed by the cache (hits and misses) and by
the search (tuning wall time):

* a plain in-process dict (``stats()``) — the raylet folds it into its
  node-stats report, so raylet-side tuning (rare but possible) is visible
  per node, and tests can assert on it without a cluster;
* lazily-created ``ray_tpu_torch.util.metrics`` Counters — worker
  processes (where tuning actually happens: trainers, serve replicas, GPU
  actors) flush these to the GCS, which sums them across processes;
  ``util.state.autotune_totals()`` reads both sinks.

Counters are created on first bump, not at import, so importing the
autotune subsystem never starts the metrics flusher thread in processes
that never tune.
"""

from __future__ import annotations

import threading
from typing import Dict

COUNTER_NAMES = ("autotune_cache_hits", "autotune_cache_misses",
                 "autotune_tune_ms")

_lock = threading.Lock()
_stats: Dict[str, float] = {k: 0.0 for k in COUNTER_NAMES}
_user_counters = None     # name -> util.metrics.Counter, created lazily
_DESCRIPTIONS = {
    "autotune_cache_hits": "kernel-autotune cache lookups that hit",
    "autotune_cache_misses": "kernel-autotune cache lookups that missed",
    "autotune_tune_ms": "wall-clock ms spent tuning kernels (cold-cache cost)",
}


def _counters():
    global _user_counters
    with _lock:
        if _user_counters is None:
            from ray_tpu_torch.util.metrics import Counter
            _user_counters = {k: Counter(k, d)
                              for k, d in _DESCRIPTIONS.items()}
        return _user_counters


def bump(name: str, value: float = 1.0) -> None:
    with _lock:
        _stats[name] = _stats.get(name, 0.0) + value
    c = _counters().get(name)
    if c is not None:
        c.inc(value)


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

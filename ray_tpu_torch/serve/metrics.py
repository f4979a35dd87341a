"""Serve resilience observability counters.

Same dual-sink shape as ``ray_tpu_torch.autotune.metrics`` — one ``bump()``
feeds:

* a plain in-process dict (``stats()``) — the raylet folds it into its
  node-stats report so head-side consumers (``state.serve_totals()``,
  the dashboard) see per-node values, and unit tests can assert on it
  without a cluster;
* lazily-created ``ray_tpu_torch.util.metrics`` Counters — the processes
  where routing actually happens (ingress actors, handle-holding
  workers) flush these to the GCS, which aggregates them across
  processes into ``/api/metrics`` as ``ray_tpu_<name>`` series.

Counters are created on first bump, not at import, so importing the
serve package never starts the metrics flusher thread in processes that
never route requests.

The four counters tell the resilience story end to end:

* ``router_retries``  — attempts re-sent to a different replica after a
  retryable system failure (unary retries + backoff loops);
* ``circuit_open``    — CLOSED→OPEN breaker transitions (replica
  ejections from routing);
* ``streams_resumed`` — SSE streams failed over mid-decode and resumed
  on a healthy replica (the zero-dropped-streams invariant, countable);
* ``drain_handoffs``  — in-flight streams a drain deadline force-handed
  to failover during replica replacement (each one is a drain that did
  not complete gracefully);
* ``ctrl_reresolves`` — ingress re-resolutions of the serve controller
  after failures (each one is a controller restart/outage the ingress
  rode out; a climbing count means the control plane is flapping).
"""

from __future__ import annotations

import threading
from typing import Dict

COUNTER_NAMES = ("router_retries", "circuit_open", "streams_resumed",
                 "drain_handoffs", "ctrl_reresolves")

_lock = threading.Lock()
_stats: Dict[str, float] = {k: 0.0 for k in COUNTER_NAMES}
_user_counters = None     # name -> util.metrics.Counter, created lazily

_DESCRIPTIONS = {
    "router_retries": "serve requests re-sent to another replica after a "
                      "retryable failure",
    "circuit_open": "replica circuit-breaker CLOSED->OPEN transitions "
                    "(routing ejections)",
    "streams_resumed": "SSE streams failed over mid-decode and resumed on "
                       "a healthy replica",
    "drain_handoffs": "in-flight streams force-failed-over when a replica "
                      "drain hit its deadline",
    "ctrl_reresolves": "ingress re-resolutions of the serve controller "
                       "after failures (controller restarts ridden out)",
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
    """Snapshot of this process's serve counters (ints where whole)."""
    with _lock:
        return {k: (int(v) if float(v).is_integer() else round(v, 3))
                for k, v in _stats.items()}


def reset() -> None:
    """Test hook."""
    with _lock:
        for k in list(_stats):
            _stats[k] = 0.0

"""Training resilience observability counters.

Same dual-sink shape as ``ray_tpu_torch.serve.metrics`` — one ``bump()``
feeds:

* a plain in-process dict (``stats()``) — the raylet folds it into its
  node-stats report so head-side consumers (``state.train_totals()``,
  the dashboard) see per-node values, and unit tests can assert on it
  without a cluster;
* lazily-created ``ray_tpu_torch.util.metrics`` Counters — the processes
  where training actually happens (train-worker actors, the driver
  supervisor) flush these to the GCS, which aggregates them across
  processes into ``/api/metrics``.

Counters are created on first bump, not at import, so importing the
train package never starts the metrics flusher thread in processes that
never train.

The five counters tell the elastic-training story end to end:

* ``train_recoveries``     — gang teardown+restarts after an unplanned
  worker death (each one consumed restart budget);
* ``preemptions``          — planned handoffs: a preempt notice was
  delivered, the worker checkpointed and exited clean, and the gang
  restarted without burning budget;
* ``ckpt_write_ms``        — cumulative wall-clock of durable checkpoint
  writes (shards + manifest commit, off the step loop);
* ``ckpt_restore_ms``      — cumulative wall-clock of verified restores;
* ``ckpt_corrupt_skipped`` — checkpoints rejected at restore (missing/
  torn manifest, shard CRC mismatch) and skipped in favor of the
  previous intact one.
"""

from __future__ import annotations

import threading
from typing import Dict

COUNTER_NAMES = ("train_recoveries", "preemptions", "ckpt_write_ms",
                 "ckpt_restore_ms", "ckpt_corrupt_skipped")

_lock = threading.Lock()
_stats: Dict[str, float] = {k: 0.0 for k in COUNTER_NAMES}
_user_counters = None     # name -> util.metrics.Counter, created lazily

_DESCRIPTIONS = {
    "train_recoveries": "train gang teardown+restarts after an unplanned "
                        "worker death",
    "preemptions": "planned preemption handoffs (checkpoint + clean exit, "
                   "no restart budget burned)",
    "ckpt_write_ms": "cumulative durable checkpoint write wall-clock",
    "ckpt_restore_ms": "cumulative verified checkpoint restore wall-clock",
    "ckpt_corrupt_skipped": "checkpoints failing CRC/manifest verification, "
                            "skipped at restore",
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
    """Snapshot of this process's train counters (ints where whole)."""
    with _lock:
        return {k: (int(v) if float(v).is_integer() else round(v, 3))
                for k, v in _stats.items()}


def reset() -> None:
    """Test hook."""
    with _lock:
        for k in list(_stats):
            _stats[k] = 0.0

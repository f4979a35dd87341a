"""Event-loop watchdog: a monotonic lag probe for daemon asyncio loops.

The control plane's availability contract is "the raylet never misses a
heartbeat" (reference: raylet heartbeats feeding the GCS health check;
the reference runs its heartbeat off a dedicated io_service so worker
management can't stall it).  Here everything shares one asyncio loop, so
any callback that blocks — a synchronous spawn, a large pickle, a /proc
scan — delays heartbeats by exactly its run time.  The watchdog makes
that delay *observable* (``loop_lag_ms`` in node stats and /api/metrics),
*attributable* (a sampler thread captures the loop thread's stack while
it is still inside the offending callback), and *forgivable* (the GCS
health check adds the observed lag as a grace term, see
``gcs._health_loop``).

Two probes cooperate:

* an asyncio task that sleeps ``interval_s`` and measures how late it
  wakes — the steady-state lag series;
* a daemon thread that notices when the task's next wakeup is overdue by
  more than ``warn_s`` and logs the loop thread's current stack — the
  only vantage point that can name the blocking callback, because the
  loop itself is wedged while it matters.

Samples are held for ``_WINDOW_S`` so the GCS can ask "how badly did
this loop stall recently?" when deciding whether a missed heartbeat
means a dead node or just a busy one.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Deque, Optional, Tuple

from ray_tpu_torch._private.config import config

logger = logging.getLogger(__name__)

_WINDOW_S = 60.0


class LoopWatchdog:
    """Measures scheduling lag of the asyncio loop it is started on."""

    def __init__(self, component: str,
                 interval_s: Optional[float] = None,
                 warn_s: Optional[float] = None):
        cfg = config()
        self.component = component
        self.interval_s = (cfg.loop_watchdog_interval_s
                           if interval_s is None else interval_s)
        self.warn_s = (cfg.loop_watchdog_warn_s
                       if warn_s is None else warn_s)
        self.last_lag_ms = 0.0
        self._samples: Deque[Tuple[float, float]] = deque()  # (t, lag_s)
        self._beat = time.monotonic()
        self._loop_thread_id: Optional[int] = None
        self._stopped = False
        self._task: Optional[asyncio.Task] = None
        self._sampler: Optional[threading.Thread] = None
        self._warned_beat = 0.0
        # The lag series ALSO lives in a util.metrics gauge so a connected
        # process (a driver running its own watchdog) exports it through
        # the ordinary user-metrics flusher; daemons export via node stats
        # and the dashboard instead (their flusher is a no-op — no
        # connected worker).
        from ray_tpu_torch.util import metrics
        self._gauge = metrics.Gauge(
            "loop_lag_ms", "asyncio event-loop scheduling lag",
            tag_keys=("component",))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> asyncio.Task:
        self._loop_thread_id = threading.get_ident()
        self._beat = time.monotonic()
        self._task = asyncio.get_running_loop().create_task(
            self._probe_loop())
        self._sampler = threading.Thread(
            target=self._stall_sampler, daemon=True,
            name=f"rt-loop-watchdog-{self.component}")
        self._sampler.start()
        return self._task

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()

    # ------------------------------------------------------------ probes

    async def _probe_loop(self):
        while not self._stopped:
            self._beat = time.monotonic()
            await asyncio.sleep(self.interval_s)
            now = time.monotonic()
            lag = max(0.0, now - self._beat - self.interval_s)
            self.last_lag_ms = lag * 1000.0
            self._gauge.set(self.last_lag_ms,
                            tags={"component": self.component})
            self._samples.append((now, lag))
            cutoff = now - _WINDOW_S
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()

    def _stall_sampler(self):
        # Poll cadence below warn_s so an in-progress stall is caught
        # while the offending callback is still on the loop thread.
        poll = max(0.05, min(self.interval_s, self.warn_s / 2.0))
        while not self._stopped:
            time.sleep(poll)
            beat = self._beat
            stall = time.monotonic() - beat - self.interval_s
            if stall > self.warn_s and beat != self._warned_beat:
                self._warned_beat = beat
                logger.warning(
                    "%s event loop stalled %.2fs (> %.2fs); offending "
                    "callback: %s", self.component, stall, self.warn_s,
                    self._loop_stack_hint())

    def _loop_stack_hint(self) -> str:
        frame = sys._current_frames().get(self._loop_thread_id)
        if frame is None:
            return "<loop thread gone>"
        stack = traceback.extract_stack(frame)
        # Innermost frames name the blocker; asyncio machinery is noise.
        inner = [f for f in stack
                 if os.sep + "asyncio" + os.sep not in f.filename][-3:]
        if not inner:
            inner = stack[-3:]
        return " <- ".join(
            f"{f.name} ({os.path.basename(f.filename)}:{f.lineno})"
            for f in reversed(inner))

    # ------------------------------------------------------------ readings

    def current_stall_s(self) -> float:
        """Overdueness of the next probe wakeup RIGHT NOW — nonzero only
        while the loop is wedged (the probe can't run to record it)."""
        return max(0.0, time.monotonic() - self._beat - self.interval_s)

    def max_recent_s(self, window_s: float = _WINDOW_S) -> float:
        """Worst observed lag in the last ``window_s`` seconds, including
        any stall in progress (crucial: during an ongoing stall the
        sample that would report it hasn't been taken yet)."""
        cutoff = time.monotonic() - window_s
        worst = max((lag for t, lag in self._samples if t >= cutoff),
                    default=0.0)
        return max(worst, self.current_stall_s())

    def record(self) -> dict:
        """Node-stats fragment (see raylet._collect_node_stats)."""
        return {
            "loop_lag_ms": round(self.last_lag_ms, 3),
            "loop_lag_max_ms": round(self.max_recent_s() * 1000.0, 3),
        }

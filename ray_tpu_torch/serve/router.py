"""Client-side router: queue-aware replica choice, push-updated.

Reference analog: Router/ReplicaSet (_private/router.py:261,62) — requests
are assigned client-side to the replica with the fewest locally-tracked
outstanding requests among two random candidates (power-of-two-choices).
The replica set is kept fresh by a long-poll listener thread against the
controller (reference serve/_private/long_poll.py LongPollClient): scale
events become visible push-style, typically within one RPC round-trip.
The TTL refresh remains only as a safety net (listener thread died, or
the controller was replaced).

**Hardening** (serve/resilience.py): replica choice runs through a
per-replica circuit breaker — callers report outcomes via
``report_failure``/``report_success`` (or use ``remote_retrying``, which
does it automatically plus bounded backoff retry), and ejected replicas
drop out of the power-of-two candidate set until their half-open probe
passes.  ``_deadline_s`` on ``remote``/``remote_stream`` propagates an
end-to-end deadline to the replica (and through it, the engine).
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import resilience

# Fallback only — the long-poll listener delivers changes immediately.
REFRESH_PERIOD_S = 30.0
# In-flight counters are a within-window heuristic; they must keep the old
# 1s reset cadence now that refreshes are rare.
COUNTER_RESET_PERIOD_S = 1.0
_LISTEN_TIMEOUT_S = 30.0


class DeploymentHandle:
    """Callable handle to a deployment: ``handle.remote(*args)``."""

    def __init__(self, name: str, controller):
        self._name = name
        self._controller = controller
        self._replicas: List = []
        self._outstanding: Dict[str, int] = {}
        self._last_refresh = 0.0
        self._lock = threading.Lock()
        self._version = 0
        self._listener: threading.Thread = None
        self._counters_reset_at = 0.0
        self._cb = resilience.CircuitBreaker(on_open=self._on_cb_open)

    @staticmethod
    def _on_cb_open(replica_id: str):
        from ray_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.bump("circuit_open")

    def report_failure(self, replica_id: str):
        """Feed the circuit breaker: call with the replica's actor id
        when a request sent through this handle failed with a system
        error (replica death, lost connection)."""
        with self._lock:
            self._cb.record_failure(replica_id)

    def report_success(self, replica_id: str):
        with self._lock:
            self._cb.record_success(replica_id)

    def __reduce__(self):
        # Handles travel into replicas for deployment graphs (a deployment
        # bound with another deployment calls it through its handle); the
        # lock and cached replica view rebuild fresh in the destination.
        return (DeploymentHandle, (self._name, self._controller))

    def _refresh(self, force: bool = False):
        self._ensure_listener()
        now = time.monotonic()
        if not force and now - self._last_refresh < REFRESH_PERIOD_S:
            return
        reps = ray_tpu_torch.get(
            self._controller.get_replicas.remote(self._name))
        with self._lock:
            self._replicas = reps
            self._last_refresh = now
            # Counters reset each refresh window: they only need to skew
            # the power-of-two choice within the window, and resetting
            # makes lost decrements self-healing.
            self._outstanding = {}

    def _ensure_listener(self):
        # Unlocked pre-check keeps the steady-state remote() path to one
        # lock acquisition; the locked re-check below handles the benign
        # startup race.
        t = self._listener
        if t is not None and t.is_alive():
            return
        with self._lock:
            t = self._listener
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=_listen_loop,
                                 args=(weakref.ref(self),),
                                 name=f"serve-longpoll-{self._name}",
                                 daemon=True)
            self._listener = t
            # start() inside the lock: a not-yet-started thread reports
            # is_alive()==False, which would let a concurrent caller spawn
            # a duplicate listener.
            t.start()

    def _pick(self, exclude: Optional[set] = None):
        with self._lock:
            reps = list(self._replicas)
            if reps:
                # Breaker-filtered candidate set: ejected replicas sit out
                # until their half-open probe; if EVERYTHING is ejected,
                # fall back to the raw set (a request that might succeed
                # beats a guaranteed routing error).
                avail = self._cb.filter(reps, exclude=exclude)
                reps = avail or reps
        if not reps:
            raise RuntimeError(
                f"deployment {self._name} has no running replicas")
        if len(reps) == 1:
            return reps[0]
        a, b = random.sample(reps, 2)
        na = self._outstanding.get(a._actor_id, 0)
        nb = self._outstanding.get(b._actor_id, 0)
        return a if na <= nb else b

    @staticmethod
    def _deadline(deadline_s: Optional[float]) -> Optional[float]:
        return None if deadline_s is None else time.time() + deadline_s

    def _count(self, aid: str):
        now = time.monotonic()
        with self._lock:
            # In-flight estimate; reset wholesale on a short cadence rather
            # than tracking completions (which would cost a deserialization
            # per reply just to decrement a heuristic counter).  Decoupled
            # from the refresh TTL: with push updates, refreshes are rare.
            if now - self._counters_reset_at > COUNTER_RESET_PERIOD_S:
                self._outstanding = {}
                self._counters_reset_at = now
            self._outstanding[aid] = self._outstanding.get(aid, 0) + 1

    def remote(self, *args, _method: str = None,
               _deadline_s: Optional[float] = None, **kwargs):
        """Route one request; returns an ObjectRef of the result.
        ``_deadline_s`` (relative seconds) rides to the replica as an
        absolute end-to-end deadline — expiry raises DeadlineExceeded
        from the ref instead of computing a result nobody will read."""
        self._refresh()
        replica = self._pick()
        self._count(replica._actor_id)
        return replica.handle_request.remote(
            list(args), kwargs, _method, self._deadline(_deadline_s))

    async def remote_retrying(self, *args, _method: str = None,
                              _deadline_s: Optional[float] = None,
                              **kwargs):
        """Awaitable hardened call: routes like ``remote`` but awaits the
        result, feeds the circuit breaker with the outcome, and retries
        retryable system failures (replica death, lost connections) on a
        different replica with exponential backoff + jitter, bounded by
        the RT_SERVE_RETRY_BUDGET and the deadline.  Returns the result
        directly (not an ObjectRef)."""
        import asyncio
        deadline = self._deadline(_deadline_s)
        policy = resilience.RetryPolicy()
        exclude: set = set()
        while True:
            rem = resilience.deadline_remaining(deadline)
            if rem is not None and rem <= 0:
                raise resilience.DeadlineExceeded(
                    "request deadline expired before completion")
            self._refresh()
            replica = self._pick(exclude)
            aid = replica._actor_id
            self._count(aid)
            try:
                result = await replica.handle_request.remote(
                    list(args), kwargs, _method, deadline)
            except Exception as e:   # noqa: BLE001
                if not resilience.is_retryable_error(e):
                    raise
                self.report_failure(aid)
                exclude.add(aid)
                if not policy.can_retry():
                    raise
                from ray_tpu_torch.serve import metrics as serve_metrics
                serve_metrics.bump("router_retries")
                self._refresh(force=True)
                await asyncio.sleep(policy.next_backoff_s(deadline))
                continue
            self.report_success(aid)
            return result

    def remote_stream(self, *args, _method: str = None,
                      _deadline_s: Optional[float] = None, **kwargs):
        """Route one STREAMING request: returns a
        ``StreamingObjectRefGenerator`` whose items are the handler's
        yields, consumable while the replica is still generating
        (``async for`` it, or ``next()`` off-loop).  Dropping the
        generator early cancels the replica-side stream."""
        self._refresh()
        replica = self._pick()
        self._count(replica._actor_id)
        return replica.handle_stream.options(
            num_returns="streaming").remote(
                list(args), kwargs, _method, self._deadline(_deadline_s))

    def method(self, name: str):
        """handle.method("encode").remote(...) calls a named method."""
        h = self
        class _M:  # noqa: N801 - tiny adapter
            def remote(self, *a, **k):
                return h.remote(*a, _method=name, **k)
            def remote_stream(self, *a, **k):
                return h.remote_stream(*a, _method=name, **k)
        return _M()



def _listen_loop(handle_ref):
    """Long-poll listener: parks on controller.listen_for_change and applies
    replica-set updates the moment they land.  Holds only a weakref to the
    handle so a dropped handle lets both the handle and this thread die.
    Backs off exponentially on failure and exits after ~10 consecutive
    errors (controller gone, e.g. serve.shutdown with live handles) — a
    later remote() restarts it via _ensure_listener."""
    failures = 0
    while True:
        h = handle_ref()
        if h is None:
            return
        if h._listener is not threading.current_thread():
            return  # superseded by a newer listener
        name, controller, ver = h._name, h._controller, h._version
        del h
        try:
            res = ray_tpu_torch.get(
                controller.listen_for_change.remote(
                    name, ver, _LISTEN_TIMEOUT_S),
                timeout=_LISTEN_TIMEOUT_S + 30)
            failures = 0
        except Exception:
            failures += 1
            if failures >= 10:
                return
            time.sleep(min(1.0 * 2 ** (failures - 1), 30.0))
            continue
        h = handle_ref()
        if h is None:
            return
        if res["version"] != ver:
            with h._lock:
                h._replicas = res["replicas"]
                h._version = res["version"]
                h._outstanding = {}
                h._last_refresh = time.monotonic()
        del h

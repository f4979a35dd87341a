"""Serve-layer resilience primitives: circuit breaking, bounded retry,
and end-to-end request deadlines.

Reference analogs: the Ray paper's fault-tolerance story applied to the
serving path (PAPERS.md "Ray: A Distributed Framework for Emerging AI
Applications"), Ray Serve's replica health gating, and classic
router-side hardening (Finagle/Envoy-style consecutive-failure circuit
breakers with half-open probes, capped exponential backoff with jitter).

Three independent pieces, shared by the HTTP ingress and the
``DeploymentHandle`` router:

* **CircuitBreaker** — per-replica failure accounting.  ``threshold``
  consecutive failures eject a replica (state OPEN: the router stops
  selecting it); after ``cooldown_s`` the breaker admits exactly one
  probe request (HALF_OPEN) — a success re-closes the circuit, a failure
  re-opens it for another cooldown.  Ejection is routing-local and
  optimistic by design: the controller's health probe is the authority
  that actually replaces dead replicas; the breaker only keeps live
  traffic away from them in the seconds between death and replacement.

* **RetryPolicy** — bounded retry with exponential backoff + full
  jitter and a per-request attempt budget.  The budget covers the WHOLE
  request (initial attempt + unary retries + mid-stream failovers), so
  a flapping fleet degrades to an error instead of an infinite retry
  storm.  Backoff sleeps never exceed the request's remaining deadline.

* **Deadlines** — an absolute ``time.time()`` deadline propagated
  ingress → handle → replica → engine.  The replica publishes it
  through a contextvar (``current_deadline()``) so handler bodies (the
  inference engine, most importantly) can cancel decode and free KV
  pages instead of computing tokens nobody will read.  An expired
  deadline surfaces as ``DeadlineExceeded`` (504 at the ingress).

Everything here is import-light and event-loop-free: pure state
machines the async callers drive.
"""

from __future__ import annotations

import contextvars
import os
import random
import time
from typing import Dict, List, Optional, Sequence

__all__ = [
    "DeadlineExceeded", "DecodeStalled", "CircuitBreaker", "RetryPolicy",
    "current_deadline", "deadline_remaining", "set_deadline",
    "is_deadline_error", "is_retryable_error",
]


class DeadlineExceeded(Exception):
    """A request's end-to-end deadline expired before completion.

    Raised replica-side (and engine-side) so decode stops and KV pages
    free; mapped to HTTP 504 at the ingress.  Deliberately a plain
    Exception: it crosses the wire pickled inside TaskError like any
    handler exception."""


class DecodeStalled(Exception):
    """A live stream produced no item within the stall window
    (RT_SERVE_STALL_S).  Ingress-local: raised to route the stream into
    the failover path — the replica may be wedged even though its actor
    is nominally alive."""


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# --------------------------------------------------------------- deadlines

_REQUEST_DEADLINE: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("rt_serve_request_deadline", default=None)


def set_deadline(deadline: Optional[float]):
    """Publish the absolute request deadline (epoch seconds) to handler
    code below this frame; returns the reset token."""
    return _REQUEST_DEADLINE.set(deadline)


def reset_deadline(token) -> None:
    _REQUEST_DEADLINE.reset(token)


def current_deadline() -> Optional[float]:
    """The active request's absolute deadline, or None when unbounded."""
    return _REQUEST_DEADLINE.get()


def deadline_remaining(deadline: Optional[float] = None) -> Optional[float]:
    """Seconds until ``deadline`` (defaults to the contextvar); None when
    unbounded.  May be <= 0 — callers treat that as expired."""
    if deadline is None:
        deadline = current_deadline()
    if deadline is None:
        return None
    return deadline - time.time()


def is_deadline_error(exc: BaseException) -> bool:
    """True when ``exc`` is a DeadlineExceeded, directly or as the cause
    inside a TaskError that crossed the wire."""
    if isinstance(exc, DeadlineExceeded):
        return True
    cause = getattr(exc, "cause", None)
    return cause is not None and (
        isinstance(cause, DeadlineExceeded)
        or type(cause).__name__ == "DeadlineExceeded")


def is_retryable_error(exc: BaseException) -> bool:
    """True for SYSTEM failures a different replica can absorb (replica
    death, lost connections, crashed workers).  Handler exceptions
    (TaskError around user code) are NOT retryable — they would recur
    deterministically on every replica — and neither are deadline
    expirations (retrying cannot un-expire a deadline).

    The ``cause`` of a TaskError is inspected too: a call that races the
    GCS's death record dials the dead worker's old address and comes back
    as ``TaskError(ConnectionRefusedError)`` rather than ActorDiedError —
    same failure, different wrapper."""
    from ray_tpu_torch import exceptions as rex

    def _system(e: BaseException) -> bool:
        if isinstance(e, DecodeStalled):
            return True
        if isinstance(e, (rex.ActorDiedError, rex.ActorUnavailableError,
                          rex.WorkerCrashedError)):
            return True
        if isinstance(e, (ConnectionError, EOFError)):
            return True
        # protocol.ConnectionLost (by name: this module stays import-light).
        return type(e).__name__ == "ConnectionLost"

    if is_deadline_error(exc):
        return False
    if _system(exc):
        return True
    cause = getattr(exc, "cause", None)
    return cause is not None and _system(cause)


# --------------------------------------------------------- circuit breaker

CB_CLOSED = "closed"
CB_OPEN = "open"
CB_HALF_OPEN = "half_open"


class _Breaker:
    __slots__ = ("state", "failures", "opened_at", "probe_in_flight",
                 "probe_at")

    def __init__(self):
        self.state = CB_CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probe_in_flight = False
        self.probe_at = 0.0


class CircuitBreaker:
    """Per-replica consecutive-failure circuit breaker with half-open
    probe re-admission.  Keys are replica actor ids; unknown keys are
    implicitly CLOSED.  Not thread-safe by itself — the ingress drives it
    from one event loop; ``DeploymentHandle`` wraps calls in its own
    lock."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 on_open=None):
        self.threshold = int(threshold if threshold is not None
                             else _env_f("RT_SERVE_CB_THRESHOLD", 3))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else _env_f("RT_SERVE_CB_COOLDOWN_S", 5.0))
        self._breakers: Dict[str, _Breaker] = {}
        self._on_open = on_open          # callback(replica_id) on ejection

    # -- state transitions ------------------------------------------------

    def record_success(self, replica_id: str) -> None:
        b = self._breakers.get(replica_id)
        if b is None:
            return
        # Any success fully heals: half-open probe passed, or a straggler
        # success raced the ejection.
        self._breakers.pop(replica_id, None)

    def record_failure(self, replica_id: str) -> None:
        b = self._breakers.setdefault(replica_id, _Breaker())
        b.failures += 1
        if b.state == CB_HALF_OPEN:
            # The probe failed: re-open for another full cooldown.
            b.state = CB_OPEN
            b.opened_at = time.monotonic()
            b.probe_in_flight = False
            return
        if b.state == CB_CLOSED and b.failures >= self.threshold:
            b.state = CB_OPEN
            b.opened_at = time.monotonic()
            if self._on_open is not None:
                try:
                    self._on_open(replica_id)
                except Exception:
                    pass

    # -- selection --------------------------------------------------------

    def try_admit(self, replica_id: str) -> bool:
        """True when the replica may receive a request right now.  An OPEN
        breaker past its cooldown transitions to HALF_OPEN and admits ONE
        probe; further requests are refused until the probe resolves.  A
        probe slot reserved but never resolved (the caller admitted a
        replica it didn't end up sending to, or the send's outcome was
        lost) expires after another cooldown so the breaker can't wedge
        shut."""
        b = self._breakers.get(replica_id)
        if b is None or b.state == CB_CLOSED:
            return True
        if b.state == CB_OPEN:
            if time.monotonic() - b.opened_at < self.cooldown_s:
                return False
            b.state = CB_HALF_OPEN
            b.probe_in_flight = False
        if b.state == CB_HALF_OPEN:
            if b.probe_in_flight and \
                    time.monotonic() - b.probe_at < self.cooldown_s:
                return False
            b.probe_in_flight = True
            b.probe_at = time.monotonic()
            return True
        return True

    def state(self, replica_id: str) -> str:
        b = self._breakers.get(replica_id)
        if b is None:
            return CB_CLOSED
        if b.state == CB_OPEN and \
                time.monotonic() - b.opened_at >= self.cooldown_s:
            return CB_HALF_OPEN
        return b.state

    def filter(self, replicas: Sequence, *,
               exclude: Optional[set] = None) -> List:
        """Replicas currently routable, minus ``exclude`` (actor ids).
        CLOSED replicas are preferred: half-open probe slots are only
        spent when NO closed replica remains, so a healthy fleet never
        burns probes on cooled-down breakers while good targets exist."""
        pool = [r for r in replicas
                if not (exclude and r._actor_id in exclude)]
        closed = [r for r in pool
                  if self.state(r._actor_id) == CB_CLOSED]
        if closed:
            return closed
        return [r for r in pool if self.try_admit(r._actor_id)]

    def select(self, replicas: Sequence, index: int = 0, *,
               exclude: Optional[set] = None):
        """One routable replica (round-robin by ``index`` over the
        filtered set), or None when every candidate is ejected and still
        cooling."""
        avail = self.filter(replicas, exclude=exclude)
        if not avail:
            return None
        return avail[index % len(avail)]

    def forget_missing(self, live_ids) -> None:
        """Drop breaker state for replicas no longer in the set (replaced
        by the controller) so the map stays bounded under churn."""
        live = set(live_ids)
        for rid in list(self._breakers):
            if rid not in live:
                del self._breakers[rid]

    def snapshot(self) -> Dict[str, str]:
        return {rid: self.state(rid) for rid in list(self._breakers)}


# ------------------------------------------------------------------ retry

class RetryPolicy:
    """Bounded retry budget with capped exponential backoff + full
    jitter.  One instance per REQUEST (the budget is per-request state);
    construction is cheap."""

    def __init__(self, budget: Optional[int] = None,
                 base_s: Optional[float] = None,
                 cap_s: Optional[float] = None):
        self.budget = int(budget if budget is not None
                          else _env_f("RT_SERVE_RETRY_BUDGET", 3))
        self.base_s = (base_s if base_s is not None
                       else _env_f("RT_SERVE_RETRY_BASE_S", 0.05))
        self.cap_s = (cap_s if cap_s is not None
                      else _env_f("RT_SERVE_RETRY_CAP_S", 2.0))
        self.attempts = 0

    def can_retry(self) -> bool:
        return self.attempts < self.budget

    def next_backoff_s(self, deadline: Optional[float] = None) -> float:
        """Consume one budget unit; returns the sleep before the retry
        (full jitter over an exponentially growing window, clamped to the
        request's remaining deadline)."""
        self.attempts += 1
        window = min(self.cap_s, self.base_s * (2 ** (self.attempts - 1)))
        sleep = random.uniform(0.0, window)
        rem = deadline_remaining(deadline)
        if rem is not None:
            sleep = max(0.0, min(sleep, rem))
        return sleep

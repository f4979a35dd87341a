"""Distributed span tracing with cross-task context propagation.

Design analog: reference ``python/ray/util/tracing/tracing_helper.py:53``
(_inject_tracing_into_function / propagated OpenTelemetry contexts).  No
OTel SDK ships in the image, so the span model is self-contained but
OTLP-shaped (trace_id / span_id / parent_id / name / start / end /
attributes) — an exporter adapter is one function away.

How it flows:
  * ``enable()`` (or env RT_TRACING=1) turns on capture in this process.
  * ``with span("step"):`` opens a span; the current span rides a
    contextvar.
  * Task/actor submissions stamp the current (trace_id, span_id) into the
    task spec; executors open a child span around the function body — so
    a driver span, the remote task's span, and any nested task's span
    form one tree across processes.
  * Finished spans ride the existing task-event pipeline to the GCS
    (kind="span"); ``get_spans()`` pages them back through the state API.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
import uuid
from typing import Any, Dict, List, Optional

_current: "contextvars.ContextVar" = contextvars.ContextVar(
    "rt_trace_ctx", default=None)   # (trace_id, span_id) | None
_enabled: Optional[bool] = None


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    # The env answer is cached: this gate sits on the task/actor submit
    # hot path, and a per-call os.environ lookup measured ~9us there.
    # enable()/disable() still override at any time.
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RT_TRACING", "") == "1"
    return _enabled


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) to propagate, or None."""
    return _current.get()


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None,
         _remote_parent: Optional[tuple] = None):
    """Open a span; records on exit when tracing is enabled."""
    if not enabled():
        yield None
        return
    parent = _remote_parent or _current.get()
    trace_id = parent[0] if parent else uuid.uuid4().hex
    span_id = uuid.uuid4().hex[:16]
    token = _current.set((trace_id, span_id))
    t0 = time.time()
    err: Optional[str] = None
    try:
        yield (trace_id, span_id)
    except BaseException as e:
        err = repr(e)
        raise
    finally:
        _current.reset(token)
        _record({
            "kind": "span",
            "task_id": span_id,            # state-API identity column
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent[1] if parent else None,
            "start": t0,
            "end": time.time(),
            "status": "FAILED" if err else "FINISHED",
            "attributes": {**(attributes or {}),
                           **({"error": err} if err else {})},
        })


def _record(event: Dict[str, Any]) -> None:
    try:
        from ray_tpu_torch._private.worker import get_core
        get_core().record_task_event(event)
    except Exception:
        pass  # not connected: tracing is best-effort


def get_spans(limit: int = 5000,
              trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Finished spans from the GCS (newest first); optionally one trace.
    The trace filter is pushed down server-side — the page limit applies
    AFTER filtering, so a busy retention window can't truncate a trace."""
    from ray_tpu_torch.util.state import list_tasks
    return list_tasks(limit=limit, kind="span", trace_id=trace_id)

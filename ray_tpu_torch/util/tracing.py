"""Spans: named intervals of the program's work, kept in two ways.

Design analog: reference ``python/ray/util/tracing/tracing_helper.py:53``
(_inject_tracing_into_function / propagated OpenTelemetry contexts).  No
OTel SDK ships in the image, so the span model is self-contained but
OTLP-shaped (trace_id / span_id / parent_id / name / start / end /
attributes) — an exporter adapter is one function away.

``with span("step", {"k": v}):`` marks the work inside.  It is kept by
either of two paths, or both:

* **The in-process recorder** (``start_recording()`` ...
  ``stop_recording()``): each span that ends while it is on is appended to
  a bounded buffer of this process (``_CAPACITY`` spans; later ones are
  counted and dropped), as its name, the thread it ran on, its
  ``start_ns`` and ``end_ns``, the name of the recorded span open around
  it on the same context (its parent) and its attributes.
  ``stop_recording`` turns it off and hands the finished spans over as
  dicts; nothing is written out while it records.  A benchmark or an
  operator turns it on around a window, beside ``torch.profiler`` or
  without it.
* **Distributed spans** (``enable()`` or env ``RT_TRACING=1``): the
  current span rides a contextvar; task and actor submissions stamp its
  (trace_id, span_id) into the task spec, and executors open a child span
  around the function body, so a driver span, the remote task's span and
  any nested task's span form one tree across processes.  Finished spans
  ride the task-event pipeline of the connected runtime to the GCS
  (kind="span"), best-effort: a failed send is dropped;
  ``get_spans()`` pages them back through the state API.  With no runtime
  connected, a span keeps its ids and context and sends nothing.

``local_span()`` is a span for the recorder alone: it never takes ids and
never reaches the GCS.  The program's hot paths use it (the engine's
``engine.*``, the train step's ``train.*``, the MoE's ``moe.ffn``), tens
a second, which would otherwise crowd the GCS's bounded store of task
events while ``RT_TRACING`` is on.

The clock is ``time.time_ns()`` (CLOCK_REALTIME), the clock on which
``torch.profiler`` stamps its host events, so a recorded span brackets the
profiler's records of the work inside it and lines up with the device's
kernels in the same trace.  The distributed path's ``start``/``end``
seconds come from the same reads.

Cost: off, ``span()`` checks one cached flag and ``local_span()`` one
global, and each returns a shared no-op (no clock read, no id, no lookup
of the runtime).  With the recorder on, a span adds two clock reads, a
contextvar set and reset and one tuple appended.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time
import uuid
import warnings
from typing import Any, Dict, List, Optional

_current: "contextvars.ContextVar" = contextvars.ContextVar(
    "rt_trace_ctx", default=None)   # (trace_id, span_id) | None
# The name of the innermost recorded span open on this context.
_recorded_parent: "contextvars.ContextVar" = contextvars.ContextVar(
    "rt_span_parent", default=None)
_enabled: Optional[bool] = None     # the distributed path
_recording: Optional["_Recording"] = None
_on: Optional[bool] = None          # either path; None until first read
_CAPACITY = 1 << 17                 # the recorder's spans, at most


class _Recording:
    """The recorder's buffer: finished spans as tuples, up to
    ``_CAPACITY``; later ones are counted, not kept."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, item: tuple) -> None:
        if len(self.spans) < _CAPACITY:
            self.spans.append(item)
        else:
            with self.lock:
                self.dropped += 1


def _refresh() -> bool:
    global _on
    _on = enabled() or _recording is not None
    return _on


def enable() -> None:
    global _enabled
    _enabled = True
    _refresh()


def disable() -> None:
    global _enabled
    _enabled = False
    _refresh()


def enabled() -> bool:
    """Whether the distributed path is on."""
    # The env answer is cached: this gate sits on the task/actor submit
    # hot path, and a per-call os.environ lookup measured ~9us there.
    # enable()/disable() still override at any time.
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RT_TRACING", "") == "1"
    return _enabled


def start_recording() -> None:
    """Turn the in-process recorder on with an empty buffer (a recording
    already on is discarded)."""
    global _recording
    _recording = _Recording()
    _refresh()


def stop_recording() -> List[Dict[str, Any]]:
    """Turn the recorder off and return the spans that ended while it was
    on, in the order they ended: dicts of ``name``, ``thread`` (its name),
    ``tid`` (its native id), ``start_ns``, ``end_ns``, ``parent`` (a name,
    or None) and ``attributes`` (with ``error`` when the span ended by an
    exception).  Spans still open are not included.  Warns when spans were
    dropped past the capacity.  Empty when the recorder was off."""
    global _recording
    rec, _recording = _recording, None
    _refresh()
    if rec is None:
        return []
    if rec.dropped:
        warnings.warn(f"the span recorder dropped {rec.dropped} spans past "
                      f"its capacity of {_CAPACITY}", RuntimeWarning,
                      stacklevel=2)
    keys = ("name", "thread", "tid", "start_ns", "end_ns", "parent",
            "attributes")
    return [dict(zip(keys, s)) for s in rec.spans]


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) to propagate, or None."""
    return _current.get()


def _runtime():
    """The connected runtime's core worker, or None; imports nothing."""
    worker = sys.modules.get("ray_tpu_torch._private.worker")
    return worker.global_worker.core_worker if worker is not None else None


_OFF = contextlib.nullcontext()     # what span() returns while both are off


def span(name: str, attributes: Optional[Dict[str, Any]] = None,
         _remote_parent: Optional[tuple] = None):
    """``with span(name, attributes):`` — see the module docstring.  The
    ``with`` yields (trace_id, span_id) on the distributed path, else
    None.  ``_remote_parent`` is the (trace_id, span_id) of a span in
    another process (a task's submitter)."""
    if not (_on if _on is not None else _refresh()):
        return _OFF
    return _Span(name, attributes, _remote_parent, False)


def local_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """``with local_span(name, attributes):`` — a span kept by the
    in-process recorder alone (the ``with`` yields None): never sent to the
    GCS, whatever ``RT_TRACING`` says.  For the program's hot paths."""
    if _recording is None:
        return _OFF
    return _Span(name, attributes, None, True)


class _Span:
    __slots__ = ("name", "attributes", "_remote_parent", "_local", "_t0",
                 "_ids", "_parent_id", "_ctx_token", "_rec", "_parent_name",
                 "_name_token")

    def __init__(self, name: str, attributes: Optional[Dict[str, Any]],
                 _remote_parent: Optional[tuple], local: bool):
        self.name = name
        self.attributes = attributes
        self._remote_parent = _remote_parent
        self._local = local

    def __enter__(self) -> Optional[tuple]:
        self._ids = None
        if _enabled and not self._local:
            parent = self._remote_parent or _current.get()
            trace_id = parent[0] if parent else uuid.uuid4().hex
            self._ids = (trace_id, uuid.uuid4().hex[:16])
            self._parent_id = parent[1] if parent else None
            self._ctx_token = _current.set(self._ids)
        self._rec = _recording
        if self._rec is not None:
            self._parent_name = _recorded_parent.get()
            self._name_token = _recorded_parent.set(self.name)
        self._t0 = time.time_ns()
        return self._ids

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.time_ns()
        attrs = self.attributes or {}
        if exc is not None:
            attrs = {**attrs, "error": repr(exc)}
        if self._rec is not None:
            _recorded_parent.reset(self._name_token)
            if self._rec is _recording:
                self._rec.add((self.name, threading.current_thread().name,
                               threading.get_native_id(), self._t0, t1,
                               self._parent_name, attrs))
        if self._ids is not None:
            _current.reset(self._ctx_token)
            core = _runtime()
            if core is None:
                return
            try:
                core.record_task_event({
                    "kind": "span",
                    "task_id": self._ids[1],      # state-API identity column
                    "name": self.name,
                    "trace_id": self._ids[0],
                    "span_id": self._ids[1],
                    "parent_id": self._parent_id,
                    "start": self._t0 / 1e9,
                    "end": t1 / 1e9,
                    "status": "FAILED" if exc is not None else "FINISHED",
                    "attributes": attrs,
                })
            except Exception:
                pass   # e.g. the runtime's loop closed at shutdown


def get_spans(limit: int = 5000,
              trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Finished spans from the GCS (newest first); optionally one trace.
    The trace filter is pushed down server-side — the page limit applies
    AFTER filtering, so a busy retention window can't truncate a trace."""
    from ray_tpu_torch.util.state import list_tasks
    return list_tasks(limit=limit, kind="span", trace_id=trace_id)

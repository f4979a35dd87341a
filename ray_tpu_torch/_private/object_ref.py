"""Distributed future handle.

Design analog: reference ``python/ray/_raylet.pyx`` ObjectRef +
``src/ray/core_worker/reference_count.h`` -- ownership-based refs.  The ref
carries its owner's rpc address so any holder can resolve the value: owner's
in-process memory store for small objects, the shared-memory store + GCS
object directory for large ones.

Refcounting: each live Python ObjectRef in a process counts one local
reference; when a process's count for an id hits zero the CoreWorker is
notified -- the owner frees owned objects eagerly, borrowers just forget.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

_refcount_sink = None  # set by CoreWorker at init


def set_refcount_sink(sink):
    global _refcount_sink
    _refcount_sink = sink


import threading as _threading

_pickle_observer = _threading.local()


class observe_pickled_refs:
    """Context manager collecting every ObjectRef pickled inside it.

    Lets serialize_args pin refs *nested* in containers (the reference
    tracks these as 'contained in owned object' references,
    reference_count.h) — without this, only top-level args were pinned and
    a nested ref could be freed by the owner mid-submission."""

    def __init__(self, sink: list):
        self.sink = sink

    def __enter__(self):
        self.prev = getattr(_pickle_observer, "sink", None)
        _pickle_observer.sink = self.sink
        return self.sink

    def __exit__(self, *exc):
        _pickle_observer.sink = self.prev
        return False


class ObjectRefGenerator:
    """Result of getting a ``num_returns="dynamic"`` task's ref: the
    ordered refs of everything the task yielded (reference:
    ObjectRefGenerator / DynamicObjectRefGenerator in _raylet.pyx)."""

    def __init__(self, refs):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self):
        return len(self._refs)

    def __getitem__(self, i):
        return self._refs[i]

    def __repr__(self):
        return f"ObjectRefGenerator({len(self._refs)} refs)"


class StreamingObjectRefGenerator:
    """Handle to a ``num_returns="streaming"`` call (reference:
    ObjectRefStream / StreamingObjectRefGenerator in _raylet.pyx): an
    iterator of per-yield ObjectRefs that become consumable **while the
    producer task is still running** — the executor advertises each yield
    to the owner as it happens instead of batching refs into the final
    reply.

    ``async for ref in gen`` works on any asyncio loop; plain ``for ref
    in gen`` works from any non-core-loop thread.  ``gen.completed()``
    is the task's return-0 ref — it resolves to an ObjectRefGenerator of
    every yielded ref once the producer finishes, or raises the task's
    error.  ``gen.cancel()`` (also fired from ``__del__`` when the
    handle is dropped mid-stream) stops the producer: its next yield is
    refused by the owner, which closes the user generator so ``finally``
    blocks run and release whatever the stream held.

    The handle is owner-local and deliberately unpicklable — forward the
    consumed values, not the stream."""

    def __init__(self, task_id_hex: str, ref0: "ObjectRef"):
        self._task_id = task_id_hex
        self._ref0 = ref0
        self._exhausted = False

    @staticmethod
    def _core():
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.core_worker

    # ---- async iteration (primary API) ----

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._exhausted:
            raise StopAsyncIteration
        import asyncio
        core = self._core()
        coro = core.stream_next_async(self._task_id)
        try:
            if asyncio.get_running_loop() is core.loop:
                return await coro
            fut = asyncio.run_coroutine_threadsafe(coro, core.loop)
            return await asyncio.wrap_future(fut)
        except StopAsyncIteration:
            self._exhausted = True
            raise

    # ---- sync iteration (driver threads) ----

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        try:
            return self._core().stream_next(self._task_id)
        except StopAsyncIteration:
            self._exhausted = True
            raise StopIteration from None

    # ---- lifecycle ----

    def completed(self) -> "ObjectRef":
        """Ref of the task's terminal result: an ObjectRefGenerator of
        all yielded refs on success, the task's error otherwise."""
        return self._ref0

    def task_id(self) -> str:
        return self._task_id

    def cancel(self):
        """Stop consuming AND stop the producer (best effort)."""
        self._exhausted = True
        try:
            self._core().cancel_stream(self._task_id, self._ref0)
        except Exception:
            pass

    def __del__(self):
        if not self._exhausted:
            try:
                self.cancel()
            except Exception:
                pass

    def __reduce__(self):
        raise TypeError(
            "StreamingObjectRefGenerator is owner-local and cannot be "
            "pickled; consume the stream and forward the values instead")

    def __repr__(self):
        return f"StreamingObjectRefGenerator({self._task_id[:16]})"


class ObjectRef:
    __slots__ = ("id", "owner_address", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: str = ""):
        self.id = object_id
        self.owner_address = owner_address
        if _refcount_sink is not None:
            _refcount_sink.add_local_ref(self.id, owner_address)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.id == other.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    def __del__(self):
        if _refcount_sink is not None:
            try:
                _refcount_sink.remove_local_ref(self.id, self.owner_address)
            except Exception:
                pass

    def __reduce__(self):
        sink = getattr(_pickle_observer, "sink", None)
        if sink is not None:
            sink.append(self)
        return (ObjectRef, (self.id, self.owner_address))

    # Allow `await ref` inside async actors / driver coroutines.
    def __await__(self):
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.core_worker.get_async(self).__await__()

    def future(self):
        """concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch._private.worker import global_worker
        return global_worker.core_worker.as_future(self)

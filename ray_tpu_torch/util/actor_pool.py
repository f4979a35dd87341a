"""ActorPool: distribute work over a fixed set of actors.

Port of ``ray_tpu/util/actor_pool.py``.  Design analog: reference ``python/ray/util/actor_pool.py`` — submit/map
with get_next / get_next_unordered, has_next, push/pop for resizing.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0       # submission order
        self._next_return_index = 0     # ordered-get cursor

    # ---------------------------------------------------------- submission

    def submit(self, fn: Callable, value: Any):
        """fn(actor, value) -> ObjectRef; queues if every actor is busy."""
        if not self._idle:
            # Block for one completion to free an actor (reference blocks
            # in get_next; blocking in submit keeps the API minimal).
            self._wait_any()
        actor = self._idle.pop()
        ref = fn(actor, value)
        idx = self._next_task_index
        self._next_task_index += 1
        self._future_to_actor[ref.hex()] = (actor, ref)
        self._index_to_future[idx] = ref

    def _wait_any(self):
        refs = [ref for _, ref in self._future_to_actor.values()]
        done, _ = ray_tpu_torch.wait(refs, num_returns=1)
        # Free the actor AND retire its tracking entry: releasing while
        # the entry lives would let a later get_next release the same
        # (now busy) actor a second time.
        self._free_actor(done[0])

    def _free_actor(self, ref):
        """Return ref's actor to the idle pool exactly once."""
        entry = self._future_to_actor.pop(ref.hex(), None)
        if entry is not None:
            actor, _ = entry
            self._idle.append(actor)

    # ------------------------------------------------------------- results

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout=None) -> Any:
        """Next result in submission order.  A timeout leaves the pool
        state untouched so the call can be retried; a task FAILURE advances
        the cursor (re-raising the error) so iteration continues past it —
        otherwise a single failed task wedges the ordered stream forever."""
        from ray_tpu_torch import exceptions as rex
        idx = self._next_return_index
        if idx not in self._index_to_future:
            raise StopIteration("no pending results")
        ref = self._index_to_future[idx]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except rex.GetTimeoutError:
            raise                          # retryable; state kept
        except Exception:
            del self._index_to_future[idx]
            self._next_return_index += 1
            self._free_actor(ref)
            raise
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._free_actor(ref)
        return value

    def get_next_unordered(self, timeout=None) -> Any:
        """Whichever pending result finishes first."""
        if not self._index_to_future:
            raise StopIteration("no pending results")
        refs = list(self._index_to_future.values())
        done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not done:
            from ray_tpu_torch import exceptions as rex
            raise rex.GetTimeoutError(
                f"no result ready after {timeout}s")
        ref = done[0]
        for idx, r in list(self._index_to_future.items()):
            if r.hex() == ref.hex():
                del self._index_to_future[idx]
                break
        value = ray_tpu_torch.get(ref)
        self._free_actor(ref)
        return value

    # ----------------------------------------------------------------- map

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -------------------------------------------------------------- resize

    def push(self, actor):
        self._idle.append(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

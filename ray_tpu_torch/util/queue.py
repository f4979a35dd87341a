"""Distributed FIFO queue backed by an actor.

Port of ``ray_tpu/util/queue.py``.  Design analog: reference ``python/ray/util/queue.py`` — Queue with
put/get/put_nowait/get_nowait/qsize/empty/full over a _QueueActor; async
blocking happens inside the actor so callers don't busy-poll.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(num_cpus=0)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
        except asyncio.TimeoutError:
            raise Full("queue full") from None
        return True

    def put_nowait(self, item):
        try:
            self._q.put_nowait(item)
        except asyncio.QueueFull:
            raise Full("queue full") from None
        return True

    async def get(self, timeout: Optional[float] = None):
        try:
            return await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            raise Empty("queue empty") from None

    def get_nowait(self):
        try:
            return self._q.get_nowait()
        except asyncio.QueueEmpty:
            raise Empty("queue empty") from None

    def get_nowait_batch(self, n: int) -> List[Any]:
        out = []
        for _ in range(n):
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    def qsize(self) -> int:
        return self._q.qsize()


def _unwrap(ref):
    """Surface Empty/Full as themselves, not as a wrapped TaskError."""
    from ray_tpu_torch import exceptions as rex
    try:
        return ray_tpu_torch.get(ref)
    except rex.TaskError as e:
        if isinstance(e.cause, (Empty, Full)):
            raise e.cause from None
        raise


class Queue:
    """Driver/worker-side handle; safe to pass to tasks and actors."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 64)  # blocking put/get overlap
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        if not block:
            return _unwrap(self._actor.put_nowait.remote(item))
        return _unwrap(self._actor.put.remote(item, timeout))

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            return _unwrap(self._actor.get_nowait.remote())
        return _unwrap(self._actor.get.remote(timeout))

    def put_nowait(self, item):
        return self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, n: int) -> List[Any]:
        return ray_tpu_torch.get(self._actor.get_nowait_batch.remote(n))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self):
        ray_tpu_torch.kill(self._actor)

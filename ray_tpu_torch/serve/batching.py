"""Micro-batching for replica methods (reference: serve/batching.py).

``@serve.batch`` turns ``async def f(self, items: list)`` into a per-call
API: concurrent callers are queued, and when either ``max_batch_size``
requests are waiting or ``batch_wait_timeout_s`` elapses, the underlying
function runs once on the batch and each caller gets its own element.

On GPU replicas this is the fill-the-card lever: a forward with a batch
dim amortizes the kernel launches across concurrent requests.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch._private.async_utils import spawn
import functools
from typing import Any, Callable, List, Optional


def batch(fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    def wrap(func):
        attr = f"__serve_batch_queue_{func.__name__}"

        @functools.wraps(func)
        async def caller(self, item):
            # The queue lives on the instance (not a closure dict keyed by
            # id(self)): it dies with the instance and can't be handed to a
            # different object on CPython id reuse.
            q = getattr(self, attr, None)
            if q is None:
                q = _BatchQueue(lambda items: func(self, items),
                                max_batch_size, batch_wait_timeout_s)
                setattr(self, attr, q)
            return await q.submit(item)

        caller._is_serve_batch = True
        return caller

    if fn is not None:
        return wrap(fn)
    return wrap


class _BatchQueue:
    def __init__(self, fn, max_size: int, wait_s: float):
        self._fn = fn
        self._max = max_size
        self._wait = wait_s
        self._pending: List = []   # (item, future)
        self._flusher: Optional[asyncio.TimerHandle] = None

    async def submit(self, item) -> Any:
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((item, fut))
        if len(self._pending) >= self._max:
            self._flush()
        elif self._flusher is None:
            self._flusher = asyncio.get_running_loop().call_later(
                self._wait, self._flush)
        return await fut

    def _flush(self):
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        batch_, self._pending = self._pending, []
        if not batch_:
            return
        items = [x for x, _ in batch_]
        futs = [f for _, f in batch_]

        async def run():
            try:
                results = await self._fn(items)
                if len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} "
                        f"results for {len(items)} inputs")
                for f, r in zip(futs, results):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:
                for f in futs:
                    if not f.done():
                        f.set_exception(e)

        spawn(run(), name="serve-batch-run")

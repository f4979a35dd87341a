"""multiprocessing.Pool shim over cluster actors.

Port of ``ray_tpu/util/multiprocessing.py``.

Design analog: reference ``python/ray/util/multiprocessing/pool.py`` — the
stdlib Pool API backed by actors, so existing ``with Pool() as p:
p.map(f, xs)`` code scales across the cluster unchanged.  Covers the
commonly-used surface (map/starmap/imap/imap_unordered/apply/apply_async/
map_async); initializer/initargs run once per worker actor.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run_chunk(self, fn, chunk, star):
        if star:
            return [fn(*args) for args in chunk]
        return [fn(x) for x in chunk]

    def run_one(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))


class AsyncResult:
    """Stdlib-shaped handle over pending ObjectRefs."""

    def __init__(self, refs: List[Any], flatten: bool, single: bool):
        self._refs = refs
        self._flatten = flatten
        self._single = single

    def get(self, timeout: Optional[float] = None):
        outs = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._flatten:
            outs = [x for chunk in outs for x in chunk]
        return outs[0] if self._single else outs

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Actor-backed process pool (reference ray.util.multiprocessing.Pool).

    Each "process" is a cluster actor, so the pool spans nodes when the
    cluster does; CPU accounting rides the normal actor resource path.
    """

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), *, ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            processes = max(1, int(total))
        worker_cls = ray_tpu_torch.remote(_PoolWorker)
        opts = {"num_cpus": 1, **(ray_remote_args or {})}
        self._actors = [worker_cls.options(**opts).remote(
            initializer, tuple(initargs)) for _ in range(processes)]
        self._n = processes
        self._closed = False

    # -- lifecycle --------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []

    def join(self):
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False

    # -- mapping ----------------------------------------------------------

    def _chunks(self, iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._n * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], len(items)

    def _submit_chunks(self, fn, iterable, chunksize, star) -> AsyncResult:
        chunks, _ = self._chunks(iterable, chunksize)
        refs = [self._actors[i % self._n].run_chunk.remote(fn, c, star)
                for i, c in enumerate(chunks)]
        return AsyncResult(refs, flatten=True, single=False)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self._submit_chunks(fn, iterable, chunksize, False).get()

    def map_async(self, fn, iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        return self._submit_chunks(fn, iterable, chunksize, False)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        return self._submit_chunks(fn, iterable, chunksize, True).get()

    def apply(self, fn: Callable, args=(), kwds=None):
        return ray_tpu_torch.get(
            self._actors[0].run_one.remote(fn, tuple(args), kwds))

    def apply_async(self, fn: Callable, args=(), kwds=None) -> AsyncResult:
        idx = next(_rr) % self._n
        return AsyncResult(
            [self._actors[idx].run_one.remote(fn, tuple(args), kwds)],
            flatten=False, single=True)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        chunks, _ = self._chunks(iterable, chunksize)
        refs = [self._actors[i % self._n].run_chunk.remote(fn, c, False)
                for i, c in enumerate(chunks)]
        for ref in refs:                      # submission order
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        chunks, _ = self._chunks(iterable, chunksize)
        pending = {self._actors[i % self._n].run_chunk.remote(fn, c, False)
                   for i, c in enumerate(chunks)}
        while pending:
            done, pending_l = ray_tpu_torch.wait(list(pending), num_returns=1)
            pending = set(pending_l)
            for ref in done:
                yield from ray_tpu_torch.get(ref)


_rr = itertools.count(int.from_bytes(os.urandom(2), "big"))

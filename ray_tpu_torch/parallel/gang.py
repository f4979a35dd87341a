"""Run one function on every rank of a fresh torch.distributed world.

A gang is ``world_size`` processes started with the ``spawn`` method.
Each one sets ``torch.set_num_threads(1)``, joins a process group through
a file store in a temporary directory (no TCP port to pick or to collide
on), calls ``fn(rank, world_size, *args)`` and writes the result to a
file that the parent reads once the rank has exited cleanly.  The parent
waits under one deadline: when it passes, or when a rank exits with an
error, every rank is killed and the gang raises, so a hang costs its
caller the deadline and no more.

``fn`` and ``args`` are pickled, so ``fn`` is a function at the top level
of an importable module.  The CPU gangs run gloo; a CUDA gang runs NCCL
with one card per rank.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch


def _rank_main(fn: Callable, rank: int, world_size: int, tmp: str,
               backend: str) -> None:
    import torch.distributed as dist

    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend,
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world_size)
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    # Written whole, then renamed: the parent reads a result only from a
    # rank that exited cleanly, and only a complete one.
    path = os.path.join(tmp, f"result-{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def run_gang(fn: Callable, world_size: int, args: Sequence = (), *,
             timeout_s: float = 120.0, backend: str = "gloo") -> List[Any]:
    """``fn(rank, world_size, *args)`` on each of ``world_size`` fresh
    ranks; returns the results in rank order.  Raises ``TimeoutError``
    when the gang has not finished within ``timeout_s`` and
    ``RuntimeError`` when a rank exits without a result (its traceback is
    on stderr); both kill every rank first."""
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"an NCCL gang of {world_size} needs as many "
                           f"CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="rt_gang_") as tmp:
        # The args travel in a file: sent through the start pipe, more
        # than its buffer would hold each start until that rank has
        # imported torch, one rank after another.
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, tmp, backend),
                             daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            running = {p.sentinel: r for r, p in enumerate(procs)}
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"gang of {world_size} did not finish within "
                        f"{timeout_s:.0f} s (ranks {sorted(running.values())}"
                        f" still running)")
                for sentinel in mp_connection.wait(list(running),
                                                   timeout=left):
                    rank = running.pop(sentinel)
                    procs[rank].join()
                    if procs[rank].exitcode != 0:
                        raise RuntimeError(
                            f"gang of {world_size}: rank {rank} exited with "
                            f"code {procs[rank].exitcode}; see its "
                            f"traceback on stderr")
            out = []
            for r in range(world_size):
                with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)

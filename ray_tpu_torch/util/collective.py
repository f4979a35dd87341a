"""Host-driven named collective groups (ray.util.collective equivalent).

Reference analog: ``python/ray/util/collective/collective.py`` —
init_collective_group (:120), allreduce (:258), barrier (:298),
broadcast (:373), allgather (:423), reducescatter (:472), send (:531),
recv (:594); NCCL/Gloo groups rendezvous through a named actor store
(util/collective/const.py).

Port of ``ray_tpu/util/collective.py``.  The FAST path for tensors on
cards is never this module: collectives inside a step run over NCCL on a
mesh's process groups (``ray_tpu_torch.parallel.collectives``).  This
veneer exists for the reference's *host-side* use cases: actor code
coordinating small arrays (weight broadcast, metric reduction, rendezvous
barriers) without wiring a world.  The transport is a per-group
coordinator actor (the moral equivalent of the reference's Gloo CPU
backend): members gather to it, it reduces once, and every member receives
the result.  Numpy arrays and torch tensors both go through it; a tensor on
a card travels as its host copy and comes back on the caller's device.

Usage (inside N member actors)::

    from ray_tpu_torch.util import collective
    collective.init_collective_group(world_size=4, rank=r, group_name="g")
    out = collective.allreduce(np.ones(8), group_name="g")
"""

from __future__ import annotations

import asyncio
import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

_GROUP_PREFIX = "_collective:"
_local = threading.local()


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _host(arr):
    """A torch tensor as its CPU copy, anything else as a numpy array."""
    if _is_tensor(arr):
        return arr.detach().cpu()
    return np.asarray(arr)


def _to_device(value, like):
    """``value`` (a coordinator's reply) on the device of ``like``, the
    caller's input, when that is a tensor on a card."""
    if not (_is_tensor(like) and like.device.type != "cpu"):
        return value
    if isinstance(value, list):
        return [_to_device(v, like) for v in value]
    return value.to(like.device) if _is_tensor(value) else value


class _Coordinator:
    """Async actor: rendezvous + reduce for one named group.

    Every collective is keyed by a per-member monotonically increasing
    sequence number, so concurrent collectives from the same group can't
    interleave wrongly (the reference relies on NCCL stream ordering for
    this; here the seq plays that role).
    """

    def __init__(self, world_size: int):
        self.world = world_size
        self._rounds: Dict[Any, dict] = {}
        self._mailbox: Dict[Any, asyncio.Future] = {}

    def world_size(self) -> int:
        return self.world

    def _round(self, key):
        r = self._rounds.get(key)
        if r is None:
            r = self._rounds[key] = {
                "parts": {},
                "done": asyncio.get_running_loop().create_future(),
            }
        return r

    async def _rendezvous(self, key, rank: int, payload, compute) -> Any:
        """Wait for all members; `compute(parts)` runs ONCE (in the member
        that completes the round) and its value is what everyone returns —
        O(world) total reduction work, not O(world^2)."""
        r = self._round(key)
        r["parts"][rank] = payload
        if len(r["parts"]) == self.world:
            r["result"] = compute(r["parts"])
            r["done"].set_result(None)
            self._rounds.pop(key, None)
        await r["done"]
        return r["result"]

    @staticmethod
    def _reduce(parts: Dict[int, Any], op: str, world: int):
        vals = list(parts.values())
        out = vals[0]
        for p in vals[1:]:
            if op in ("sum", "mean"):
                out = out + p
            elif op == "max":
                out = out.maximum(p) if _is_tensor(out) else np.maximum(out, p)
            elif op == "min":
                out = out.minimum(p) if _is_tensor(out) else np.minimum(out, p)
            elif op == "prod":
                out = out * p
            else:
                raise ValueError(f"unknown reduce op {op!r}")
        return out / world if op == "mean" else out

    async def allreduce(self, seq: int, rank: int, arr, op: str = "sum"):
        return await self._rendezvous(
            ("ar", seq, op), rank, _host(arr),
            lambda parts: self._reduce(parts, op, self.world))

    async def allgather(self, seq: int, rank: int, arr):
        return await self._rendezvous(
            ("ag", seq), rank, _host(arr),
            lambda parts: [parts[i] for i in range(self.world)])

    async def reducescatter(self, seq: int, rank: int, arr, op: str = "sum"):
        """Each member contributes a full array; member i receives the i-th
        of world equal chunks of the reduction."""
        chunks = await self._rendezvous(
            ("rs", seq, op), rank, _host(arr),
            lambda parts: _split(self._reduce(parts, op, self.world),
                                 self.world))
        return chunks[rank]

    async def broadcast(self, seq: int, rank: int, arr, src_rank: int):
        return await self._rendezvous(
            ("bc", seq), rank,
            _host(arr) if rank == src_rank else None,
            lambda parts: parts[src_rank])

    async def barrier(self, seq: int, rank: int):
        await self._rendezvous(("ba", seq), rank, True, lambda parts: True)
        return True

    def _chan(self, tag) -> dict:
        ch = self._mailbox.get(tag)
        if ch is None:
            import collections
            ch = self._mailbox[tag] = {"values": collections.deque(),
                                       "waiters": collections.deque()}
        return ch

    async def send(self, tag, arr):
        ch = self._chan(tag)
        val = _host(arr)
        if ch["waiters"]:
            ch["waiters"].popleft().set_result(val)
        else:
            ch["values"].append(val)
        return True

    async def recv(self, tag):
        ch = self._chan(tag)
        if ch["values"]:
            return ch["values"].popleft()
        fut = asyncio.get_running_loop().create_future()
        ch["waiters"].append(fut)
        return await fut


def _split(arr, n: int):
    if _is_tensor(arr):
        return list(arr.tensor_split(n))
    return np.array_split(arr, n)


class _GroupState:
    def __init__(self, handle, world_size: int, rank: int):
        self.handle = handle
        self.world = world_size
        self.rank = rank
        self.seq = 0

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq


def _groups() -> Dict[str, _GroupState]:
    g = getattr(_local, "groups", None)
    if g is None:
        g = _local.groups = {}
    return g


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join a named collective group (call once per member process/actor).

    The first member to arrive creates the coordinator actor; the named-
    actor registry is the rendezvous store (reference: collective.py:52).
    """
    import ray_tpu_torch
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    coord_cls = ray_tpu_torch.remote(_Coordinator)
    handle = coord_cls.options(
        name=_GROUP_PREFIX + group_name, get_if_exists=True,
        lifetime="detached", num_cpus=0.05,
        max_concurrency=max(64, 4 * world_size)).remote(world_size)
    # get_if_exists may have attached to a stale coordinator from an
    # earlier group with a different size — collectives would then hang
    # waiting for members that will never come.  Fail fast instead.
    actual = ray_tpu_torch.get(handle.world_size.remote(), timeout=120)
    if actual != world_size:
        raise RuntimeError(
            f"collective group {group_name!r} already exists with "
            f"world_size={actual} (asked for {world_size}); destroy it "
            f"first with destroy_collective_group")
    _groups()[group_name] = _GroupState(handle, world_size, rank)


def destroy_collective_group(group_name: str = "default") -> None:
    import ray_tpu_torch
    st = _groups().pop(group_name, None)
    if st is not None and st.rank == 0:
        try:
            ray_tpu_torch.kill(st.handle)
        except Exception:
            pass


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups()


def get_rank(group_name: str = "default") -> int:
    return _groups()[group_name].rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _groups()[group_name].world


def _call(group_name: str, method: str, arr=None, *args):
    import ray_tpu_torch
    st = _groups().get(group_name)
    if st is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized here — call "
            f"init_collective_group first")
    head = () if arr is None else (_host(arr),)
    ref = getattr(st.handle, method).remote(st.next_seq(), st.rank, *head,
                                            *args)
    return _to_device(ray_tpu_torch.get(ref, timeout=600), arr)


def allreduce(arr, op: str = "sum", group_name: str = "default"):
    return _call(group_name, "allreduce", arr, op)


def allgather(arr, group_name: str = "default") -> List:
    return _call(group_name, "allgather", arr)


def reducescatter(arr, op: str = "sum", group_name: str = "default"):
    return _call(group_name, "reducescatter", arr, op)


def broadcast(arr, src_rank: int = 0, group_name: str = "default"):
    return _call(group_name, "broadcast", arr, src_rank)


def barrier(group_name: str = "default"):
    return _call(group_name, "barrier")


def send(arr, dst_rank: int, group_name: str = "default",
         tag: Optional[int] = None):
    """Point-to-point send (pairs with a matching recv)."""
    import ray_tpu_torch
    st = _groups()[group_name]
    key = ("p2p", st.rank, dst_rank, tag)
    return ray_tpu_torch.get(st.handle.send.remote(key, _host(arr)),
                             timeout=600)


def recv(src_rank: int, group_name: str = "default",
         tag: Optional[int] = None):
    import ray_tpu_torch
    st = _groups()[group_name]
    key = ("p2p", src_rank, st.rank, tag)
    return ray_tpu_torch.get(st.handle.recv.remote(key), timeout=600)

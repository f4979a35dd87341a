"""Functional collectives over a named mesh dim, for shard_map-ped code.

Port of ``ray_tpu/parallel/collectives.py``.  The reference's ops are
``jax.lax`` primitives that XLA lowers to ICI collectives inside a compiled
program; here each is a ``torch.distributed`` call over the process group
of one mesh dim (``mesh.get_group(axis_name)``), NCCL on the card and gloo
on the CPU.  ``axis_name`` resolves against ``mesh`` when given, else the
mesh of the enclosing ``parallel.sharding.shard_map``.

Each op is differentiable where the ``lax`` primitive is, by an autograd
function whose backward is the primitive's transpose: ``all_reduce`` (sum
and mean) all-reduces the gradient, ``all_gather`` reduce-scatters it,
``psum_scatter`` all-gathers it, ``all_to_all`` sends it back with the
split and concat axes swapped, and ``ppermute_ring`` rotates it the other
way.  The calls are synchronous from the caller's view (``async_op`` off),
so no result is read before its collective is done.  ``all_reduce`` with
max or min and ``barrier_sum`` carry no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import current_mesh


def _group(axis_name: str, mesh=None):
    return current_mesh(mesh).get_group(axis_name)


def axis_size(axis_name: str, mesh=None) -> int:
    """The size of mesh dim ``axis_name`` (``lax.axis_size``)."""
    mesh = current_mesh(mesh)
    return mesh.size(list(mesh.mesh_dim_names).index(axis_name))


def axis_index(axis_name: str, mesh=None) -> int:
    """This rank's coordinate along mesh dim ``axis_name``
    (``lax.axis_index``)."""
    return current_mesh(mesh).get_local_rank(axis_name)


def _all_reduce_sum(x, group):
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gather(x, group, axis: int, tiled: bool):
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _own_chunk(x, group, axis: int):
    n = dist.get_world_size(group)
    return x.chunk(n, axis)[dist.get_rank(group)].contiguous()


def _a2a(x, group, split_axis: int, concat_axis: int):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} does not split over {n}")
    send = torch.stack(x.chunk(n, split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_axis)


def _ring_shift(x, group, shift: int):
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.group, ctx.axis, ctx.tiled = group, axis, tiled
        return _gather(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_sum(g, ctx.group)
        if ctx.tiled:
            g = _own_chunk(g, ctx.group, ctx.axis)
        else:
            g = g.select(ctx.axis, dist.get_rank(ctx.group))
        return g, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _own_chunk(_all_reduce_sum(x, group), group, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.axis, True), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _a2a(g, ctx.group, concat_axis, split_axis), None, None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.group, -ctx.shift), None, None


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim, True), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim, True)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None


def split_replicated(x, axis_name: str, dim: int, mesh=None):
    """This rank's chunk along ``dim`` of ``x``, a value every rank of
    ``axis_name`` holds whole; the gradient comes back whole on every rank
    (the chunks' gradients gathered)."""
    return _SplitReplicated.apply(x, _group(axis_name, mesh), dim)


def gather_replicated(x, axis_name: str, dim: int, mesh=None):
    """The chunks of ``axis_name``'s ranks concatenated along ``dim``, for
    a consumer that every rank runs alike; the gradient of each rank's
    chunk is its slice of the (alike) gradients of the whole."""
    return _GatherReplicated.apply(x, _group(axis_name, mesh), dim)


def all_reduce(x, axis_name: str, op: str = "sum", mesh=None):
    """Sum, mean, max or min of ``x`` over the ranks of ``axis_name``."""
    group = _group(axis_name, mesh)
    if op == "sum":
        return _AllReduceSum.apply(x, group)
    if op == "mean":
        return _AllReduceSum.apply(x, group) / dist.get_world_size(group)
    reduce_op = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}.get(op)
    if reduce_op is None:
        raise ValueError(f"unknown reduce op {op!r}")
    out = x.detach().clone()
    dist.all_reduce(out, op=reduce_op, group=group)
    return out


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = True,
               mesh=None):
    """Every rank's ``x``, concatenated along ``axis`` in rank order
    (``tiled``) or stacked on a new ``axis``."""
    return _AllGather.apply(x, _group(axis_name, mesh), axis, tiled)


def psum_scatter(x, axis_name: str, scatter_dimension: int = 0, mesh=None):
    """Reduce-scatter: this rank's chunk (along ``scatter_dimension``) of
    the sum over the ranks; the building block of DP gradient sync."""
    return _PsumScatter.apply(x, _group(axis_name, mesh), scatter_dimension)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               mesh=None):
    """Split ``x`` along ``split_axis`` into one chunk per rank, send chunk
    j to rank j, and concatenate what arrives along ``concat_axis`` in rank
    order (Ulysses' head<->sequence reshuffle, MoE token dispatch)."""
    return _AllToAll.apply(x, _group(axis_name, mesh), split_axis,
                           concat_axis)


def ppermute_ring(x, axis_name: str, shift: int = 1, mesh=None):
    """Rotate shards around the ring: rank i's ``x`` goes to rank
    (i + shift) mod n (the ring-attention KV step)."""
    return _RingShift.apply(x, _group(axis_name, mesh), shift)


def barrier_sum(axis_name: str, mesh=None):
    """Cheapest full-axis synchronization: an all-reduce of an int32 zero
    on the mesh's device type."""
    mesh = current_mesh(mesh)
    z = torch.zeros((), dtype=torch.int32, device=mesh.device_type)
    dist.all_reduce(z, group=mesh.get_group(axis_name))
    return z


__all__ = ["all_reduce", "all_gather", "psum_scatter", "all_to_all",
           "ppermute_ring", "barrier_sum", "axis_size", "axis_index",
           "split_replicated", "gather_replicated"]

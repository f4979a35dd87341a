"""Ring attention: causal attention with the sequence sharded over a mesh axis.

Port of ``ray_tpu/ops/ring_attention.py``.  Each rank of the ``sp`` mesh
dim holds one contiguous sequence chunk of Q/K/V; K/V chunks rotate around
the ring (``parallel.collectives.ppermute_ring``, batched isend/irecv over
the dim's process group) while every rank accumulates blockwise
online-softmax partial results for its local queries.  Peak memory per
rank is O(S/sp).

``ulysses_attention`` is the all-to-all alternative (DeepSpeed-Ulysses):
reshuffle [seq-sharded, all heads] -> [all seq, head-sharded], run dense
attention per head group, and shuffle back.

The per-rank functions (``ring_attention_sharded``, ``ulysses_attention``)
take local ``[B, S/sp, N, H]`` chunks and an axis name, and run inside
``parallel.sharding.shard_map``; ``ring_attention`` is the mesh-level
wrapper.  The reference computes these in jnp, not in a Pallas kernel, so
plain torch (einsum, exp) is a full port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.parallel.collectives import (all_to_all, axis_index,
                                                axis_size, ppermute_ring)
from ray_tpu_torch.parallel.sharding import P, shard_map

_NEG_INF = -1e30


def _block_update(q, k, v, m, l, o, mask):
    """One online-softmax accumulation step. q:[B,Sq,N,H] k,v:[B,Sk,N,H],
    mask:[Sq,Sk] bool or None; carries m,l:[B,N,Sq,1], o:[B,Sq,N,H]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqnh,bknh->bnqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)  # [B,N,Sq,1]
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    o_new = o * alpha.movedim(1, 2) + torch.einsum(
        "bnqk,bknh->bnqh", p, v.float()).movedim(1, 2)
    return m_new, l_new, o_new


def ring_attention_sharded(q, k, v, axis_name: str = "sp", mesh=None):
    """Causal ring attention on this rank's chunks; call inside
    ``shard_map`` with the sequence sharded on ``axis_name``.  q,k,v:
    [B, S_local, N, H] (chunk i holds positions [i*S_local, (i+1)*S_local)).

    Every rank runs the same steps, masked blocks included (as the
    reference does): the autograd graph, and so the order of the
    collectives in the backward, is the same on every rank, which eager
    collectives need.  K and V travel as one stacked tensor, and the step
    after the last block is not taken."""
    B, Sq, N, H = q.shape
    sp = axis_size(axis_name, mesh)
    my = axis_index(axis_name, mesh)
    dev = q.device

    m = torch.full((B, N, Sq, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, N, Sq, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, N, H), dtype=torch.float32, device=dev)
    causal_mask = torch.ones((Sq, Sq), dtype=torch.bool, device=dev).tril()
    ones_mask = torch.ones_like(causal_mask)
    zeros_mask = torch.zeros_like(causal_mask)

    kv = torch.stack([k, v])
    for i in range(sp):
        # the kv chunk held now came from rank (my - i) mod sp:
        #   src < my -> full attention; src == my -> causal; src > my -> none
        src = (my - i) % sp
        mask = (causal_mask if src == my else
                ones_mask if src < my else zeros_mask)
        m, l, o = _block_update(q, kv[0], kv[1], m, l, o, mask)
        if i + 1 < sp:
            kv = ppermute_ring(kv, axis_name, mesh=mesh)
    out = o / l.movedim(1, 2).clamp_min(1e-30)
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   batch_axes=("dp", "fsdp"), head_axis: Optional[str] = "tp"):
    """Mesh-level wrapper: ``ring_attention_sharded`` under ``shard_map``.

    q,k,v: global [B, S, N, H] (DTensors, or plain tensors that every rank
    holds whole).  Sequence is sharded over ``axis_name``, batch over
    ``batch_axes``, heads over ``head_axis``.  Returns a DTensor so
    placed."""
    spec = P(tuple(batch_axes), axis_name, head_axis, None)

    def fn(q, k, v):
        return ring_attention_sharded(q, k, v, axis_name)

    return shard_map(fn, mesh, (spec, spec, spec), spec)(q, k, v)


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = True,
                      mesh=None):
    """All-to-all (DeepSpeed-Ulysses) attention; call inside shard_map.

    In: per-rank [B, S/sp, N, H] (seq sharded).  all_to_all to
    [B, S, N/sp, H] (heads sharded), dense attention locally, all_to_all
    back.  Requires N % sp == 0."""
    qh, kh, vh = (all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                             mesh=mesh) for x in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqnh,bknh->bnqk", qh, kh).float() * scale
    if causal:
        S = qh.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(qh.dtype)
    oh = torch.einsum("bnqk,bknh->bqnh", p, vh)
    return all_to_all(oh, axis_name, split_axis=1, concat_axis=2, mesh=mesh)


def make_ring_attention_fn(mesh, axis_name: str = "sp",
                           batch_axes=("dp", "fsdp"),
                           head_axis: Optional[str] = "tp"):
    """Autotune-dispatch hook: close over the mesh topology once and return
    an ``(q, k, v) -> o`` callable with the plain attention signature.
    Raises ValueError up front when the mesh cannot carry a ring (no
    ``axis_name`` dim, or size 1: a 1-wide ring is dense attention with
    extra steps)."""
    names = list(mesh.mesh_dim_names or ())
    sizes = {n: mesh.size(i) for i, n in enumerate(names)}
    if sizes.get(axis_name, 1) <= 1:
        raise ValueError(
            f"ring attention needs mesh axis {axis_name!r} with size > 1 "
            f"(got {sizes})")

    def fn(q, k, v):
        return ring_attention(q, k, v, mesh, axis_name=axis_name,
                              batch_axes=batch_axes, head_axis=head_axis)
    return fn

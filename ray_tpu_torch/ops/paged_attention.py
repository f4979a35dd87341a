"""Paged attention for KV-cache decode.

Port of ``ray_tpu/ops/paged_attention.py`` (vLLM PagedAttention analog).

K/V live in pools of fixed-size pages shared by all sequences; each
sequence maps its positions to pages through a page table.  Layouts follow
the reference op:

    q                [B, N, H]           one query token per sequence
    k_pages, v_pages [NKV, P, page, H]   KV-head-major page pools
    lengths          [B] int64           valid positions per sequence
    page_table       [B, maxp] int64     page ids per sequence

Page 0 is the scratch sink: padded and inactive writes land there.

The reference is plain jnp (a gather and a masked softmax), not a Pallas
kernel, so these plain PyTorch gathers and scatters are a full port.  One
difference: the pools are updated IN PLACE (``index_put_``) instead of
being returned as new arrays, which saves a copy of the whole pool per
step; ``append_kv`` and ``prefill_kv`` still return the pools so callers
read the same as the reference.  Unlike XLA, torch indexing does not clamp
out-of-range indices, so every index here is kept in range explicitly.
Duplicate writes to scratch page 0 (padding, idle decode slots) land in an
undefined order in both frameworks, which is harmless.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.parallel.sharding import P, shard_map


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_table: torch.Tensor, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention against paged K/V.

    Positions < ``lengths`` attend (the current token's K/V must already be
    written at position length-1).  GQA when N > NKV (N % NKV == 0).
    Returns [B, N, H] in q's dtype; the softmax runs in f32."""
    B, N, H = q.shape
    NKV, _P, page, _H = k_pages.shape
    if N % NKV:
        raise ValueError(f"query heads {N} not a multiple of KV heads {NKV}")
    rep = N // NKV
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(H)
    maxp = page_table.shape[1]
    S = maxp * page

    # Gather each sequence's pages: [NKV, B, maxp, page, H] -> [NKV, B, S, H]
    k = k_pages[:, page_table].reshape(NKV, B, S, H)
    v = v_pages[:, page_table].reshape(NKV, B, S, H)

    qg = q.reshape(B, NKV, rep, H)
    scores = torch.einsum("bkrh,kbsh->bkrs", qg, k) * scale
    valid = torch.arange(S, device=q.device)[None] < lengths[:, None]
    scores = torch.where(valid[:, None, None], scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrs,kbsh->bkrh", probs, v)
    return out.reshape(B, N, H)


def append_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor,
              page_table: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one token's K/V per sequence into the pools, in place.

    ``k_new``/``v_new`` [B, NKV, H]; ``pos`` [B] target positions, each
    below ``maxp * page`` (the engine reserves pages for every position a
    sequence reaches); ``page_table`` [B, maxp].  Inactive batch slots
    carry an all-zero table row and pos 0, so they write scratch page 0."""
    page = k_pages.shape[2]
    rows = torch.arange(page_table.shape[0], device=page_table.device)
    pid = page_table[rows, pos // page]                      # [B]
    slot = pos % page
    k_pages[:, pid, slot] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, pid, slot] = v_new.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def prefill_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
               k_seq: torch.Tensor, v_seq: torch.Tensor, length,
               page_table_row: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a whole (padded) prompt's K/V for ONE sequence, in place.

    ``k_seq``/``v_seq`` [NKV, S, H]; ``length`` the true length;
    ``page_table_row`` [maxp].  Positions >= length (padding) go to
    scratch page 0, so the sequence only dirties the pages it reserved."""
    page = k_pages.shape[2]
    S = k_seq.shape[1]
    pos = torch.arange(S, device=k_seq.device)
    real = pos < length
    # Padding may lie past the table's last page: index it at 0 instead of
    # relying on an out-of-range read being clamped.
    pid = torch.where(real, page_table_row[torch.where(real, pos // page, 0)],
                      0)
    slot = pos % page
    k_pages[:, pid, slot] = k_seq.to(k_pages.dtype)
    v_pages[:, pid, slot] = v_seq.to(v_pages.dtype)
    return k_pages, v_pages


def sharded_paged_attention(mesh, *, model_axis: str = "model",
                            sm_scale: Optional[float] = None):
    """GQA paged attention mapped over KV heads: q splits its head dim and
    the pools their leading KV-head dim over ``model_axis``, lengths and
    page tables are replicated, so each rank decodes its own head groups
    with no collective (each output head needs only its KV head group).
    Returns ``(q, k_pages, v_pages, lengths, page_table) -> o``, o a
    DTensor split on heads."""
    in_specs = (
        P(None, model_axis, None),         # q [B, N, H]
        P(model_axis, None, None, None),   # k_pages [NKV, P, page, H]
        P(model_axis, None, None, None),   # v_pages
        P(),                               # lengths
        P(),                               # page_table
    )

    def paged(q, k_pages, v_pages, lengths, page_table):
        return paged_attention(q, k_pages, v_pages, lengths, page_table,
                               sm_scale=sm_scale)

    return shard_map(paged, mesh, in_specs, P(None, model_axis, None))

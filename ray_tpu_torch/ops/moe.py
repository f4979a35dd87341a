"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis.

Port of ``ray_tpu/ops/moe.py``: the GShard/Switch recipe.  Tokens are
routed into a dense capacity-bounded dispatch tensor and moved between
data- and expert-sharded layouts by two einsums.

Shapes (S = tokens per batch row, E = experts, C = per-expert capacity):
  router logits  [B, S, E]        (f32 for a stable softmax)
  dispatch       [B, S, E, C]     0/1, token -> (expert, slot)
  combine        [B, S, E, C]     gate-weighted dispatch
  expert input   [E, B, C, D]     = einsum(x, dispatch)
  expert output  [E, B, C, D]     FFN per expert
  result         [B, S, D]        = einsum(ye, combine)

Tokens beyond an expert's capacity are dropped (their combine weight is 0
and the residual connection carries them through unchanged).

Two expert-parallel modes, as in the reference:

* GSPMD mode (``ep_axis`` None): with DTensor inputs the expert weights and
  activations carry the "expert" logical axis, the ``lc`` constraint points
  redistribute them, and DTensor emits the collectives.  The routing
  itself (a cumulative sum over each row's whole sequence, top-k, one-hot)
  runs per rank on whole rows (``parallel.sharding.per_rank``): the batch
  stays sharded as it is, the sequence and expert dims are gathered.  The aux loss's
  means over batch and sequence are DTensor reductions, so they are means
  over the global batch.
* shard_map mode (``ep_axis`` set): called inside ``shard_map`` with the
  expert weights pre-sharded on their leading expert dim ([E/ep, ...]);
  each ep rank runs its local experts on the (ep-replicated) tokens and an
  ``all_gather`` over ``ep_axis`` reassembles the expert outputs.

Top-k is a stable descending sort, so ties go to the lowest expert index
as ``jax.lax.top_k`` gives them.  The reference is jnp, not a Pallas
kernel, so plain torch is a full port.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from ray_tpu_torch.parallel.collectives import all_gather, axis_index
from ray_tpu_torch.parallel.sharding import per_rank
from ray_tpu_torch.util.tracing import local_span


def moe_capacity(S: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert and batch row: ``max(1, int(cf * S * k / E))``,
    truncated as in the reference."""
    return max(1, int(capacity_factor * S * top_k / num_experts))


def _route(probs, top_k: int, capacity: int, dtype: torch.dtype):
    """(dispatch [B,S,E,C] in ``dtype``, combine [B,S,E,C] f32, top-1
    one-hot [B,S,E] f32) from router probs [B,S,E] f32 over whole rows."""
    B, S, E = probs.shape
    C = capacity
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]    # [B,S,k]
    # Renormalize the selected gates so the combine weights sum to 1.
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)

    # Sequentially assign slots: k=0 choices get priority, then k=1, ...
    # (matches t5x/GShard ordering so top-1 picks are never bumped by
    # someone's secondary expert).
    counts = torch.zeros((B, E), dtype=torch.int64, device=probs.device)
    dispatch = torch.zeros((B, S, E, C), dtype=dtype, device=probs.device)
    combine = torch.zeros((B, S, E, C), dtype=torch.float32,
                          device=probs.device)
    for i in range(top_k):
        oh = F.one_hot(gate_idx[:, :, i], E)                     # [B,S,E]
        pos = oh.cumsum(dim=1) - 1 + counts[:, None, :]          # [B,S,E]
        counts = counts + oh.sum(dim=1)
        within = (pos < C) & (oh > 0)                            # [B,S,E]
        slot = F.one_hot(pos.clamp(0, C - 1), C).float()         # [B,S,E,C]
        sel = within.float()[..., None] * slot
        dispatch = dispatch + sel.to(dtype)
        combine = combine + gate_vals[:, :, i, None, None] * sel
    top1 = F.one_hot(gate_idx[:, :, 0], E).float()
    return dispatch, combine, top1


def moe_router(x, router_w, *, top_k: int, capacity: int):
    """Top-k routing with per-expert capacity.

    x [B,S,D] (any float dtype), router_w [D,E] (f32).
    Returns (dispatch [B,S,E,C] in x's dtype, combine [B,S,E,C] f32,
    aux_loss scalar f32): the Switch load-balance loss
    E * sum_e fraction_dispatched_e * mean_prob_e on top-1 assignments,
    differentiable through the probs."""
    E = router_w.shape[-1]
    # A matmul without batch dims (aten.mm), which the "dots" remat policy
    # saves as dots_with_no_batch_dims_saveable saves the reference's.
    logits = torch.matmul(x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)                        # [B,S,E]
    # Per rank on whole rows (batch split as it is, sequence gathered).
    dispatch, combine, top1 = per_rank(
        lambda p: _route(p, top_k, capacity, x.dtype), probs, dims=(0,))
    frac = top1.mean(dim=(0, 1))                                 # [E]
    mean_prob = probs.mean(dim=(0, 1))                           # [E]
    aux = E * (frac * mean_prob).sum()
    return dispatch, combine, aux


def moe_mlp(x, p, *, top_k: int, capacity_factor: float,
            lc: Optional[Callable] = None,
            ep_axis: Optional[str] = None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Expert-parallel FFN (drop-in for the dense MLP body of a block).

    x [B,S,D]; p = {"router": [D,E] f32, "wi": [E,D,M], "bi": [E,M],
    "wo": [E,M,D], "bo": [E,D]} (the expert dim carries the "expert"
    logical axis -> ep mesh axis).  ``lc(tensor, logical_axes)`` applies
    the sharding constraints (identity when unsharded or inside
    shard_map).  ``ep_axis`` selects the shard_map mode (see the module
    docstring).  The GELU is tanh-approximated, as ``jax.nn.gelu``'s
    default.  Returns (y [B,S,D], aux_loss).

    The span ``moe.ffn`` (``util/tracing.py``'s ``local_span``) covers
    the whole FFN: router, dispatch, experts and combine.  Under remat it
    opens again where autograd recomputes the block; the FFN's backward
    kernels are launched after it has closed and are not in it."""
    with local_span("moe.ffn"):
        if lc is None:
            def lc(a, ax):
                return a
        B, S, D = x.shape
        E = p["router"].shape[-1]
        dt = x.dtype
        capacity = moe_capacity(S, top_k, E, capacity_factor)

        dispatch, combine, aux = moe_router(
            x, p["router"].float(), top_k=top_k, capacity=capacity)

        if ep_axis is not None:
            # Slice the dispatch tensor to this member's experts BEFORE the
            # contraction: 1/ep of the dispatch FLOPs.
            e_local = p["wi"].shape[0]
            idx = axis_index(ep_axis)
            disp_local = dispatch[:, :, idx * e_local:(idx + 1) * e_local]
            xe = torch.einsum("bsd,bsec->ebcd", x, disp_local.to(dt))
        else:
            xe = torch.einsum("bsd,bsec->ebcd", x, dispatch.to(dt))
            xe = lc(xe, ("expert", "batch", None, "embed"))
        h = torch.einsum("ebcd,edm->ebcm", xe, p["wi"].to(dt)) \
            + p["bi"].to(dt)[:, None, None, :]
        h = lc(h, ("expert", "batch", None, "mlp"))
        h = F.gelu(h, approximate="tanh")
        ye = torch.einsum("ebcm,emd->ebcd", h, p["wo"].to(dt)) \
            + p["bo"].to(dt)[:, None, None, :]
        ye = lc(ye, ("expert", "batch", None, "embed"))
        if ep_axis is not None:
            ye = all_gather(ye, ep_axis, axis=0, tiled=True)
        y = torch.einsum("ebcd,bsec->bsd", ye, combine.to(dt))
        return lc(y, ("batch", "seq", "embed")), aux

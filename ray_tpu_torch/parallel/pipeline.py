"""Pipeline parallelism: the GPipe and 1F1B schedules over the ``pp`` mesh dim.

Port of ``ray_tpu/parallel/pipeline.py``.  The reference runs the whole
pipeline as one SPMD program: ``shard_map`` places one stage per device
along pp, a ``lax.scan`` over ``M + pp - 1`` ticks moves microbatch
activations stage to stage with ``lax.ppermute``, and autodiff through the
scan gives the backward pipeline.  Here each rank runs the same tick loop
eagerly on its own stage: the activation hop is ``collectives.ppermute_ring``
over the pp dim's process group, and the backward comes from autograd
through the ticks (GPipe) or is written out tick by tick (1F1B).

Storage and gradients.  Every rank holds the whole parameter tree as plain
tensors and runs the slice of the layer stack that is its stage's (and,
for an MoE in pp x ep, its ep member's experts).  The loss is a sum of
per-rank partials (each rank's share of the log-likelihood and of the MoE
aux, divided by ``repl_factor`` where ranks repeat the same work), added
up over the mesh by ``psum_partials``, whose backward hands each rank its
own partial's cotangent.  So each rank's backward yields its partial of
every parameter's gradient (zero outside its stage's layers), and
``replicated_params`` sums those partials over the mesh in one step at
the end of the backward: every rank ends with the whole gradient, as the
unpipelined loss gives it, and takes the same optimizer step.  That costs
every rank the memory and the optimizer work of the whole model, and an
all-reduce of every gradient (a pp-split storage would keep 1/pp of it).

Collectives in one order on every rank, also in the backward: every tick
shifts on every rank, fill and drain ticks run their (masked) stage too,
stage 0 takes its input through ``torch.where`` so the shift it received
stays in its graph, and the last tick's output is tied to the loss with a
zero cotangent (``_Anchor``), so the backward of every shift runs on every
rank, in reverse tick order, which the chain of activations forces.  The
head, the aux and the loss accumulators branch in Python (the reference's
``lax.cond``): no collective lies on those paths.

Flash launches per microbatch and stage layer: GPipe under ``cfg.remat``
checkpoints each block (full remat, whatever ``remat_policy``, as the
reference's ``jax.checkpoint(block_fn)``): forward 2 (the forward and the
backward's recompute), dq 1, dk/dv 1, on every tick, fill and drain
included.  1F1B runs each real stage forward without autograd, then again
in the backward tick with autograd and no checkpoint: the same 2/1/1, on
real ticks only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.gpt import (GPTConfig, Params,
                                      _auto_attention_variant, _block,
                                      _dense_causal_attention_bnsh,
                                      _flash_causal_attention_bnsh,
                                      _layer_norm, _layers, _leaves,
                                      gpt_param_axes, make_train_step,
                                      token_loglikes)
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.parallel.collectives import (all_gather, axis_index,
                                                axis_size, ppermute_ring)
from ray_tpu_torch.parallel.mesh import current_mesh, use_mesh
from ray_tpu_torch.parallel.sharding import P, _tree_map

_DATA_AXES = ("dp", "fsdp")


# ------------------------------------------------------------ reductions

class _SumPartials(torch.autograd.Function):
    """All-reduce sum over ``group``; the backward hands each rank's
    partial the cotangent of the total unreduced (each rank holds its own
    partial's graph)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _groups(axes, mesh=None) -> List[Any]:
    """The process groups of the mesh dims ``axes`` larger than 1."""
    mesh = current_mesh(mesh)
    return [mesh.get_group(a) for a in axes if axis_size(a, mesh) > 1]


def psum_partials(x, axes, mesh=None):
    """The sum of ``x`` over the ranks of the mesh dims ``axes`` (each
    rank's partial of a total); see ``_SumPartials``."""
    for group in _groups(axes, mesh):
        x = _SumPartials.apply(x, group)
    return x


class _SumGrads(torch.autograd.Function):
    """Identity on the parameter leaves; the backward sums the gradients
    over the groups (one node: it runs once, after every use of every
    leaf, on every rank alike), packed into one flat buffer a dtype, so
    each group takes one all-reduce a dtype, not one a leaf."""

    @staticmethod
    def forward(ctx, groups, *leaves):
        ctx.groups = groups
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for dtype in dict.fromkeys(g.dtype for g in grads):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            for group in ctx.groups:
                dist.all_reduce(flat, group=group)
            for i, g in zip(idx, flat.split([grads[i].numel()
                                             for i in idx])):
                out[i] = g.view(grads[i].shape)
        return (None, *out)


def _tree_unflatten(tree, leaves: Iterator[torch.Tensor]):
    """``tree`` with its leaves replaced, in ``_leaves`` order."""
    return _tree_map(lambda _: next(leaves), tree)


def replicated_params(params: Params, mesh) -> Params:
    """``params`` (plain tensors, the same on every rank) as the pipeline
    uses them: their gradients are each rank's partial summed over every
    dim of ``mesh`` (the transpose of a replicated input)."""
    leaves = list(_leaves(params))
    if any(isinstance(t, DTensor) for t in leaves):
        raise ValueError("the pipeline takes plain tensors that every rank "
                         "holds whole, not DTensors")
    groups = _groups(mesh.mesh_dim_names, mesh)
    if not groups or not torch.is_grad_enabled():
        return params
    return _tree_unflatten(params, iter(_SumGrads.apply(groups, *leaves)))


class _Anchor(torch.autograd.Function):
    """``x`` unchanged, with ``tied`` in the graph at a zero cotangent."""

    @staticmethod
    def forward(ctx, x, tied):
        ctx.like = (tied.shape, tied.dtype, tied.device)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


# -------------------------------------------------------------- schedules

def _stage_machinery(axis_name: str) -> Tuple[int, int]:
    """(pp, this rank's stage index) along ``axis_name``."""
    return axis_size(axis_name), axis_index(axis_name)


def _stage_fn(block_fn: Callable, remat: bool) -> Callable:
    """``stage(params, x) -> (y, aux)``: the blocks of the stage's stacked
    params in turn, each under a full-remat checkpoint when ``remat``; aux
    sums the layers' MoE losses (a zero for a dense FFN)."""
    def stage(params, x):
        layers = _layers({"layers": params}, next(_leaves(params)).shape[0])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in layers:
            if remat:
                x, a = checkpoint(block_fn, x, p, use_reentrant=False)
            else:
                x, a = block_fn(x, p)
            if a is not None:
                aux = aux + a.float()
        return x, aux
    return stage


def _gpipe_ticks(block_fn: Callable, local_params, x_mbs, axis_name: str,
                 remat: bool, drain: Callable) -> Tuple[Any, Any]:
    """The tick loop of both GPipe functions: ``M + pp - 1`` ticks, stage 0
    taking microbatch t, every stage running its layers (fill and drain
    ticks too) and shifting its output downstream; ``drain(m, y)`` as
    microbatch m leaves the last stage.  Returns (the aux summed over the
    real (stage, microbatch) passes, the output of the last tick)."""
    pp, idx = _stage_machinery(axis_name)
    M = x_mbs.shape[0]
    T = M + pp - 1
    stage = _stage_fn(block_fn, remat)
    first = (torch.tensor(idx == 0, device=x_mbs.device) if pp > 1
             else None)
    state = torch.zeros_like(x_mbs[0])
    aux_acc = torch.zeros((), dtype=torch.float32, device=x_mbs.device)
    for t in range(T):
        # Stage 0 takes microbatch t, the others the shifted state: where
        # keeps both in the graph, so every rank runs every shift's
        # backward.
        inp = x_mbs[min(t, M - 1)]
        state = inp if first is None else torch.where(first, inp, state)
        y, aux = stage(local_params, state)
        # This stage runs microbatch t - idx: its aux counts when that is
        # a real microbatch, not fill or drain.
        if 0 <= t - idx < M:
            aux_acc = aux_acc + aux
        if idx == pp - 1 and t >= pp - 1:
            drain(t - (pp - 1), y)
        if t < T - 1:
            state = ppermute_ring(y, axis_name, 1)
    return aux_acc, y


def gpipe_spmd(block_fn: Callable, local_params, x_mbs, *,
               axis_name: str = "pp", aux_axes=None, remat: bool = True):
    """Per-rank GPipe loop (inside ``use_mesh``; the forward of
    ``gpt_forward_pipelined``).

    block_fn:      (x, layer_params) -> (x, aux or None), one block.
    local_params:  this stage's stacked params, leading dim [L/pp].
    x_mbs:         [M, mb, ...] microbatched activations (read on stage 0).
    aux_axes:      mesh dims the aux sum runs over (``axis_name`` by
                   default; add the data dims when the batch is split).
    Returns ([M, mb, ...] outputs, summed over the pp ranks so every stage
    holds them, and the aux summed over every real (stage, microbatch)
    pass: fill and drain ticks are left out)."""
    outs = [torch.zeros_like(x_mbs[0])] * x_mbs.shape[0]

    def drain(m, y):
        outs[m] = y

    aux_acc, y = _gpipe_ticks(block_fn, local_params, x_mbs, axis_name,
                              remat, drain)
    out = torch.stack(outs)
    if axis_size(axis_name) > 1:
        out = _Anchor.apply(out, y)
    return (psum_partials(out, (axis_name,)),
            psum_partials(aux_acc, aux_axes or (axis_name,)))


def gpipe_fused_loss_spmd(block_fn: Callable, loss_mb_fn: Callable,
                          local_params, head_params, x_mbs, tgt_mbs, *,
                          axis_name: str = "pp", all_axes,
                          repl_factor: float, remat: bool = True):
    """GPipe schedule with the loss fused into the drain (inside
    ``use_mesh``).

    As each real microbatch leaves the last stage, ``loss_mb_fn(
    head_params, y, tgt) -> ll_sum`` computes its log-likelihood sum there
    (only the last stage runs the head), so no [M, mb, S, D] output buffer
    is gathered; the epilogue is two scalar sums over the mesh.
    ``repl_factor`` is the number of ranks that hold a redundant copy of
    this rank's work (the mesh size over pp x data x sp): the partials are
    divided by it before the sum over ``all_axes``.  The backward is
    autograd's through the ticks: the activations' chain replays them in
    reverse, each shift's backward the inverse shift.
    Returns (ll_sum, aux_sum), the same on every rank."""
    lls = []

    def drain(m, y):
        lls.append(loss_mb_fn(head_params, y, tgt_mbs[m]).float())

    aux_acc, y = _gpipe_ticks(block_fn, local_params, x_mbs, axis_name,
                              remat, drain)
    ll_acc = (functools.reduce(torch.add, lls) if lls else
              torch.zeros_like(aux_acc))
    if axis_size(axis_name) > 1:
        ll_acc = _Anchor.apply(ll_acc, y)
    return (psum_partials(ll_acc / repl_factor, all_axes),
            psum_partials(aux_acc / repl_factor, all_axes))


def one_f_one_b_spmd(block_fn: Callable, loss_mb_fn: Callable,
                     local_params, head_params, x_mbs, tgt_mbs, *,
                     axis_name: str = "pp", ll_cot: float, aux_cot: float):
    """1F1B schedule with the backward written out (inside ``use_mesh``,
    without autograd recording): activation memory O(pp), not O(M).

    Each of the ``M + 2pp - 2`` ticks runs one forward stage application
    (microbatch ``t - idx``, without autograd) and one backward
    (microbatch ``t - (2pp - 2 - idx)``): the stage is run again from its
    stashed input under autograd and differentiated with
    ``torch.autograd.grad``.  At most ``2pp - 2`` stage inputs are in
    flight, in a ring of ``2pp`` slots.  The last stage's backward of a
    microbatch follows its forward in the same tick, from the cotangent of
    its loss.  Fill and drain ticks skip the stage, which no collective
    lies inside (1F1B takes neither ep nor ring stages); every tick sends
    the activation downstream and then the cotangent upstream.  Weight
    grads accumulate in f32.  The backward's recompute of the stage is its
    remat.

    ``ll_cot``/``aux_cot`` are d(final loss)/d(each microbatch's ll and
    stage aux), so the grads are those of the final loss.
    Returns (ll_sum, aux_sum, g_layers, g_head, g_x_mbs): this rank's
    partials (the caller sums them over the mesh)."""
    pp, idx = _stage_machinery(axis_name)
    M = x_mbs.shape[0]
    R = 2 * pp
    stage = _stage_fn(block_fn, remat=False)
    dev, f32 = x_mbs.device, torch.float32

    def zeros(tree):
        return [torch.zeros(t.shape, dtype=f32, device=dev)
                for t in _leaves(tree)]

    g_layers, g_head = zeros(local_params), zeros(head_params)
    g_x = torch.zeros(x_mbs.shape, dtype=f32, device=dev)
    ll_acc = torch.zeros((), dtype=f32, device=dev)
    aux_acc = torch.zeros_like(ll_acc)
    stash: List[Optional[torch.Tensor]] = [None] * R
    zero_mb = torch.zeros_like(x_mbs[0])
    fwd_msg = bwd_msg = zero_mb
    for t in range(M + 2 * pp - 2):
        # forward: microbatch mf
        mf = t - idx
        y = dy_loss = zero_mb
        if 0 <= mf < M:
            x_in = x_mbs[mf] if idx == 0 else fwd_msg
            y, aux = stage(local_params, x_in)
            aux_acc = aux_acc + aux
            stash[mf % R] = x_in
            if idx == pp - 1:
                # the loss of this microbatch and its cotangent
                with torch.enable_grad():
                    yg = y.detach().requires_grad_(True)
                    hg = _requiring_grad(head_params)
                    ll = loss_mb_fn(hg, yg, tgt_mbs[mf])
                    dy_loss, *dh = torch.autograd.grad(
                        ll, [yg, *_leaves(hg)],
                        torch.tensor(ll_cot, dtype=ll.dtype, device=dev))
                ll_acc = ll_acc + ll.detach().float()
                for g, d in zip(g_head, dh):
                    g += d.float()
        # backward: microbatch mb
        mb = t - (2 * pp - 2 - idx)
        dx = zero_mb
        if 0 <= mb < M:
            x_saved, stash[mb % R] = stash[mb % R], None
            with torch.enable_grad():
                pg = _requiring_grad(local_params)
                xg = x_saved.detach().requires_grad_(True)
                y2, aux2 = stage(pg, xg)
                outs, cots = [y2], [dy_loss if idx == pp - 1 else bwd_msg]
                if aux2.requires_grad:
                    outs.append(aux2)
                    cots.append(torch.tensor(aux_cot, dtype=aux2.dtype,
                                             device=dev))
                *dparams, dx = torch.autograd.grad(
                    outs, [*_leaves(pg), xg], cots)
            for g, d in zip(g_layers, dparams):
                g += d.float()
            if idx == 0:
                g_x[mb] = dx.float()
        # activations downstream, then cotangents upstream
        if pp > 1:
            fwd_msg = ppermute_ring(y, axis_name, 1)
            bwd_msg = ppermute_ring(dx, axis_name, -1)
    return (ll_acc, aux_acc, _tree_unflatten(local_params, iter(g_layers)),
            _tree_unflatten(head_params, iter(g_head)), g_x)


def _requiring_grad(tree):
    """``tree`` with each leaf detached and set to require grad."""
    return _tree_map(lambda v: v.detach().requires_grad_(True), tree)


# ------------------------------------------------------- GPT integration

def _pipeline_head(params: Params) -> Params:
    """The params of the fused drain epilogue (shared by both pipeline
    loss paths: their numerics in one place)."""
    return {"wte": params["wte"], "ln_f": params["ln_f"]}


def _make_loss_mb(cfg: GPTConfig) -> Callable:
    """Per-microbatch epilogue: final LN, the full logits of the tied head
    and their summed target log-likelihoods, as the reference's (not the
    blocked head)."""
    dt = cfg.dtype

    def loss_mb(head, y, tgt):
        y = _layer_norm(y, head["ln_f"]["scale"], head["ln_f"]["bias"])
        logits = torch.matmul(y, head["wte"].to(dt).t())
        return token_loglikes(logits, tgt).sum()

    return loss_mb


def _resolve_attention(cfg: GPTConfig, mb: int, S: int,
                       device: torch.device) -> GPTConfig:
    """``cfg`` with ``attention="auto"`` resolved for one microbatch
    [mb, S] (the port's rule, ``gpt._auto_attention_variant``)."""
    if cfg.attention != "auto":
        return cfg
    return dataclasses.replace(
        cfg, attention=_auto_attention_variant(mb, S, cfg, device))


def _attn_fn_for(cfg: GPTConfig, mesh=None) -> Callable:
    """The head-major (bnsh) attention of a stage: dense, flash, or ring,
    which runs over the sp dim inside the stage on [mb, S/sp, ...]
    activation shards (``attention`` resolved, see
    ``_resolve_attention``)."""
    if cfg.attention not in ("dense", "flash", "ring"):
        raise ValueError(f"pipelined stages support dense/flash/ring "
                         f"attention, got {cfg.attention!r}")
    if cfg.attention == "ring":
        if mesh is None or axis_size("sp", mesh) <= 1:
            raise ValueError("ring attention in a pipeline needs an sp "
                             "mesh axis > 1")

        def attn_fn(q, k, v):
            o = ring_attention_sharded(*(t.transpose(1, 2)
                                         for t in (q, k, v)), axis_name="sp")
            return o.transpose(1, 2)
        return attn_fn
    if cfg.attention == "flash":
        return _flash_causal_attention_bnsh
    return _dense_causal_attention_bnsh


def _use_ep(cfg: GPTConfig, mesh) -> bool:
    return bool(cfg.num_experts) and axis_size("ep", mesh) > 1


def _layer_in_specs(cfg: GPTConfig, mesh) -> Params:
    """The spec tree of the stacked layer params: the [L] dim on pp and,
    with a real ep axis, the expert dims on ep (from the model's logical
    annotations)."""
    use_ep = _use_ep(cfg, mesh)

    def to_spec(ann):
        return P(*("pp" if a == "layers" else
                   "ep" if a == "expert" and use_ep else None for a in ann))

    return _tree_map(to_spec, gpt_param_axes(cfg)["layers"])


def _local(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a view); a dim split over
    several axes is split in JAX's element order (the first axis major)."""
    for dim, axes in enumerate(spec):
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        for axis in axes:
            n = axis_size(axis, mesh)
            if n > 1:
                x = x.chunk(n, dim)[axis_index(axis, mesh)]
    return x


def _local_layers(layers: Params, specs: Params, mesh) -> Params:
    return _tree_map(lambda x, spec: _local(x, spec, mesh), layers, specs)


def _check_pipeline_shapes(cfg: GPTConfig, mesh, B: int, M: int) -> int:
    """The data-axis size, after checking that the stages, microbatches,
    data shards and experts divide evenly."""
    pp = axis_size("pp", mesh)
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by "
                         f"pp={pp}")
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    dsize = axis_size("dp", mesh) * axis_size("fsdp", mesh)
    if (B // M) % dsize:
        raise ValueError(f"microbatch size {B // M} not divisible by "
                         f"data-axis size {dsize}")
    if _use_ep(cfg, mesh) and cfg.num_experts % axis_size("ep", mesh):
        raise ValueError(f"num_experts {cfg.num_experts} not divisible by "
                         f"ep={axis_size('ep', mesh)}")
    return dsize


def _microbatches(params: Params, tokens, targets, cfg: GPTConfig, mesh,
                  M: int, use_sp: bool):
    """(x_mbs, tgt_mbs): the embedded [M, mb, S, D] microbatches and their
    [M, mb, S] targets, each rank's block of them (rows over the data
    dims; the sequence over sp for ring stages)."""
    B, S = tokens.shape
    dt = cfg.dtype
    x = params["wte"][tokens].to(dt) + params["wpe"][:S].to(dt)[None]
    spec = P(None, _DATA_AXES, "sp" if use_sp else None)
    return (_local(x.reshape(M, B // M, S, -1), spec, mesh),
            _local(targets.reshape(M, B // M, S), spec, mesh))


def _pipeline_setup(params: Params, tokens, targets, cfg: GPTConfig, mesh,
                    M: int):
    """What every pipelined entry point starts from: (cfg with its
    attention resolved, B, S, data size, sp size, the replicated params,
    x_mbs, tgt_mbs, the stage's layers)."""
    B, S = tokens.shape
    dsize = _check_pipeline_shapes(cfg, mesh, B, M)
    cfg = _resolve_attention(cfg, B // M, S, tokens.device)
    use_sp = cfg.attention == "ring" and axis_size("sp", mesh) > 1
    spsize = axis_size("sp", mesh) if use_sp else 1
    params = replicated_params(params, mesh)
    x_mbs, tgt_mbs = _microbatches(params, tokens, targets, cfg, mesh, M,
                                   use_sp)
    layers = _local_layers(params["layers"], _layer_in_specs(cfg, mesh),
                           mesh)
    return cfg, B, S, dsize, spsize, params, x_mbs, tgt_mbs, layers


def _stage_block(cfg: GPTConfig, mesh) -> Callable:
    """GPT's block for a stage, resolving axis names against ``mesh``
    wherever it runs (a checkpoint recomputes it in the backward)."""
    block = functools.partial(_block, cfg, None, _attn_fn_for(cfg, mesh),
                              moe_ep_axis="ep" if _use_ep(cfg, mesh)
                              else None)

    def block_fn(x, p):
        with use_mesh(mesh):
            return block(x, p)
    return block_fn


@torch.no_grad()
def gpt_forward_pipelined(params: Params, tokens, cfg: GPTConfig, mesh, *,
                          num_microbatches: int):
    """GPT forward (f32 logits [B, S, V], aux) with the block stack
    pipelined over pp; the embedding and the head run outside the
    pipeline on every rank.  Dense, flash or ring attention, MoE stages
    (ep mode on a mesh with ep > 1).  An evaluation path, run without
    autograd: training takes ``gpt_loss_pipelined``, whose fused
    epilogue gathers no output."""
    M = num_microbatches
    (cfg, B, S, dsize, spsize, params, x_mbs, _,
     layers) = _pipeline_setup(params, tokens, tokens, cfg, mesh, M)
    use_sp = spsize > 1
    data = tuple(a for a in _DATA_AXES if axis_size(a, mesh) > 1)
    with use_mesh(mesh):
        y, aux = gpipe_spmd(_stage_block(cfg, mesh), layers, x_mbs,
                            remat=False, aux_axes=("pp",) + data
                            + (("sp",) if use_sp else ()))
        # each rank's rows and sequence chunk, gathered whole (the inner
        # axis first, so the rows come in dp-major order)
        if use_sp:
            y = all_gather(y, "sp", axis=2)
        for axis in reversed(data):
            y = all_gather(y, axis, axis=1)
    y = _layer_norm(y.reshape(B, S, -1), params["ln_f"]["scale"],
                    params["ln_f"]["bias"])
    logits = torch.matmul(y, params["wte"].to(cfg.dtype).t())
    # the (stage, microbatch, shard)-summed aux as gpt_forward_with_aux's:
    # the sum over layers of full-batch means
    return logits.float(), aux / (M * dsize * spsize)


def gpt_loss_pipelined(params: Params, batch, cfg: GPTConfig, mesh, *,
                       num_microbatches: int):
    """Pipelined next-token cross-entropy (GPipe, the fused drain
    epilogue), plus ``moe_aux_coef`` times the per-(layer, full-batch)
    aux mean: ``gpt_loss``'s value on the same params and batch, and, on
    every rank, its gradients (``replicated_params``).  ``params`` are
    plain tensors, the same on every rank; ``batch["tokens"]`` [B, S+1]
    every rank's whole batch."""
    M = num_microbatches
    toks = batch["tokens"]
    (cfg, B, S, dsize, spsize, params, x_mbs, tgt_mbs,
     layers) = _pipeline_setup(params, toks[:, :-1], toks[:, 1:], cfg, mesh,
                               M)
    repl = mesh.size() // (axis_size("pp", mesh) * dsize * spsize)
    with use_mesh(mesh):
        ll_sum, aux_sum = gpipe_fused_loss_spmd(
            _stage_block(cfg, mesh), _make_loss_mb(cfg), layers,
            _pipeline_head(params), x_mbs, tgt_mbs,
            all_axes=tuple(mesh.mesh_dim_names), repl_factor=float(repl),
            remat=cfg.remat)
    ce = -ll_sum / (B * S)
    # aux_sum totals per-(stage layer, microbatch, data shard, seq shard)
    # means; the full-batch equivalent is their mean over those.
    return ce + cfg.moe_aux_coef * aux_sum / (M * dsize * spsize)


class _OneFOneB(torch.autograd.Function):
    """The 1F1B schedule as one autograd node: the forward runs the whole
    schedule and keeps the grads it wrote out, the backward scales them by
    the cotangent of the loss (the reference's custom_vjp).  The grads are
    kept on ``ctx``, not saved for the backward: they are new tensors that
    no graph holds, and a saved-tensor hook (``saved_activations``) should
    not count them as activations."""

    @staticmethod
    def forward(ctx, run, *tensors):
        loss, ctx.grads = run(*tensors)
        return loss

    @staticmethod
    def backward(ctx, g):
        grads, ctx.grads = ctx.grads, None
        return (None, *(g.to(t.dtype) * t for t in grads))


def gpt_loss_1f1b(params: Params, batch, cfg: GPTConfig, mesh, *,
                  num_microbatches: int):
    """``gpt_loss_pipelined``'s value and gradients on the 1F1B schedule
    (activation memory O(pp)): the gradients come from the backward
    written out in ``one_f_one_b_spmd``, handed to autograd by
    ``_OneFOneB``, whose saved tensors are the gradients.  Dense or flash
    stages over dp/fsdp data sharding, as the reference's (the GPipe path
    takes pp x ep MoE and sp ring stages)."""
    M = num_microbatches
    if _use_ep(cfg, mesh):
        raise ValueError("1F1B does not compose with ep; use the GPipe "
                         "path (gpt_loss_pipelined)")
    toks = batch["tokens"]
    (cfg, B, S, dsize, _, params, x_mbs, tgt_mbs,
     layers) = _pipeline_setup(params, toks[:, :-1], toks[:, 1:], cfg, mesh,
                               M)
    if cfg.attention not in ("dense", "flash"):
        raise ValueError("1F1B supports dense/flash stages; ring/sp takes "
                         "the GPipe path (gpt_loss_pipelined)")
    all_axes = tuple(mesh.mesh_dim_names)
    repl = mesh.size() // (axis_size("pp", mesh) * dsize)
    # Cotangents of the final loss with respect to each microbatch's ll and
    # stage aux, this rank's partials divided by repl:
    # loss = -ll_total / (B S) + coef * aux_total / (M dsize).
    ll_cot = -1.0 / (B * S * repl)
    aux_cot = cfg.moe_aux_coef / (M * dsize * repl)
    head = _pipeline_head(params)
    n_layers = len(list(_leaves(layers)))

    def run(*tensors):
        lay = _tree_unflatten(layers, iter(tensors[:n_layers]))
        hd = _tree_unflatten(head, iter(tensors[n_layers:-1]))
        x = tensors[-1]
        with use_mesh(mesh):
            ll, aux, gl, gh, gx = one_f_one_b_spmd(
                _stage_block(cfg, mesh), _make_loss_mb(cfg), lay, hd, x,
                tgt_mbs, ll_cot=ll_cot, aux_cot=aux_cot)
            ll = psum_partials(ll / repl, all_axes)
            aux = psum_partials(aux / repl, all_axes)
        loss = -ll / (B * S) + cfg.moe_aux_coef * aux / (M * dsize)
        # accumulated in f32; the input's cotangent in its own dtype
        return loss, (*_leaves(gl), *_leaves(gh), gx.to(x.dtype))

    return _OneFOneB.apply(run, *_leaves(layers), *_leaves(head), x_mbs)


def make_pipeline_train_step(cfg: GPTConfig, optimizer, mesh, *,
                             num_microbatches: int) -> Callable:
    """``step(params, batch) -> {"loss", "grad_norm"}`` on the GPipe loss
    (``models.gpt.make_train_step``): every rank takes the same step with
    the whole gradient."""
    def loss_fn(params, batch):
        return gpt_loss_pipelined(params, batch, cfg, mesh,
                                  num_microbatches=num_microbatches)
    return make_train_step(cfg, optimizer, loss_fn=loss_fn)


def make_1f1b_train_step(cfg: GPTConfig, optimizer, mesh, *,
                         num_microbatches: int) -> Callable:
    """``make_pipeline_train_step`` on the 1F1B loss: the same step with
    O(pp) activation memory."""
    def loss_fn(params, batch):
        return gpt_loss_1f1b(params, batch, cfg, mesh,
                             num_microbatches=num_microbatches)
    return make_train_step(cfg, optimizer, loss_fn=loss_fn)


@dataclasses.dataclass
class SavedActivations:
    """Bytes of the tensors autograd holds for the backward: ``live`` now,
    ``peak`` the most at once (``saved_activations``)."""
    live: int = 0
    peak: int = 0


@contextlib.contextmanager
def saved_activations(params: Params) -> Iterator[SavedActivations]:
    """Count the bytes of the tensors saved for the backward inside the
    block, while they live (a saved tensor is freed with its graph), other
    than those sharing a parameter's storage: the activation memory a
    schedule keeps, device-independent."""
    stats = SavedActivations()
    owned = {t.untyped_storage().data_ptr() for t in _leaves(params)}

    class Held:
        __slots__ = ("t", "__weakref__")

        def __init__(self, t):
            self.t = t

    def release(n):
        stats.live -= n

    def pack(t):
        if t.untyped_storage().data_ptr() in owned:
            return t
        held, n = Held(t), t.numel() * t.element_size()
        stats.live += n
        stats.peak = max(stats.peak, stats.live)
        weakref.finalize(held, release, n)
        return held

    def unpack(x):
        return x.t if isinstance(x, Held) else x

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield stats


def schedule_activation_bytes(params: Params, batch, cfg: GPTConfig, mesh,
                              *, num_microbatches: int) -> Dict[str, float]:
    """The activation memory of each schedule's loss on ``batch``
    ({"gpipe": bytes, "1f1b": bytes}): the peak of the tensors its forward
    keeps for the backward (``saved_activations``), the most of any rank
    of ``mesh``; 1F1B's ring of 2pp stashed stage inputs, which it keeps
    outside autograd, added.  Collective over the mesh."""
    M = num_microbatches
    B, S = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    dsize = _check_pipeline_shapes(cfg, mesh, B, M)
    out = {}
    for name, fn in (("gpipe", gpt_loss_pipelined),
                     ("1f1b", gpt_loss_1f1b)):
        with saved_activations(params) as saved:
            fn(params, batch, cfg, mesh, num_microbatches=M)
        peak = torch.tensor(float(saved.peak), device=mesh.device_type)
        for group in _groups(mesh.mesh_dim_names, mesh):
            dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        out[name] = float(peak)
    stage_input = (B // M // dsize * S * cfg.embed_dim
                   * torch.finfo(cfg.dtype).bits // 8)
    out["1f1b"] += 2 * axis_size("pp", mesh) * stage_input
    return out


def dryrun_pipeline(n_devices: int, device_type: Optional[str] = None
                    ) -> str:
    """The dryrun twin's ``pipeline`` stage as one gang of ``n_devices``
    ranks (``ray_tpu_torch.dryrun``): GPipe dense and flash over pp x dp,
    MoE over pp x ep (n % 4 == 0), and 1F1B at M = 16 with both
    schedules' activation memory, each loss against the unpipelined
    one.  Returns its lines."""
    from ray_tpu_torch.dryrun import dryrun_multichip
    return dryrun_multichip(n_devices, device_type,
                            stages=["pipeline"])["pipeline"]

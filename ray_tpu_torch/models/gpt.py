"""GPT-2-class decoder-only transformer in PyTorch: training and inference.

Port of ``ray_tpu/models/gpt.py``: plain functions on tensors over a params
dict that keeps the reference's names and stacked ``[L]`` layout
(``wte [V,D]``, ``wpe [T,D]``, ``layers.attn.wqkv [L,D,3,N,H]``,
``layers.attn.wo [L,N,H,D]``, ...), so weights convert one to one.  Params
are f32; compute runs in ``cfg.dtype`` with each param cast before its add
or product and layer-norm statistics in f32, as in the reference.

Attention is head-major (``bnsh``): the qkv projection writes ``[B, 3, N,
S, H]`` and the flash kernels read ``qkv[:, 0..2]`` through strides.  The
layer loop is a Python loop over the stacked params (unbound once, so the
backward stacks each leaf's layer grads in one op).  The trunk is
differentiable: ``gpt_loss`` (full or blocked cross-entropy head),
per-block rematerialization (``cfg.remat``, four policies) and
``make_train_step`` (AdamW) are the training path; ``gpt_prefill`` and
``gpt_decode_step`` run under ``torch.inference_mode`` for serving.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.autotune.dispatch import choose
from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP, flash_attention
from ray_tpu_torch.ops.paged_attention import (append_kv, paged_attention,
                                               prefill_kv)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 padded to a multiple of 128
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16   # compute dtype (params stay f32)
    # Per-block rematerialization when training.  "full" recomputes the
    # whole block in the backward; "dots" saves the projection matmuls'
    # outputs; "attn" saves only the attention output (the flash forward
    # is not re-run); "attn_dots" saves both.
    remat: bool = True
    remat_policy: str = "full"   # "full" | "dots" | "attn" | "attn_dots"
    # "auto" takes the autotune cache's measured crossover record for the
    # shape when there is one, else flash at S >= 1024 (S % 128 == 0) on
    # a CUDA device and dense otherwise; "dense" and "flash" pin the
    # implementation.
    attention: str = "auto"
    # Sequence-block size of the blocked cross-entropy head (0 = the full
    # [B, S, V] logits).
    ce_block: int = 0
    # MoE fields of the reference; num_experts > 0 is not ported yet.
    num_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.mlp_ratio * self.embed_dim

    @staticmethod
    def gpt2_small() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def tiny(vocab: int = 256, seq: int = 128) -> "GPTConfig":
        return GPTConfig(vocab_size=vocab, max_seq_len=seq, num_layers=2,
                         num_heads=4, embed_dim=64)


def param_shapes(cfg: GPTConfig) -> Params:
    """The params tree as shapes: the one statement of the layout, shared
    by ``gpt_init`` and ``params_from_jax``."""
    if cfg.num_experts:
        raise NotImplementedError("MoE GPT (num_experts > 0) is not ported "
                                  "yet")
    D, H, M, L, V = (cfg.embed_dim, cfg.head_dim, cfg.mlp_dim,
                     cfg.num_layers, cfg.vocab_size)
    nh = cfg.num_heads

    def norm(*shape):
        return {"scale": shape, "bias": shape}

    return {
        "wte": (V, D),
        "wpe": (cfg.max_seq_len, D),
        "layers": {
            "ln1": norm(L, D),
            "attn": {"wqkv": (L, D, 3, nh, H), "wo": (L, nh, H, D),
                     "bo": (L, D)},
            "ln2": norm(L, D),
            "mlp": {"wi": (L, D, M), "bi": (L, M), "wo": (L, M, D),
                    "bo": (L, D)},
        },
        "ln_f": norm(D),
    }


def gpt_init(seed_or_generator: Union[int, torch.Generator], cfg: GPTConfig,
             device: DeviceLike = None) -> Params:
    """f32 params from a seed or a ``torch.Generator``.  Weights are drawn
    on the generator's device (the CPU for a seed) and moved to ``device``,
    so one seed gives the same weights on every device.  The draws differ
    from ``jax.random``'s: parity tests convert JAX params instead."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    normal = _normal_sampler(seed_or_generator, dev)
    scale = 0.02
    # residual-branch projections get the GPT-2 depth-scaled init
    rscale = scale / math.sqrt(2 * cfg.num_layers)

    def norm(shape):
        return {"scale": torch.ones(shape, device=dev),
                "bias": torch.zeros(shape, device=dev)}

    lay = shapes["layers"]
    return {
        "wte": normal(shapes["wte"], scale),
        "wpe": normal(shapes["wpe"], scale),
        "layers": {
            "ln1": norm(lay["ln1"]["scale"]),
            "attn": {
                "wqkv": normal(lay["attn"]["wqkv"], scale),
                "wo": normal(lay["attn"]["wo"], rscale),
                "bo": torch.zeros(lay["attn"]["bo"], device=dev),
            },
            "ln2": norm(lay["ln2"]["scale"]),
            "mlp": {
                "wi": normal(lay["mlp"]["wi"], scale),
                "bi": torch.zeros(lay["mlp"]["bi"], device=dev),
                "wo": normal(lay["mlp"]["wo"], rscale),
                "bo": torch.zeros(lay["mlp"]["bo"], device=dev),
            },
        },
        "ln_f": norm(shapes["ln_f"]["scale"]),
    }


def _normal_sampler(seed_or_generator: Union[int, torch.Generator],
                    device: torch.device) -> Callable:
    """``normal(shape, std)``: f32 draws from the generator (a new CPU one
    for a seed) on its own device, moved to ``device``."""
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return w.to(device)

    return normal


def _leaves(tree) -> Iterator[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _layers(params: Params, num_layers: int) -> List[Params]:
    """Each layer's slice of the stacked ``[L, ...]`` params (views from one
    ``unbind`` per leaf, whose backward is one ``stack``)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def take(tree, l):
        return {k: take(v, l) if isinstance(v, dict) else v[l]
                for k, v in tree.items()}

    stacked = split(params["layers"])
    return [take(stacked, l) for l in range(num_layers)]


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _dense_causal_attention_bnsh(q, k, v):
    """[B,N,S,H] (head-major) dense attention; causal mask, f32 softmax."""
    S = q.shape[2]
    scores = torch.einsum("bnqh,bnkh->bnqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None, None], scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bnkh->bnqh", probs, v)


def _flash_causal_attention_bnsh(q, k, v):
    return flash_attention(q, k, v, True, None, None, None, "bnsh")


def _auto_attention_variant(B: int, S: int, cfg: GPTConfig,
                            device: torch.device) -> str:
    """attention="auto": a measured crossover record of the autotune cache
    wins when one exists for this shape and device; a cold cache keeps
    the static rule, flash from S >= 1024 (S % 128 == 0) on a CUDA device
    and dense below and on the CPU (RT_AUTOTUNE_ON_MISS=inline tunes
    instead).  Only flash and dense are selectable here, as in the
    reference."""
    v, rec = choose(B, S, cfg.num_heads, cfg.head_dim, cfg.dtype,
                    causal=True, allowed=("flash", "dense"), device=device)
    if rec is not None:
        return v
    flash = S >= 1024 and S % 128 == 0 and device.type == "cuda"
    return "flash" if flash else "dense"


def _attention_fn(cfg: GPTConfig, B: int, S: int, device: torch.device):
    attention = cfg.attention
    if attention == "auto":
        attention = _auto_attention_variant(B, S, cfg, device)
    if attention == "flash":
        return _flash_causal_attention_bnsh
    if attention == "dense":
        return _dense_causal_attention_bnsh
    if attention == "ring":
        raise NotImplementedError("ring attention needs the parallel layer, "
                                  "which is not ported yet")
    raise ValueError(f"unknown attention {cfg.attention!r}")


def _mlp(cfg: GPTConfig, p: Params, x):
    dt = cfg.dtype
    h = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = torch.matmul(h, p["mlp"]["wi"].to(dt)) + p["mlp"]["bi"].to(dt)
    h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    h = torch.matmul(h, p["mlp"]["wo"].to(dt)) + p["mlp"]["bo"].to(dt)
    return x + h


def _qkv_bnsh(cfg: GPTConfig, p: Params, x):
    """ln1 then the fused qkv projection, as a [B, 3, N, S, H] view whose
    head dim is contiguous (what the flash kernel reads in place)."""
    B, S, D = x.shape
    h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    w = p["attn"]["wqkv"].to(cfg.dtype)                   # [D, 3, N, H]
    qkv = torch.matmul(h, w.reshape(D, -1)).view(B, S, *w.shape[1:])
    return qkv.permute(0, 2, 3, 1, 4)


def _block(cfg: GPTConfig, attn_fn, x, p: Params):
    """One transformer block (the reference's head-major branch).  Every
    projection is a 2-d matmul (``aten.mm``), which the ``dots`` remat
    policy saves."""
    dt = cfg.dtype
    qkv = _qkv_bnsh(cfg, p, x)
    o = attn_fn(qkv[:, 0], qkv[:, 1], qkv[:, 2])           # [B, N, S, H]
    B, N, S, H = o.shape
    o = torch.matmul(o.transpose(1, 2).reshape(B, S, N * H),
                     p["attn"]["wo"].to(dt).reshape(N * H, -1))
    x = x + o + p["attn"]["bo"].to(dt)
    return _mlp(cfg, p, x)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_SAVED_BY_POLICY = {"dots": _DOTS, "attn": (FLASH_FWD_OP,),
                    "attn_dots": _DOTS + (FLASH_FWD_OP,)}


def _remat_context_fn(policy: str) -> Callable:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
    (the reference's ``jax.checkpoint`` policies).  ``dots`` saves the
    outputs of matmuls without batch dims, as
    ``dots_with_no_batch_dims_saveable`` does; ``attn`` saves the flash
    forward's outputs (the reference saves the attention output by name).
    On the dense path, whose attention is not one op, ``attn`` saves
    nothing and ``attn_dots`` equals ``dots``: the grads are the same,
    only the recompute differs, and ``gpt_hidden`` warns."""
    if policy == "full":
        return noop_context_fn
    if policy not in _SAVED_BY_POLICY:
        raise ValueError(f"unknown remat_policy {policy!r}")
    saved = frozenset(_SAVED_BY_POLICY[policy])

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _remat(cfg, block: Callable, attn_fn: Callable, params: Params
           ) -> Callable:
    """``block`` under non-reentrant ``torch.utils.checkpoint`` with the
    policy's selective-checkpoint context when ``cfg.remat`` and autograd
    records (grad enabled and a param requires grad); else ``block``.
    Shared by the model families, whose configs carry the same remat
    fields."""
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(params))
    if not (cfg.remat and recording):
        return block
    if (cfg.remat_policy in ("attn", "attn_dots")
            and attn_fn is _dense_causal_attention_bnsh):
        warnings.warn(
            f"remat_policy={cfg.remat_policy!r} saves the flash "
            f"attention op's output; dense attention is several ops "
            f"and its output is recomputed, as under "
            f"{'full' if cfg.remat_policy == 'attn' else 'dots'!r}",
            UserWarning, stacklevel=3)
    return functools.partial(checkpoint, block, use_reentrant=False,
                             context_fn=_remat_context_fn(cfg.remat_policy))


def _embed(params: Params, cfg: GPTConfig, tokens, pos):
    # Gather, then cast: the same values as the reference's cast-then-gather
    # without casting the whole table.
    dt = cfg.dtype
    return params["wte"][tokens].to(dt) + params["wpe"][pos].to(dt)


def gpt_hidden(params: Params, tokens: torch.Tensor, cfg: GPTConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden [B, S, D] after ln_f in the compute
    dtype, moe aux loss 0.0).  Differentiable; when autograd records (grad
    enabled and a param requires grad) and ``cfg.remat``, each block runs
    under non-reentrant ``torch.utils.checkpoint`` with the policy's
    selective-checkpoint context."""
    B, S = tokens.shape
    if S > cfg.max_seq_len:
        raise ValueError(f"sequence {S} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    attn_fn = _attention_fn(cfg, B, S, tokens.device)
    block = _remat(cfg, functools.partial(_block, cfg, attn_fn), attn_fn,
                   params)
    pos = torch.arange(S, device=tokens.device)
    x = _embed(params, cfg, tokens, pos[None])
    for p in _layers(params, cfg.num_layers):
        x = block(x, p)
    x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return x, torch.zeros((), device=tokens.device)


def gpt_forward_with_aux(params: Params, tokens: torch.Tensor,
                         cfg: GPTConfig, keep_dtype: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], moe aux loss 0.0).  The logits
    are computed in the compute dtype and upcast to f32 unless
    ``keep_dtype`` (the loss upcasts inside its reductions)."""
    x, aux = gpt_hidden(params, tokens, cfg)
    logits = torch.matmul(x, params["wte"].to(cfg.dtype).t())
    return (logits if keep_dtype else logits.float()), aux


def gpt_forward(params: Params, tokens: torch.Tensor,
                cfg: GPTConfig) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (f32)."""
    return gpt_forward_with_aux(params, tokens, cfg)[0]


def token_loglikes(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """ll_i = logit[target_i] - logsumexp_i, in f32."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    z = (logits - m).float()
    lse = torch.log(torch.exp(z).sum(dim=-1)) + m[..., 0].float()
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return tgt.float() - lse


# ------------------------------------------------------------------ loss


def _chunk_loglike_sum(xc, head, tc, head_layout):
    w = head.t() if head_layout == "vd" else head
    return token_loglikes(torch.matmul(xc, w), tc).sum()


def blocked_ce_loglike_sum(x: torch.Tensor, head: torch.Tensor,
                           targets: torch.Tensor, block: int,
                           head_layout: str = "vd") -> torch.Tensor:
    """Sum of next-token loglikes with the head matmul and the CE fused per
    sequence chunk of ``block`` tokens, each chunk under non-reentrant
    ``torch.utils.checkpoint``: neither pass holds a [B, S, V] tensor, only
    one [B, block, V] chunk (the backward recomputes each chunk's logits).
    ``head_layout``: ``"vd"`` ([V, D], the tied GPT embedding) or ``"dv"``
    ([D, V], LLaMA's untied head).  A block that does not split S into
    several chunks falls back to the full logits with a
    ``RuntimeWarning``, or raises ``ValueError`` under
    ``RT_STRICT_CE_BLOCK=1``."""
    if head_layout not in ("vd", "dv"):
        raise ValueError(f"unknown head_layout {head_layout!r}")
    B, S, D = x.shape
    if S % block or S == block:
        msg = (f"ce_block={block} does not evenly split sequence length "
               f"S={S} into multiple chunks; falling back to full "
               f"[B={B}, S={S}, V] logits — the blocked head's memory "
               f"win is LOST. Pick ce_block so that S % ce_block == 0 "
               f"and ce_block < S.")
        if os.environ.get("RT_STRICT_CE_BLOCK") == "1":
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return _chunk_loglike_sum(x, head, targets, head_layout)
    total = torch.zeros((), device=x.device)
    for xc, tc in zip(x.split(block, dim=1), targets.split(block, dim=1)):
        total = total + checkpoint(_chunk_loglike_sum, xc, head, tc,
                                   head_layout, use_reentrant=False)
    return total


def gpt_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: GPTConfig) -> torch.Tensor:
    """Next-token cross-entropy, f32 scalar.  ``batch``: {"tokens": [B,
    S+1]}.  With ``cfg.ce_block`` the head and CE run blocked
    (``blocked_ce_loglike_sum``); otherwise over the full logits, kept in
    the compute dtype and upcast only inside ``token_loglikes``."""
    toks = batch["tokens"]
    inputs, targets = toks[:, :-1], toks[:, 1:]
    if cfg.ce_block:
        x, _ = gpt_hidden(params, inputs, cfg)
        ll = blocked_ce_loglike_sum(x, params["wte"].to(cfg.dtype), targets,
                                    cfg.ce_block, "vd")
        return -ll / targets.numel()
    logits, _ = gpt_forward_with_aux(params, inputs, cfg, keep_dtype=True)
    return -token_loglikes(logits, targets).mean()


# ------------------------------------------------------------ train step


def make_train_state(seed_or_generator: Union[int, torch.Generator],
                     cfg: GPTConfig, learning_rate: float = 3e-4,
                     weight_decay: float = 0.1, device: DeviceLike = None
                     ) -> Tuple[Params, torch.optim.AdamW]:
    """(params from ``gpt_init``, each set to require grad; AdamW over
    them), as ``optax.adamw(learning_rate, b1=0.9, b2=0.95, eps=1e-8,
    weight_decay=weight_decay)``: optax's ``p - lr * (m/(sqrt(v)+eps) +
    wd * p)`` and torch's ``p * (1 - lr * wd) - lr * m/(sqrt(v)+eps)`` are
    the same update.  ``weight_decay`` is passed to torch explicitly: its
    default (1e-2) is neither this function's (0.1) nor ``optax.adamw``'s
    (1e-4)."""
    return _adamw_state(gpt_init(seed_or_generator, cfg, device),
                        learning_rate, weight_decay)


def _adamw_state(params: Params, learning_rate: float, weight_decay: float
                 ) -> Tuple[Params, torch.optim.AdamW]:
    """(``params``, each set to require grad; AdamW over them with b2 0.95
    and eps 1e-8), the optimizer of every family's ``make_train_state``."""
    leaves = [p.requires_grad_(True) for p in _leaves(params)]
    return params, torch.optim.AdamW(leaves, lr=learning_rate,
                                     betas=(0.9, 0.95), eps=1e-8,
                                     weight_decay=weight_decay)


def make_train_step(cfg: GPTConfig, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None
                    ) -> Callable[[Params, Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """``step(params, batch) -> {"loss", "grad_norm"}``: one AdamW step of
    ``loss_fn(params, batch)`` (``gpt_loss`` when None), updating
    ``params`` (the tensors ``optimizer`` holds) in place.  ``grad_norm``
    is the global L2 norm of the gradients, not clipped
    (``optax.global_norm``).  The metrics stay on the device."""
    if loss_fn is None:
        def loss_fn(params, batch):
            return gpt_loss(params, batch, cfg)

    def step(params: Params, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        tokens = batch["tokens"].to(params["wte"].device)
        loss = loss_fn(params, {"tokens": tokens})
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in _leaves(params)])
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


# --------------------------------------------------------- paged decode
#
# Serving path (ray_tpu_torch.serve.engine): decode reads K/V from the
# paged pools of ops/paged_attention.py instead of re-running the prefix.
# The math mirrors _block exactly, so with cfg.dtype=float32 the paged
# greedy decode reproduces gpt_forward's argmax token for token.  The pools
# are updated in place; the functions still return them.


def init_paged_cache(cfg: GPTConfig, num_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed per-layer K/V page pools, [L, N, P, page, H].  Page 0 is the
    scratch sink for padded and inactive writes."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_heads, num_pages, page_size,
             cfg.head_dim)
    dt = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def gpt_prefill(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                length, k_pages: torch.Tensor, v_pages: torch.Tensor,
                page_table: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill ONE padded sequence: run the trunk with dense attention,
    scatter every layer's K/V into the sequence's pages, and return
    (next-token logits [1, V] f32, k_pages, v_pages).

    ``tokens`` [1, S] (S a multiple of the page size, S <= max_seq_len),
    ``length`` the true length (1 <= length <= S), ``page_table`` [1,
    maxp].  Padding positions write scratch page 0 and, being causal,
    never influence positions < length."""
    B, S = tokens.shape
    length = int(length)
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside [1, {S}]")
    dt = cfg.dtype
    with torch.inference_mode():
        x = _embed(params, cfg, tokens,
                   torch.arange(S, device=tokens.device)[None])
        for l, p in enumerate(_layers(params, cfg.num_layers)):
            qkv = _qkv_bnsh(cfg, p, x)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]       # [B, N, S, H]
            prefill_kv(k_pages[l], v_pages[l], k[0], v[0], length,
                       page_table[0])
            o = _dense_causal_attention_bnsh(q, k, v)
            o = torch.einsum("bnsh,nhd->bsd", o, p["attn"]["wo"].to(dt))
            x = x + o + p["attn"]["bo"].to(dt)
            x = _mlp(cfg, p, x)
        x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        last = x[0, length - 1]                              # [D]
        logits = torch.matmul(params["wte"].to(dt), last).float()
    return logits[None], k_pages, v_pages


def gpt_decode_step(params: Params, cfg: GPTConfig, token: torch.Tensor,
                    pos: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for a BATCH of sequences against the paged cache.

    ``token`` [B] current tokens, ``pos`` [B] their positions (each below
    max_seq_len), ``page_table`` [B, maxp].  Writes each token's K/V at
    ``pos`` then attends positions [0, pos].  Inactive slots (pos 0,
    all-zero table row) churn scratch page 0.  Returns (next-token logits
    [B, V] f32, k_pages, v_pages)."""
    dt = cfg.dtype
    with torch.inference_mode():
        x = _embed(params, cfg, token, pos)
        for l, p in enumerate(_layers(params, cfg.num_layers)):
            h = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
            qkv = torch.einsum("bd,dcnh->bcnh", h, p["attn"]["wqkv"].to(dt))
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [B, N, H]
            append_kv(k_pages[l], v_pages[l], k_new, v_new, pos, page_table)
            o = paged_attention(q, k_pages[l], v_pages[l], pos + 1,
                                page_table)
            o = torch.einsum("bnh,nhd->bd", o, p["attn"]["wo"].to(dt))
            x = x + o + p["attn"]["bo"].to(dt)
            x = _mlp(cfg, p, x)
        x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
        logits = torch.matmul(x, params["wte"].to(dt).t()).float()
    return logits, k_pages, v_pages

"""LLaMA-family decoder-only transformer in PyTorch: training and inference.

Port of ``ray_tpu/models/llama.py``: RMSNorm pre-norm, rotary position
embeddings (split-halves convention, no learned positions), a SwiGLU MLP,
grouped-query attention (``num_kv_heads`` divides ``num_heads``) and an
untied LM head.  Same construction as the port's GPT (``models/gpt.py``):
plain functions over a params dict that keeps the reference's names and
stacked ``[L]`` layout (``param_shapes``), f32 params cast to
``cfg.dtype`` before each product, a Python loop over the layers, the same
remat policies and attention choice, and the paged prefill/decode entry
points the serving engine drives.

Every projection is a 2-d ``torch.matmul`` on a reshaped weight
(``aten.mm``), so the ``dots`` remat policy saves it.  On the flash path
K/V are repeated up to the query heads (``repeat_interleave``: query head
n reads KV head ``n // rep``) and materialised, as the reference's
``jnp.repeat``; the dense path groups the query heads instead, so K/V stay
at ``num_kv_heads`` width.  The paged pools are ``[L, NKV, P, page, H]``
and hold keys after RoPE.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt as _gpt
from ray_tpu_torch.models.gpt import (Params, _attention_fn,
                                      _dense_causal_attention_bnsh, _layers,
                                      _normal_sampler, _remat,
                                      blocked_ce_loglike_sum, token_loglikes)
from ray_tpu_torch.ops.paged_attention import (append_kv, paged_attention,
                                               prefill_kv)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 4            # GQA: kv_heads < heads shares K/V
    embed_dim: int = 768
    mlp_dim: int = 2048              # SwiGLU hidden (~8/3 * embed, /128 pad)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # compute dtype (params stay f32)
    remat: bool = True
    remat_policy: str = "full"       # the same menu as GPTConfig
    attention: str = "auto"          # "auto" | "dense" | "flash"
    ce_block: int = 0                # blocked-CE chunk (see GPTConfig)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @staticmethod
    def llama_125m() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab: int = 256, seq: int = 128) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab, max_seq_len=seq, num_layers=2,
                           num_heads=4, num_kv_heads=2, embed_dim=64,
                           mlp_dim=192)


def param_shapes(cfg: LlamaConfig) -> Params:
    """The params tree as shapes: the one statement of the layout, shared
    by ``llama_init`` and ``params_from_jax``."""
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"num_heads={cfg.num_heads} must be divisible by "
                         f"num_kv_heads={cfg.num_kv_heads}")
    D, H, M, L, V = (cfg.embed_dim, cfg.head_dim, cfg.mlp_dim,
                     cfg.num_layers, cfg.vocab_size)
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wte": (V, D),
        "layers": {
            "ln1": {"scale": (L, D)},
            "attn": {"wq": (L, D, nh, H), "wkv": (L, D, 2, nkv, H),
                     "wo": (L, nh, H, D)},
            "ln2": {"scale": (L, D)},
            # SwiGLU: gate and up projections on a leading 2-dim.
            "mlp": {"wgu": (L, 2, D, M), "wd": (L, M, D)},
        },
        "ln_f": {"scale": (D,)},
        "lm_head": (D, V),
    }


def llama_init(seed_or_generator: Union[int, torch.Generator],
               cfg: LlamaConfig, device: DeviceLike = None) -> Params:
    """f32 params from a seed or a ``torch.Generator`` (drawn on the
    generator's device and moved, as ``gpt_init``), with the reference's
    stds: 0.02, and 0.02 / sqrt(2L) for ``wo`` and ``wd``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    normal = _normal_sampler(seed_or_generator, dev)
    scale = 0.02
    rscale = scale / math.sqrt(2 * cfg.num_layers)
    lay = shapes["layers"]
    return {
        "wte": normal(shapes["wte"], scale),
        "layers": {
            "ln1": {"scale": torch.ones(lay["ln1"]["scale"], device=dev)},
            "attn": {
                "wq": normal(lay["attn"]["wq"], scale),
                "wkv": normal(lay["attn"]["wkv"], scale),
                "wo": normal(lay["attn"]["wo"], rscale),
            },
            "ln2": {"scale": torch.ones(lay["ln2"]["scale"], device=dev)},
            "mlp": {
                "wgu": normal(lay["mlp"]["wgu"], scale),
                "wd": normal(lay["mlp"]["wd"], rscale),
            },
        },
        "ln_f": {"scale": torch.ones(shapes["ln_f"]["scale"], device=dev)},
        "lm_head": normal(shapes["lm_head"], scale),
    }


def _rms_norm(x, scale, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


@functools.lru_cache(maxsize=32)
def rope_tables(S: int, H: int, theta: float,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [S, H/2] f32 tables for rotary embeddings, built in numpy
    as the reference builds them (so the tables are bitwise the same), on
    ``device``.  Cached (each decode step reads the max_seq_len tables) and
    shared, so callers must not write to them; made outside inference mode,
    so the serving path's tables can also serve autograd."""
    inv_freq = 1.0 / theta ** (np.arange(0, H, 2, dtype=np.float32) / H)
    t = np.arange(S, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    with torch.inference_mode(False):
        return (torch.from_numpy(np.cos(freqs)).to(device),
                torch.from_numpy(np.sin(freqs)).to(device))


def apply_rope(x, cos, sin):
    """Rotate the pairs (i, i + H/2) of x [..., S, H] (the split-halves
    convention); cos/sin broadcast over the leading dims.  A bf16 ``x``
    is rotated in f32 against the f32 tables and cast back at the end."""
    H = x.shape[-1]
    x1, x2 = x[..., : H // 2], x[..., H // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _dense_causal_attention_gqa(q, k, v, rep: int):
    """Head-major grouped-query dense attention: q [B, N, S, H] with
    N = G*rep query heads sharing k/v [B, G, S, H] (query head n reads KV
    head n // rep).  Scores and output keep the (group, rep) split, so K/V
    are never repeated; f32 softmax."""
    B, N, S, H = q.shape
    G = N // rep
    qg = q.reshape(B, G, rep, S, H)
    scores = torch.einsum("bgrqh,bgkh->bgrqk", qg, k).float() / math.sqrt(H)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bgrqk,bgkh->bgrqh", probs, v)
    return o.reshape(B, N, S, H)


def _qkv(cfg: LlamaConfig, p: Params, x):
    """ln1 and the projections of x [..., D]: q [..., N, H], k and v
    [..., NKV, H] (views of one product), before RoPE."""
    dt = cfg.dtype
    D, N, NKV, H = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    h = _rms_norm(x, p["ln1"]["scale"], cfg.rms_eps)
    q = torch.matmul(h, p["attn"]["wq"].to(dt).reshape(D, N * H))
    kv = torch.matmul(h, p["attn"]["wkv"].to(dt).reshape(D, 2 * NKV * H))
    kv = kv.unflatten(-1, (2, NKV, H))
    return q.unflatten(-1, (N, H)), kv[..., 0, :, :], kv[..., 1, :, :]


def _attn_out(cfg: LlamaConfig, p: Params, x, o):
    """x plus the output projection of the attention output o [..., N, H]."""
    N, H = cfg.num_heads, cfg.head_dim
    wo = p["attn"]["wo"].to(cfg.dtype).reshape(N * H, -1)
    return x + torch.matmul(o.reshape(*o.shape[:-2], N * H), wo)


def _mlp(cfg: LlamaConfig, p: Params, x):
    """x plus ln2 and the SwiGLU MLP, gate and up as two products."""
    dt = cfg.dtype
    h = _rms_norm(x, p["ln2"]["scale"], cfg.rms_eps)
    w_gate, w_up = p["mlp"]["wgu"].to(dt).unbind(0)
    h = F.silu(torch.matmul(h, w_gate)) * torch.matmul(h, w_up)
    return x + torch.matmul(h, p["mlp"]["wd"].to(dt))


def _qkv_bnsh(cfg: LlamaConfig, p: Params, x, cos, sin):
    """q [B, N, S, H] and k, v [B, NKV, S, H] of x [B, S, D], q and k after
    RoPE."""
    q, k, v = (t.transpose(1, 2) for t in _qkv(cfg, p, x))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _block(cfg: LlamaConfig, attn_fn, cos, sin, x, p: Params):
    rep = cfg.num_heads // cfg.num_kv_heads
    q, k, v = _qkv_bnsh(cfg, p, x, cos, sin)
    if rep > 1 and attn_fn is _dense_causal_attention_bnsh:
        o = _dense_causal_attention_gqa(q, k, v, rep)
    else:
        if rep > 1:   # the flash kernels take equal head counts
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        o = attn_fn(q, k, v)
    x = _attn_out(cfg, p, x, o.transpose(1, 2))
    return _mlp(cfg, p, x)


def llama_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
                 ) -> torch.Tensor:
    """tokens [B, S] -> final hidden [B, S, D] after the last RMSNorm, in
    the compute dtype: the trunk without the LM head.  Differentiable,
    with per-block remat as ``gpt_hidden``."""
    B, S = tokens.shape
    attn_fn = _attention_fn(cfg, B, S, tokens.device)
    cos, sin = rope_tables(S, cfg.head_dim, cfg.rope_theta, tokens.device)
    block = _remat(cfg, functools.partial(_block, cfg, attn_fn, cos, sin),
                   attn_fn, params)
    x = params["wte"][tokens].to(cfg.dtype)
    for p in _layers(params, cfg.num_layers):
        x = block(x, p)
    return _rms_norm(x, params["ln_f"]["scale"], cfg.rms_eps)


def llama_forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
                  ) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in the compute dtype (as the
    reference's; the loss upcasts inside its reductions)."""
    x = llama_hidden(params, tokens, cfg)
    return torch.matmul(x, params["lm_head"].to(cfg.dtype))


def llama_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy over {"tokens": [B, S+1]}, f32 scalar:
    blocked over the untied ``[D, V]`` head (``"dv"``) with
    ``cfg.ce_block``, else over the full logits."""
    toks = batch["tokens"]
    inputs, targets = toks[:, :-1], toks[:, 1:]
    if cfg.ce_block:
        x = llama_hidden(params, inputs, cfg)
        ll = blocked_ce_loglike_sum(x, params["lm_head"].to(cfg.dtype),
                                    targets, cfg.ce_block, "dv")
        return -ll / targets.numel()
    return -token_loglikes(llama_forward(params, inputs, cfg),
                           targets).mean()


def make_train_state(seed_or_generator: Union[int, torch.Generator],
                     cfg: LlamaConfig, learning_rate: float = 3e-4,
                     weight_decay: float = 0.1, device: DeviceLike = None
                     ) -> Tuple[Params, torch.optim.AdamW]:
    """(params from ``llama_init``, each set to require grad; AdamW over
    them) with GPT's settings (``models.gpt.make_train_state``)."""
    return _gpt._adamw_state(llama_init(seed_or_generator, cfg, device),
                             learning_rate, weight_decay)


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer):
    """``step(params, batch) -> {"loss", "grad_norm"}``: GPT's train step
    (``models.gpt.make_train_step``) with this family's loss."""
    return _gpt.make_train_step(
        cfg, optimizer, loss_fn=lambda p, b: llama_loss(p, b, cfg))


# --------------------------------------------------------- paged decode
#
# The LLaMA variant of gpt.py's paged entry points.  GQA makes the pools
# NKV-head-major; RoPE rotates each key at its absolute position before it
# is written, so the pools hold keys after RoPE and decode attention is a
# plain dot against them.  The math mirrors _block's grouped dense branch:
# with cfg.dtype=float32 the paged greedy decode reproduces llama_forward's
# argmax token for token.  The pools are updated in place; the functions
# still return them.


def llama_init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                           dtype: Optional[torch.dtype] = None,
                           device: DeviceLike = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed per-layer K/V page pools, [L, NKV, P, page, H].  Page 0 is
    the scratch sink for padded and inactive writes."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size,
             cfg.head_dim)
    dt = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def llama_prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                  length, k_pages: torch.Tensor, v_pages: torch.Tensor,
                  page_table: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill ONE padded sequence (see ``gpt_prefill``): the trunk with
    grouped dense attention, every layer's K (after RoPE over [0, S)) and V
    scattered into the sequence's pages, and (next-token logits [1, V]
    f32, k_pages, v_pages).  ``tokens`` [1, S] with S a multiple of the
    page size, ``page_table`` [1, maxp]."""
    B, S = tokens.shape
    length = int(length)
    if not 1 <= length <= S:
        raise ValueError(f"length {length} outside [1, {S}]")
    dt = cfg.dtype
    rep = cfg.num_heads // cfg.num_kv_heads
    with torch.inference_mode():
        cos, sin = rope_tables(S, cfg.head_dim, cfg.rope_theta,
                               tokens.device)
        x = params["wte"][tokens].to(dt)
        for l, p in enumerate(_layers(params, cfg.num_layers)):
            q, k, v = _qkv_bnsh(cfg, p, x, cos, sin)    # k, v [B, NKV, S, H]
            prefill_kv(k_pages[l], v_pages[l], k[0], v[0], length,
                       page_table[0])
            o = _dense_causal_attention_gqa(q, k, v, rep)
            x = _mlp(cfg, p, _attn_out(cfg, p, x, o.transpose(1, 2)))
        x = _rms_norm(x, params["ln_f"]["scale"], cfg.rms_eps)
        last = x[0, length - 1]                              # [D]
        logits = torch.matmul(last, params["lm_head"].to(dt)).float()
    return logits[None], k_pages, v_pages


def llama_decode_step(params: Params, cfg: LlamaConfig, token: torch.Tensor,
                      pos: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_table: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for a BATCH of sequences (see ``gpt_decode_step``).
    ``token``/``pos`` [B]: RoPE rotates q and the new K at each sequence's
    ``pos`` (below max_seq_len) before the K/V are written; the paged
    attention groups the query heads, so K/V stay at NKV width.  Returns
    (next-token logits [B, V] f32, k_pages, v_pages)."""
    dt = cfg.dtype
    with torch.inference_mode():
        cos_t, sin_t = rope_tables(cfg.max_seq_len, cfg.head_dim,
                                   cfg.rope_theta, token.device)
        cos, sin = cos_t[pos][:, None], sin_t[pos][:, None]  # [B, 1, H/2]
        x = params["wte"][token].to(dt)
        for l, p in enumerate(_layers(params, cfg.num_layers)):
            q, k_new, v_new = _qkv(cfg, p, x)            # [B, N|NKV, H]
            q, k_new = apply_rope(q, cos, sin), apply_rope(k_new, cos, sin)
            append_kv(k_pages[l], v_pages[l], k_new, v_new, pos, page_table)
            o = paged_attention(q, k_pages[l], v_pages[l], pos + 1,
                                page_table)
            x = _mlp(cfg, p, _attn_out(cfg, p, x, o))
        x = _rms_norm(x, params["ln_f"]["scale"], cfg.rms_eps)
        logits = torch.matmul(x, params["lm_head"].to(dt)).float()
    return logits, k_pages, v_pages

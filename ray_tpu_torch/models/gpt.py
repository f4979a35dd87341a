"""GPT-2-class decoder-only transformer, inference side, in PyTorch.

Port of ``ray_tpu/models/gpt.py``: plain functions on tensors over a params
dict that keeps the reference's names and stacked ``[L]`` layout
(``wte [V,D]``, ``wpe [T,D]``, ``layers.attn.wqkv [L,D,3,N,H]``,
``layers.attn.wo [L,N,H,D]``, ...), so weights convert one to one.  Params
are f32; compute runs in ``cfg.dtype`` with each param cast before its add
or product and layer-norm statistics in f32, as in the reference.

Attention is head-major (``bnsh``): the qkv projection writes ``[B, 3, N,
S, H]`` and the flash kernel reads ``qkv[:, 0..2]`` through strides.  The
layer loop is a Python loop over the stacked params under
``torch.inference_mode``; training (remat, blocked cross-entropy, the
optimizer step) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.ops.flash_attention import flash_attention
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
    # Kept for parity with the reference config; inference does not use them.
    remat: bool = True
    remat_policy: str = "full"
    # "auto" picks flash at S >= 1024 (S % 128 == 0) on a CUDA device and
    # dense otherwise; "dense" and "flash" pin the implementation.
    attention: str = "auto"
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
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed_or_generator))
    scale = 0.02
    # residual-branch projections get the GPT-2 depth-scaled init
    rscale = scale / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std
        return w.to(dev)

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


def _layer(params: Params, l: int) -> Params:
    """Layer ``l``'s slice of the stacked ``[L, ...]`` params (views)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[l]
                for k, v in tree.items()}
    return take(params["layers"])


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


def _attention_fn(cfg: GPTConfig, S: int, device: torch.device):
    attention = cfg.attention
    if attention == "auto":
        # The reference's static rule (the autotune lookup is not ported):
        # flash from S >= 1024 on a device, dense below and on the CPU.
        flash = S >= 1024 and S % 128 == 0 and device.type == "cuda"
        attention = "flash" if flash else "dense"
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
    """One transformer block (the reference's head-major branch)."""
    dt = cfg.dtype
    qkv = _qkv_bnsh(cfg, p, x)
    o = attn_fn(qkv[:, 0], qkv[:, 1], qkv[:, 2])
    o = torch.einsum("bnsh,nhd->bsd", o, p["attn"]["wo"].to(dt))
    x = x + o + p["attn"]["bo"].to(dt)
    return _mlp(cfg, p, x)


def _embed(params: Params, cfg: GPTConfig, tokens, pos):
    # Gather, then cast: the same values as the reference's cast-then-gather
    # without casting the whole table.
    dt = cfg.dtype
    return params["wte"][tokens].to(dt) + params["wpe"][pos].to(dt)


def gpt_hidden(params: Params, tokens: torch.Tensor, cfg: GPTConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final hidden [B, S, D] after ln_f in the compute
    dtype, moe aux loss 0.0)."""
    B, S = tokens.shape
    if S > cfg.max_seq_len:
        raise ValueError(f"sequence {S} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    attn_fn = _attention_fn(cfg, S, tokens.device)
    with torch.inference_mode():
        pos = torch.arange(S, device=tokens.device)
        x = _embed(params, cfg, tokens, pos[None])
        for l in range(cfg.num_layers):
            x = _block(cfg, attn_fn, x, _layer(params, l))
        x = _layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return x, torch.zeros((), device=tokens.device)


def gpt_forward_with_aux(params: Params, tokens: torch.Tensor,
                         cfg: GPTConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, moe aux loss 0.0).  The
    logits are computed in the compute dtype, then upcast."""
    x, aux = gpt_hidden(params, tokens, cfg)
    with torch.inference_mode():
        logits = torch.matmul(x, params["wte"].to(cfg.dtype).t()).float()
    return logits, aux


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
        for l in range(cfg.num_layers):
            p = _layer(params, l)
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
        for l in range(cfg.num_layers):
            p = _layer(params, l)
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

"""The benchmark's frozen arithmetic: the card's peaks, the bound of a flash
attention function, model FLOPs per training token, MoE capacity, and the
work of one serving step.  Every formula is written beside its code; the
numbers are copied from ``chip_smoke.py`` and held to ``PERF.md``'s figures by
``tests/test_perfbench_arith.py``.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# (tensors of [B, N, S, H], f32 [B*N, S] statistics, products) each flash
# function must move or do: fwd q k v o, lse, q.k^T and p.v; dq q k v dO dQ,
# lse and D, q.k^T, dO.v^T and dS.k; dkv q k v dO dK dV, lse and D, q.k^T,
# dO.v^T, P^T.dO and dS^T.q.
FLASH_WORK = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}


def flash_bound_s(B: int, N: int, S: int, H: int, dtype: str, causal: bool,
                  kind: str = "fwd") -> Tuple[float, str]:
    """Least time of one flash function: each input and output moved once
    over the memory rate, or the products these inputs need (causal: key
    j <= row i only, S (S + 1) / 2 pairs) over the tensor-core rate of the
    dtype, whichever is larger; and which of the two it is."""
    tensors, stats, products = FLASH_WORK[kind]
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * B * N * S * H * elem + stats * B * N * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = products * 2 * H * pairs * B * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_step_bound_s(B: int, N: int, S: int, H: int, L: int) -> float:
    """Bound of one training step's attention: one forward and one
    backward (dq and dk/dv) a layer, bf16, causal.  A forward the remat
    policy runs again counts in the time, not in the work."""
    return L * sum(flash_bound_s(B, N, S, H, "bfloat16", True, kind)[0]
                   for kind in FLASH_WORK)


def moe_capacity(S: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert and batch row (GShard): int(cf * S * k / E), at
    least 1."""
    return max(1, int(capacity_factor * S * top_k / num_experts))


def dense_mflop_per_token(n_params: int, L: int, S: int, D: int) -> float:
    """Model FLOPs per training token, 6 N + 12 L S D (N every param)."""
    return (6 * n_params + 12 * L * S * D) / 1e6


def moe_mflop_per_token(n_params: int, L: int, S: int, D: int, M: int,
                        E: int, k: int) -> float:
    """Model FLOPs per training token of an MoE GPT by the params a token
    uses: 6 (N - L (E - k) P) + 12 L S D, P = 2 D M + M + D the params of
    one expert (every non-expert param and k experts a layer)."""
    per_expert = 2 * D * M + M + D
    n_active = n_params - L * (E - k) * per_expert
    return (6 * n_active + 12 * L * S * D) / 1e6


def train_mflop_per_token(model: Dict, S: int, n_params: int) -> float:
    """Model FLOPs per token of the configuration ``model`` (the harness's
    sizes, ``weights.sizes``) at sequence length S."""
    L, D = model["num_layers"], model["embed_dim"]
    if model["num_experts"]:
        return moe_mflop_per_token(n_params, L, S, D, model["mlp_dim"],
                                   model["num_experts"],
                                   model["expert_top_k"])
    return dense_mflop_per_token(n_params, L, S, D)


def serve_weight_bytes(model: Dict) -> int:
    """Bytes of the weights one decode step or prefill reads once at the
    configuration's bf16: every param but the position table, of which a
    step reads a row a token."""
    L, D, M, V = (model["num_layers"], model["embed_dim"], model["mlp_dim"],
                  model["vocab_size"])
    per_layer = 3 * D * D + D * D + D + 2 * D * M + M + D + 4 * D
    return 2 * (V * D + L * per_layer + 2 * D)


def _matmul_flops_per_token(model: Dict) -> int:
    """2 x the params of the trunk's products a token passes through:
    qkv (3 D^2), the output projection (D^2), the MLP (2 D M) a layer."""
    L, D, M = model["num_layers"], model["embed_dim"], model["mlp_dim"]
    return 2 * L * (4 * D * D + 2 * D * M)


def decode_step_work(model: Dict, contexts: Iterable[int]
                     ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one batched decode step whose live slots attend
    ``contexts`` keys each (the new token's included).  FLOPs per slot:
    the trunk's products, the head (2 V D), and q.k^T and p.v over its
    keys (4 L D c).  Bytes: the weights once, each live key and value
    once, and the new key and value written (bf16)."""
    L, D, V = model["num_layers"], model["embed_dim"], model["vocab_size"]
    ctx = list(contexts)
    per_slot = _matmul_flops_per_token(model) + 2 * V * D
    flops = len(ctx) * per_slot + 4 * L * D * sum(ctx)
    kv = 2 * L * D * 2
    nbytes = serve_weight_bytes(model) + kv * sum(ctx) + kv * len(ctx)
    return float(flops), float(nbytes)


def prefill_work(model: Dict, length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill of a prompt of its true ``length``
    (padding not counted): the trunk's products for every token, causal
    q.k^T and p.v (4 L D P (P + 1) / 2), the head for the last token; the
    weights once and the prompt's keys and values written (bf16)."""
    L, D, V = model["num_layers"], model["embed_dim"], model["vocab_size"]
    P = length
    flops = (P * _matmul_flops_per_token(model) + 2 * V * D
             + 4 * L * D * P * (P + 1) // 2)
    nbytes = serve_weight_bytes(model) + 2 * L * D * 2 * P
    return float(flops), float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """Least time of a piece of bf16 work: the larger of its operations
    over the tensor-core rate and its bytes over the memory rate."""
    return max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES_PER_S)

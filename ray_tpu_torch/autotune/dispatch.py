"""Measured kernel-variant dispatch for attention (port of
``ray_tpu/autotune/dispatch.py``).

``attention(q, k, v, ...)`` picks splash vs flash vs dense per shape from
MEASURED timings: ``tune_attention`` times every applicable variant (each
with its own tuned config) and persists the winner as an
``attention_variant`` record in the autotune cache; ``attention``
consults that record, through a process-local L1 memo so the cache is
touched once per shape, and runs the winning variant.  The tensors'
device takes the place of the reference's ``interpret`` flag: the plain
versions on the CPU, the Hopper kernels on the card.

On a cache miss the behavior is set by ``RT_AUTOTUNE_ON_MISS``:

* ``default``: the static heuristic the models used before the
  subsystem existed (flash at S >= 1024 on the card, dense otherwise),
  the miss counted once;
* ``inline``: tune on first use under a budget (``RT_AUTOTUNE_BUDGET_S``,
  default 30 s per shape) and persist;
* offline: ``python -m ray_tpu_torch.autotune.sweep`` once per fleet.

``mesh`` (a ``DeviceMesh`` with an ``sp`` dim larger than 1) makes the
ring variant applicable at causal shapes whose S it divides; every rank of
the mesh must make the same calls.  The ring variant's output is a
DTensor split over the mesh (``.full_tensor()`` gathers it).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.autotune import metrics as _am
from ray_tpu_torch.autotune import search as _search
from ray_tpu_torch.autotune.cache import (attention_key, backend_fingerprint,
                                          canon_dtype, get_cache)
from ray_tpu_torch.ops.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from ray_tpu_torch.ops.flash_attention import _dense_reference, flash_attention
from ray_tpu_torch.ops.ring_attention import make_ring_attention_fn
from ray_tpu_torch.ops.splash_attention import (causal_mha_mask,
                                                process_mask,
                                                splash_attention)

VARIANT_OP = "attention_variant"

# Variant op-name in the cache, per selectable variant.
_VARIANT_OPS = {"flash": "flash_attention", "dense": "dense_attention",
                "ring": "ring_attention", "splash": "splash_attention"}

# L1 memo: (backend, key, allowed) -> chosen variant str or None (miss).
_MEMO: Dict[Tuple[str, str, tuple], Optional[str]] = {}
_memo_lock = threading.Lock()


def on_miss_mode() -> str:
    return os.environ.get("RT_AUTOTUNE_ON_MISS", "default").strip().lower()


def _budget_s() -> float:
    return float(os.environ.get("RT_AUTOTUNE_BUDGET_S") or 30.0)


def clear_memo() -> None:
    """Test hook: drop the process-local variant memo."""
    with _memo_lock:
        _MEMO.clear()


# -------------------------------------------------------- applicability

def _flash_ok(kd: dict, device: torch.device) -> bool:
    if device.type == "cpu":
        return kd["S"] >= 2
    return kd["H"] in FLASH_HEAD_DIMS


def applicable_variants(kd: dict, device: torch.device,
                        mesh=None) -> List[str]:
    """Which variants can run at this shape on this device (and mesh).
    Order is the tie-break preference (earlier wins on equal timings)."""
    out = ["dense"]
    if _flash_ok(kd, device):
        out.insert(0, "flash")
    if _search.splash_supported(kd, device):
        out.insert(0, "splash")
    if mesh is not None and kd.get("causal", True) and _ring_ok(kd, mesh):
        out.append("ring")
    return out


def _ring_ok(kd: dict, mesh) -> bool:
    names = list(mesh.mesh_dim_names or ())
    sp = mesh.size(names.index("sp")) if "sp" in names else 1
    return sp > 1 and kd["S"] % sp == 0


# --------------------------------------------------------------- choice

def choose_variant_from_timings(timings: Dict[str, Optional[float]],
                                allowed: Optional[Tuple[str, ...]] = None
                                ) -> Optional[str]:
    """Pure crossover policy: the cheapest measured variant wins; variants
    that did not run (None/inf) never win; ``allowed`` filters."""
    best, best_ms = None, float("inf")
    for v, ms in timings.items():
        if allowed is not None and v not in allowed:
            continue
        if ms is None or ms != ms or ms == float("inf"):
            continue
        if ms < best_ms:
            best, best_ms = v, ms
    return best


def _heuristic_variant(S: int, allowed: Tuple[str, ...],
                       device: torch.device) -> str:
    """The pre-autotune static policy (the models' rule): flash once the
    sequence is long and 128-aligned on a CUDA device, else dense."""
    if ("flash" in allowed and S >= 1024 and S % 128 == 0
            and device.type == "cuda"):
        return "flash"
    return "dense" if "dense" in allowed else allowed[0]


def choose(B: int, S: int, N: int, H: int, dtype: Any, causal: bool = True,
           allowed: Optional[Tuple[str, ...]] = None,
           device=None, mesh=None) -> Tuple[str, Optional[dict]]:
    """Pick the attention variant for a shape on ``device`` (default: the
    card).

    Returns (variant, variant_record_or_None).  Consults the L1 memo, then
    the persistent cache's ``attention_variant`` record, then the on-miss
    policy."""
    dev = resolve_device(device)
    kd = {"B": B, "S": S, "N": N, "H": H,
          "dtype": canon_dtype(dtype), "causal": bool(causal)}
    avail = applicable_variants(kd, dev, mesh)
    if allowed is not None:
        avail = [v for v in avail if v in allowed]
    if not avail:
        return "dense", None
    allowed_t = tuple(avail)
    key = attention_key(B, S, N, H, dtype, causal)
    backend = backend_fingerprint(dev)
    memo_key = (backend, key, allowed_t)
    with _memo_lock:
        hit = _MEMO.get(memo_key, _MEMO)       # sentinel: _MEMO itself
    cache = get_cache()
    if hit is not _MEMO:
        if hit is not None:
            return hit, cache.lookup(VARIANT_OP, key, backend=backend,
                                     count=False)
    else:
        rec = cache.lookup(VARIANT_OP, key, backend=backend)
        variant = None
        if rec is not None:
            v = (rec.get("config") or {}).get("variant")
            if v in allowed_t:
                variant = v
        if variant is None and on_miss_mode() == "inline":
            rec = tune_attention(B, S, N, H, dtype, causal,
                                 variants=allowed_t, device=dev,
                                 mesh=mesh, budget_s=_budget_s())
            if rec is not None:
                v = (rec.get("config") or {}).get("variant")
                if v in allowed_t:
                    variant = v
        with _memo_lock:
            _MEMO[memo_key] = variant
        if variant is not None:
            return variant, rec
    # Miss (or memoized miss): inherit the pre-subsystem heuristic.
    return _heuristic_variant(S, allowed_t, dev), None


def auto_variant(B: int, S: int, N: int, H: int, dtype: Any,
                 causal: bool = True,
                 allowed: Tuple[str, ...] = ("flash", "dense"),
                 device=None) -> str:
    """Model-facing entry point for attention="auto": tunes only when
    RT_AUTOTUNE_ON_MISS=inline and returns a variant from ``allowed``.
    Unlike the reference it catches nothing: an unreadable cache file
    already reads as an empty cache."""
    v, _ = choose(B, S, N, H, dtype, causal, allowed=allowed, device=device)
    return v if v in allowed else allowed[-1]


# --------------------------------------------------------------- tuning

def tune_attention(B: int, S: int, N: int, H: int, dtype: Any,
                   causal: bool = True,
                   variants: Optional[Tuple[str, ...]] = None,
                   device=None, mesh=None, budget_s: Optional[float] = None,
                   force: bool = False) -> Optional[dict]:
    """Time every applicable variant on ``device`` (tuning each variant's
    own config first) and persist the crossover winner as an
    ``attention_variant`` record.  Returns the record, or None when
    nothing ran."""
    dev = resolve_device(device)
    backend = backend_fingerprint(dev)
    key = attention_key(B, S, N, H, dtype, causal)
    kd = _search.parse_key(key)
    cache = get_cache()
    if not force:
        rec = cache.lookup(VARIANT_OP, key, backend=backend, count=False)
        if rec is not None:
            return rec
    avail = applicable_variants(kd, dev, mesh)
    if variants is not None:
        avail = [v for v in avail if v in variants]
    t0 = time.perf_counter()
    timings: Dict[str, Optional[float]] = {}
    per_budget = None
    if budget_s is not None and avail:
        per_budget = budget_s / len(avail)
    context = {"mesh": mesh} if mesh is not None else None
    for v in avail:
        rec = _search.tune(_VARIANT_OPS[v], key, device=dev,
                           budget_s=per_budget, context=context, force=force)
        timings[v] = rec.get("ms") if rec else None
    _am.bump("autotune_tune_ms", (time.perf_counter() - t0) * 1e3)
    winner = choose_variant_from_timings(timings)
    if winner is None:
        return None
    return cache.put(VARIANT_OP, key, {"variant": winner},
                     timings[winner], meta={"timings": timings},
                     backend=backend)


# ------------------------------------------------------------ execution

def make_splash_kernel(N: int, S: int, cfg: Optional[dict], device):
    """A causal splash-MHA callable over ``[B, N, S, H]`` on ``device``
    (the caller pre-scales q).  It holds the ``MultiHeadMask`` of N
    ``CausalMask``s and its block maps at the forward's and the
    backward's block shapes (cfg's knobs from the sweep; None uses 128s,
    the reference's minimum), built once per shape and kept on the
    device."""
    cfg = cfg or {}
    fwd = int(cfg.get("block_q", 128))
    fkv = int(cfg.get("block_kv", fwd))
    bq = int(cfg.get("block_q_bwd", fwd))
    bkv = int(cfg.get("block_kv_bwd", fkv))
    mask = causal_mha_mask(N, S)
    fwd_info = process_mask(mask, (fwd, fkv))
    bwd_info = process_mask(mask, (bq, bkv))
    for info in (fwd_info, bwd_info):
        info.tensors(device)

    def kern(q, k, v):
        return splash_attention(q, k, v, fwd_info, bwd_info)

    kern.mask, kern.fwd_info, kern.bwd_info = mask, fwd_info, bwd_info
    return kern


def _bnsh(x, layout: str):
    return x if layout == "bnsh" else x.transpose(1, 2)


def _run_variant(variant: str, q, k, v, causal: bool, sm_scale,
                 layout: str, config: Optional[dict], mesh=None):
    if variant == "flash":
        cfg = config or {}
        return flash_attention(q, k, v, causal, cfg.get("block_q"),
                               cfg.get("block_k"), sm_scale, layout)
    if variant == "ring":
        if mesh is None:
            raise ValueError("the ring variant needs a mesh with an sp "
                             "axis (mesh=)")
        if not causal or sm_scale is not None:
            raise ValueError("the ring variant is causal, at scale "
                             "1/sqrt(H)")
        qs, ks, vs = (x.transpose(1, 2) if layout == "bnsh" else x
                      for x in (q, k, v))
        o = make_ring_attention_fn(mesh)(qs, ks, vs)
        return o.transpose(1, 2) if layout == "bnsh" else o
    if variant == "splash":
        if not causal:
            raise ValueError("the splash variant runs the causal mask only")
        qb, kb, vb = (_bnsh(x, layout) for x in (q, k, v))
        N, S, H = qb.shape[1:]
        scale = sm_scale if sm_scale is not None else H ** -0.5
        kern = make_splash_kernel(N, S, config, q.device)
        o = kern(qb * scale, kb, vb).to(q.dtype)
        return _bnsh(o, layout)
    if variant != "dense":
        raise ValueError(f"unknown attention variant {variant!r}")
    qs, ks, vs = (x.transpose(1, 2) if layout == "bnsh" else x
                  for x in (q, k, v))
    o = _dense_reference(qs, ks, vs, causal, sm_scale)
    return o.transpose(1, 2) if layout == "bnsh" else o


def attention(q, k, v, causal: bool = True, sm_scale=None,
              variant: Optional[str] = None, layout: str = "bsnh",
              mesh=None):
    """Dispatched multi-head attention on q's device.

    q, k, v: [B, S, N, H] ("bsnh", default) or [B, N, S, H] ("bnsh").
    ``variant`` forces one ("flash"/"dense"/"splash"/"ring"); None
    consults the autotune cache (measured crossover) with the on-miss
    policy.  ``mesh`` enables the ring variant (sequence sharded over its
    "sp" dim)."""
    if layout == "bnsh":
        B, N, S, H = q.shape
    else:
        B, S, N, H = q.shape
    if variant is None:
        variant, _rec = choose(B, S, N, H, q.dtype, causal,
                               device=q.device, mesh=mesh)
    cfg = None
    if variant in ("flash", "splash"):
        rec = get_cache().lookup(_VARIANT_OPS[variant],
                                 attention_key(B, S, N, H, q.dtype, causal),
                                 backend=backend_fingerprint(q.device),
                                 count=False)
        cfg = rec.get("config") if rec else None
    return _run_variant(variant, q, k, v, causal, sm_scale, layout, cfg,
                        mesh)


__all__ = ["attention", "choose", "auto_variant", "tune_attention",
           "choose_variant_from_timings", "applicable_variants",
           "make_splash_kernel", "clear_memo", "on_miss_mode",
           "VARIANT_OP"]

"""Block-config search engine: time candidate configs of a registered op
under a warmup + best-of-N harness (port of ``ray_tpu/autotune/search.py``).

Ops register a candidate generator and a builder; the builder returns a
zero-arg callable that runs ONE fwd+bwd step on the given device and, on
the card, ends in ``torch.cuda.synchronize()``.  The harness is
device-aware: on the CPU the plain versions run, so candidate sets shrink
as the reference's interpret mode shrinks them and one repeat is timed;
on the card the same code sweeps the kernels' real grid.

No quiet fallback: a candidate is skipped only when it runs out of device
memory (dense attention at long S), and the skip is recorded in the
record's ``meta``.  Any other exception of a candidate propagates, so a
kernel that fails to build or launch fails the sweep instead of being
outranked unseen.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.autotune import metrics as _am
from ray_tpu_torch.autotune.cache import (attention_key, backend_fingerprint,
                                          canon_dtype, get_cache)
from ray_tpu_torch.ops.flash_attention import _dense_reference, flash_attention
from ray_tpu_torch.ops.splash_attention import HEAD_DIMS as SPLASH_HEAD_DIMS

# The smallest block the reference's sweeps offer (the TPU's sublanes).
_MIN_BLOCK = 8


class OpSpec:
    def __init__(self, name: str,
                 candidates: Callable[[dict, torch.device], List[dict]],
                 build: Callable[..., Callable[[], Any]]):
        self.name = name
        self.candidates = candidates
        self.build = build


_OPS: Dict[str, OpSpec] = {}


def register_op(name: str, candidates, build) -> OpSpec:
    spec = OpSpec(name, candidates, build)
    _OPS[name] = spec
    return spec


def get_op(name: str) -> OpSpec:
    return _OPS[name]


def parse_key(key: str) -> dict:
    """Inverse of cache.attention_key: "B=2|S=4096|..." -> typed dict."""
    out: dict = {}
    for part in key.split("|"):
        k, v = part.split("=", 1)
        out[k] = v if k == "dtype" else int(v)
    out["causal"] = bool(out.get("causal", 1))
    return out


# ------------------------------------------------------------------ timing

def time_fn(fn: Callable[[], Any], iters: int = 3, repeats: int = 2,
            warmup: int = 1) -> float:
    """Best-of-``repeats`` mean wall-clock ms per call.  ``warmup`` calls
    absorb kernel builds; ``fn`` must synchronize internally."""
    for _ in range(max(1, warmup)):
        fn()
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            fn()
        best = min(best, (time.perf_counter() - t0) / max(1, iters))
    return best * 1e3


def search_op(op: str, key: str, candidates: Optional[List[dict]] = None,
              device=None, budget_s: Optional[float] = None,
              iters: Optional[int] = None, context: Optional[dict] = None
              ) -> Tuple[Optional[dict], float, List[Tuple[dict, float]],
                         List[list]]:
    """Time every candidate config of ``op`` at ``key`` on ``device``
    (default: the card).

    Returns (best_config, best_ms, [(config, ms), ...], skipped), where
    ``skipped`` lists ``[config, "oom"]`` for each candidate that ran out
    of device memory.  ``budget_s`` stops the sweep once exceeded,
    provided at least one candidate finished."""
    spec = get_op(op)
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    kd = parse_key(key)
    cands = candidates if candidates is not None else spec.candidates(kd, dev)
    if iters is None:
        iters = 1 if on_cpu else 3
    results: List[Tuple[dict, float]] = []
    skipped: List[list] = []
    t_start = time.perf_counter()
    for cfg in cands:
        if (budget_s is not None and results
                and time.perf_counter() - t_start > budget_s):
            break
        ms = _time_candidate(spec, kd, cfg, dev, context or {}, iters,
                             repeats=1 if on_cpu else 2)
        if ms is None:
            skipped.append([cfg, "oom"])
            torch.cuda.empty_cache()     # the candidate's tensors are gone
            continue
        results.append((cfg, ms))
    if not results:
        return None, float("inf"), results, skipped
    best_cfg, best_ms = min(results, key=lambda r: r[1])
    return best_cfg, best_ms, results, skipped


def _time_candidate(spec: OpSpec, kd: dict, cfg: dict, dev: torch.device,
                    context: dict, iters: int, repeats: int
                    ) -> Optional[float]:
    """ms per call of one candidate, or None when it ran out of device
    memory (the only failure a sweep absorbs)."""
    try:
        fn = spec.build(kd, cfg, device=dev, context=context)
        return time_fn(fn, iters=iters, repeats=repeats)
    except torch.cuda.OutOfMemoryError:
        return None


def tune(op: str, key: str, force: bool = False, device=None, **search_kw
         ) -> Optional[dict]:
    """Cache-aware tune: the cached record for (op, backend, key), or run
    the sweep, persist the winner, and return the new record.  When every
    candidate ran out of memory the record keeps ``config`` and ``ms``
    None (the variant never wins, and the sweep is not repeated); None
    when the op has no candidate at this shape."""
    dev = resolve_device(device)
    backend = backend_fingerprint(dev)
    cache = get_cache()
    if not force:
        rec = cache.lookup(op, key, backend=backend)
        if rec is not None:
            return rec
    else:
        _am.bump("autotune_cache_misses")
    t0 = time.perf_counter()
    best_cfg, best_ms, results, skipped = search_op(op, key, device=dev,
                                                    **search_kw)
    _am.bump("autotune_tune_ms", (time.perf_counter() - t0) * 1e3)
    if not results and not skipped:
        return None
    meta = {"swept": len(results),
            "results": [[c, round(ms, 4)] for c, ms in results[:32]]}
    if skipped:
        meta["skipped"] = skipped
    return cache.put(op, key, best_cfg,
                     best_ms if best_cfg is not None else None, meta=meta,
                     backend=backend)


# --------------------------------------------------------- block helpers

def valid_blocks(S: int, values=(128, 256, 512, 1024)) -> List[int]:
    return [v for v in values if v <= S and S % v == 0 and v >= _MIN_BLOCK]


def suggest_blocks(S: int) -> Tuple[int, int, int]:
    """For an S no offered block divides, the nearest padded sequence
    length and a block pair for it: (padded_S, block_q, block_k)."""
    pad = 128 if S > 16 else 8
    S_pad = ((int(S) + pad - 1) // pad) * pad
    cands = valid_blocks(S_pad) or [pad]
    b = max(cands)
    return S_pad, b, b


def flash_candidates(kd: dict, device: torch.device) -> List[dict]:
    """On the card ``[{}]``: the Hopper flash kernels pick their own tiles,
    and ``block_q``/``block_k`` steer only the plain versions.  On the CPU
    the plain versions' blocks, shrunk as the reference's interpret mode
    shrinks them (the two largest of 8..128 that divide S)."""
    if device.type == "cuda":
        return [{}]
    S = kd["S"]
    vals = [v for v in (8, 16, 32, 64, 128) if v <= S and S % v == 0]
    vals = vals[-2:] or [S]
    return [{"block_q": bq, "block_k": bk} for bq in vals for bk in vals]


def _qkv_for(kd: dict, device: torch.device, layout: str = "bsnh"):
    """Seeded q, k, v of the key's shape, leaves that require grad."""
    B, S, N, H = kd["B"], kd["S"], kd["N"], kd["H"]
    shape = (B, N, S, H) if layout == "bnsh" else (B, S, N, H)
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(shape, generator=gen, device=device,
                             dtype=getattr(torch, kd["dtype"]))
                 .requires_grad_(True) for _ in range(3))


def _fwdbwd_timed(loss_fn, q, k, v):
    """One forward and backward of ``loss_fn`` as a zero-arg callable that
    synchronizes the card before returning."""
    def run():
        for x in (q, k, v):
            x.grad = None
        loss_fn(q, k, v).backward()
        if q.device.type == "cuda":
            torch.cuda.synchronize(q.device)
    return run


def flash_build(kd: dict, cfg: dict, device: torch.device, context: dict):
    q, k, v = _qkv_for(kd, device)
    bq, bk = cfg.get("block_q"), cfg.get("block_k")

    def loss(q, k, v):
        return flash_attention(q, k, v, kd["causal"], bq, bk).float().sum()
    return _fwdbwd_timed(loss, q, k, v)


def dense_build(kd: dict, cfg: dict, device: torch.device, context: dict):
    q, k, v = _qkv_for(kd, device)

    def loss(q, k, v):
        return _dense_reference(q, k, v, kd["causal"], None).float().sum()
    return _fwdbwd_timed(loss, q, k, v)


RING_NOT_PORTED = ("ring attention needs the parallel layer, which is not "
                   "ported yet")


def ring_build(kd: dict, cfg: dict, device: torch.device, context: dict):
    raise NotImplementedError(RING_NOT_PORTED)


def splash_supported(kd: dict, device: Optional[torch.device] = None
                     ) -> bool:
    """The reference's shape test (head dim and S multiples of 128,
    causal); on the card the head dim must also be one the kernels take."""
    ok = (kd["H"] % 128 == 0 and kd["S"] % 128 == 0
          and bool(kd.get("causal", True)))
    if device is not None and device.type == "cuda":
        ok = ok and kd["H"] in SPLASH_HEAD_DIMS
    return ok


def splash_candidates(kd: dict, device: torch.device) -> List[dict]:
    """The reference's pruned splash surface: fwd blocks (block_q =
    block_kv) x bwd blocks (dq and dk/dv alike), each from (128, 256,
    512); the CPU keeps the first, as interpret mode does."""
    if not splash_supported(kd, device):
        return []
    vals = valid_blocks(kd["S"], (128, 256, 512))
    if device.type == "cpu":
        vals = vals[:1]
    return [{"block_q": fwd, "block_kv": fwd,
             "block_q_bwd": bwd, "block_kv_bwd": bwd}
            for fwd in vals for bwd in vals]


def splash_build(kd: dict, cfg: dict, device: torch.device, context: dict):
    from ray_tpu_torch.autotune.dispatch import make_splash_kernel
    kern = make_splash_kernel(kd["N"], kd["S"], cfg, device)
    q, k, v = _qkv_for(kd, device, layout="bnsh")
    scale = kd["H"] ** -0.5

    def loss(q, k, v):
        return kern(q * scale, k, v).float().sum()
    return _fwdbwd_timed(loss, q, k, v)


register_op("flash_attention", flash_candidates, flash_build)
register_op("dense_attention", lambda kd, dev: [{}], dense_build)
register_op("ring_attention", lambda kd, dev: [{}], ring_build)
register_op("splash_attention", splash_candidates, splash_build)


__all__ = ["register_op", "get_op", "search_op", "tune", "time_fn",
           "suggest_blocks", "valid_blocks", "flash_candidates",
           "splash_candidates", "splash_supported", "parse_key",
           "attention_key", "backend_fingerprint", "canon_dtype"]

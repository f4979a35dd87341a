#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA card, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Every phase prints one JSON line and any failure exits nonzero:

  device   torch's device name; nvidia-smi's name and power limit (also
           printed raw, as nvidia-smi gives them)
  build    nvcc seconds and the ptxas register/spill lines of each source
  kernel   the flash kernel against its plain version run in f32 on the
           same seeded inputs: the main-path shape (bf16, causal,
           [4,12,1024,64] bnsh), non-causal, bsnh, f32, ragged tails and
           the other head dims
  forward  GPT-2-small [4, 1024], attention="flash": f32 logits against
           the dense forward; bf16 top-1 against the f32 forward, as close
           as the dense bf16 forward's; exactly 12 kernel launches per
           forward; ms per forward and tokens/s; a profile of one forward
           (device time by kernel, idle share)
  serve    the paged engine answering 12 requests of 32..512 prompt tokens
           with 8 slots (admission queues): in f32 three streams equal the
           dense forward's greedy tokens; in bf16 throughput and time to
           first token, and a profile of one full decode step; every page
           returned
  kernels  per kernel: its time, its plain version's, one library call's
           (scaled_dot_product_attention, a yardstick the port never
           calls), the least time the card could take, its launches on the
           main path (the forward and serve phases) and its error

The last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits nonzero before printing any result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import statistics
import subprocess
import sys
import time

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes over the memory rate and operations over
# the tensor-core rate of its type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, shape in its layout, layout, causal, dtype)
KERNEL_CASES = [
    ("main bnsh causal bf16", (4, 12, 1024, 64), "bnsh", True, "bfloat16"),
    ("bnsh non-causal bf16", (4, 12, 1024, 64), "bnsh", False, "bfloat16"),
    ("bsnh causal bf16", (4, 1024, 12, 64), "bsnh", True, "bfloat16"),
    ("bnsh causal f32", (4, 12, 1024, 64), "bnsh", True, "float32"),
    ("ragged H16 S200 bf16", (2, 4, 200, 16), "bnsh", True, "bfloat16"),
    ("ragged H16 S200 f32", (2, 200, 4, 16), "bsnh", False, "float32"),
    ("ragged H32 S300 bf16", (2, 300, 4, 32), "bsnh", True, "bfloat16"),
    ("H128 S256 bf16", (2, 4, 256, 128), "bnsh", False, "bfloat16"),
    ("H128 S256 f32", (2, 4, 256, 128), "bnsh", True, "float32"),
]
# Against the plain version in f32: (o atol = o rtol, lse atol).
KERNEL_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------------ phases


def phase_kernel(dev, cases=KERNEL_CASES):
    """Each case: the wrapper (the kernel on a card) against the plain
    version run in f32 on the same inputs.  Returns {name: (o err, lse
    err)}."""
    import torch
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)
    errs = {}
    for i, (name, shape, layout, causal, dtype) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        q, k, v = (torch.randn(shape, generator=gen, device=dev,
                               dtype=getattr(torch, dtype))
                   for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, causal, layout=layout)
        sync(dev)
        ro, rl = flash_attention_reference(q.float(), k.float(), v.float(),
                                           causal, layout=layout)
        tol_o, tol_lse = KERNEL_TOL[dtype]
        err_o = (o.float() - ro).abs()
        err_lse = float((lse - rl).abs().max())
        ok = bool((err_o <= tol_o + tol_o * ro.abs()).all()) and \
            err_lse <= tol_lse and bool(torch.isfinite(o).all())
        errs[name] = (float(err_o.max()), err_lse)
        emit("kernel", case=name, shape=list(shape), layout=layout,
             causal=causal, dtype=dtype, o_max_abs_err=errs[name][0],
             lse_max_abs_err=err_lse, o_tol=tol_o, lse_tol=tol_lse, ok=ok)
        check(ok, f"flash kernel case {name!r} outside tolerance")
    return errs


def phase_forward(dev, cfg, params, B, S, windows_n=5, per_window=4):
    """GPT forward with the flash kernel, against the dense forward.

    f32: flash logits within 2e-3 of dense.  bf16: logits finite, and the
    flash forward's top-1 agrees with the f32 forward's at least as often
    as the dense bf16 forward's does (less half a point).  With random
    weights the top two logits of a few percent of positions lie closer
    than bf16's logit error, so neither bf16 path can match the other or
    the f32 forward everywhere; the comparison with f32 says whether flash
    is the less accurate of the two."""
    import torch
    from ray_tpu_torch.models import gpt_forward
    from ray_tpu_torch.ops.flash_attention import flash_attention
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    per_fwd = cfg.num_layers if dev.type == "cuda" else 0

    def forward(dtype, attention):
        n0 = flash_attention.launches
        logits = gpt_forward(params, tokens, dataclasses.replace(
            cfg, dtype=dtype, attention=attention))
        sync(dev)
        n = flash_attention.launches - n0
        check(n == (per_fwd if attention == "flash" else 0),
              f"{attention} {dtype} forward launched the kernel {n} times")
        check(logits.shape == (B, S, cfg.vocab_size), "logits shape")
        check(bool(torch.isfinite(logits).all()),
              f"{attention} {dtype} logits not finite")
        return logits

    dense32 = forward(torch.float32, "dense")
    top2 = dense32.topk(2, dim=-1).values
    out = {"f32_max_abs_diff_vs_dense": float(
        (forward(torch.float32, "flash") - dense32).abs().max()),
        "f32_top2_gap_p05": float(torch.quantile(
            (top2[..., 0] - top2[..., 1]).flatten(), 0.05))}
    top = {"f32": dense32.argmax(-1)}
    for attention in ("flash", "dense"):
        logits = forward(torch.bfloat16, attention)
        out[f"bf16_{attention}_max_abs_diff_vs_f32"] = float(
            (logits - dense32).abs().max())
        top[attention] = logits.argmax(-1)
        del logits
    del dense32
    for a, b in (("flash", "dense"), ("flash", "f32"), ("dense", "f32")):
        out[f"bf16_top1_{a}_vs_{b}"] = float(
            (top[a] == top[b]).float().mean())

    # The forward is host-bound, so its wall time swings with the host's
    # load: time several windows and report their median and all of them.
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16, attention="flash")
    gpt_forward(params, tokens, bf)          # warm
    sync(dev)
    n0 = flash_attention.launches
    windows = []
    for _ in range(windows_n):
        t0 = time.perf_counter()
        for _ in range(per_window):
            gpt_forward(params, tokens, bf)
        sync(dev)
        windows.append((time.perf_counter() - t0) / per_window * 1e3)
    ms = statistics.median(windows)
    launched = flash_attention.launches - n0
    emit("forward", batch=B, seq=S, launches_per_forward=per_fwd,
         bf16_ms_per_forward=ms, bf16_ms_windows=windows,
         bf16_tokens_per_s=B * S / (ms / 1e3), f32_tol=2e-3, **out)
    if dev.type == "cuda":
        profile_window("forward_profile",
                       lambda: gpt_forward(params, tokens, bf), dev)
    check(launched == per_fwd * windows_n * per_window,
          "timed forwards launched the kernel a wrong number of times")
    check(out["f32_max_abs_diff_vs_dense"] <= 2e-3,
          "f32 flash logits not within 2e-3 of dense")
    check(out["bf16_top1_flash_vs_f32"] >=
          out["bf16_top1_dense_vs_f32"] - 0.005,
          "bf16 flash top-1 is further from the f32 forward than dense's")
    return {"launches_per_forward": per_fwd, "ms": ms}


def profile_window(phase, fn, dev, iters=3, top=8):
    """Where one call of ``fn`` spends its time on the card: device time
    by kernel (torch.profiler, CUPTI) against the wall clock of the same
    window, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3 / iters
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((e.self_device_time_total / 1e3 / iters, e.key))
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _ in kernels)
    flash = sum(ms for ms, k in kernels if "flash_fwd" in k)
    emit(phase, wall_ms_per_call=wall, device_busy_ms_per_call=busy,
         device_idle_share=1 - busy / wall, flash_ms_per_call=flash,
         flash_share_of_busy=flash / busy,
         top_kernels=[{"name": k[:80], "ms_per_call": ms}
                      for ms, k in kernels[:top]])


def _prompts(n, lo, hi, vocab):
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, n)
    lens[0], lens[1] = hi, lo                 # both ends of the range
    return [rng.integers(0, vocab, int(L)).tolist() for L in lens]


def _serve_once(dev, cfg, params, prompts, page, max_prompt, max_new,
                max_batch):
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    need = -(-(max_prompt + max_new) // page)
    eng_cfg = EngineConfig(model_config=cfg, page_size=page,
                           num_pages=1 + max_batch * need,
                           max_batch=max_batch, max_prompt_len=max_prompt,
                           max_new_tokens=max_new, device=dev)

    async def run():
        eng = InferenceEngine(eng_cfg, params=params)

        async def one(p):
            t0, first, toks = time.perf_counter(), None, []
            async for t in eng.generate(p, max_new):
                if first is None:
                    first = time.perf_counter() - t0
                toks.append(t)
            return toks, first

        try:
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(p) for p in prompts))
            wall = time.perf_counter() - t0
            return res, wall, eng.stats()
        finally:
            eng.close()

    res, wall, stats = asyncio.run(run())
    check(stats["active"] == 0 and stats["waiting"] == 0,
          f"engine left work behind: {stats}")
    check(stats["free_pages"] == eng_cfg.num_pages - 1,
          f"engine did not return every page: {stats}")
    check(all(len(t) == max_new for t, _ in res),
          "a request was not answered in full")
    return res, wall, stats


def phase_serve(dev, cfg, params, n_req, prompt_lo, max_prompt, max_new,
                page, max_batch, n_checked, n_greedy):
    """The engine in f32 (greedy held to the dense forward) and in bf16
    (throughput, time to first token)."""
    import torch
    from ray_tpu_torch.models import gpt_forward
    prompts = _prompts(n_req, prompt_lo, max_prompt, cfg.vocab_size)
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attention="dense")
    res, wall32, _ = _serve_once(dev, c32, params, prompts, page, max_prompt,
                                 max_new, max_batch)
    ties = 0
    for p, (toks, _) in list(zip(prompts, res))[:n_checked]:
        # Teacher-forced along the engine's tokens: one causal forward
        # gives the dense model's prediction at every step.
        seq = torch.tensor([p + toks[:n_greedy - 1]], device=dev)
        logits = gpt_forward(params, seq, c32)[0, len(p) - 1:]
        for t in range(n_greedy):
            want = int(logits[t].argmax())
            if want == toks[t]:
                continue
            top2 = logits[t].topk(2).values
            tie = float(top2[0] - top2[1]) < 1e-4 and \
                float(top2[0] - logits[t][toks[t]]) < 1e-4
            check(tie, f"f32 engine token {toks[t]} != dense greedy {want} "
                       f"at step {t} of a {len(p)}-token prompt")
            ties += 1
    cbf = dataclasses.replace(cfg, dtype=torch.bfloat16, attention="dense")
    res, wall, stats = _serve_once(dev, cbf, params, prompts, page,
                                   max_prompt, max_new, max_batch)
    if dev.type == "cuda":
        profile_decode_step(dev, cbf, params, prompts, page, max_prompt,
                            max_new, max_batch)
    gen_tokens = sum(len(t) for t, _ in res)
    emit("serve", requests=n_req, slots=max_batch, page_size=page,
         prompt_lens=[len(p) for p in prompts], max_new_tokens=max_new,
         f32_greedy_checked=n_checked, f32_greedy_steps=n_greedy,
         f32_accepted_near_ties=ties, f32_tokens_per_s=n_req * max_new /
         wall32, bf16_generated_tokens=gen_tokens,
         bf16_tokens_per_s=gen_tokens / wall,
         bf16_p50_ttft_ms=statistics.median(f for _, f in res) * 1e3,
         bf16_decode_steps=stats["steps"], free_pages=stats["free_pages"])


def profile_decode_step(dev, cfg, params, prompts, page, max_prompt,
                        max_new, max_batch):
    """One batched decode step at the serve phase's shape: every slot
    busy, each sequence at the end of its prompt."""
    import torch
    from ray_tpu_torch.models import gpt_decode_step, init_paged_cache
    need = -(-(max_prompt + max_new) // page)
    kp, vp = init_paged_cache(cfg, 1 + max_batch * need, page, device=dev)
    tables = torch.arange(1, 1 + max_batch * need,
                          device=dev).reshape(max_batch, need)
    pos = torch.tensor([len(p) for p in prompts[:max_batch]], device=dev)
    token = torch.zeros(max_batch, dtype=torch.long, device=dev)
    profile_window("decode_profile", lambda: gpt_decode_step(
        params, cfg, token, pos, kp, vp, tables), dev)


def time_ms(fn, iters):
    """Warm, then CUDA events around ``iters`` calls: ms per call."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(B, N, S, H, dtype, causal):
    """Least time for the forward: each of q, k, v, o moved once plus lse,
    over the memory rate; the products these inputs need (causal: key j
    <= row i only) over the tensor-core rate of the dtype."""
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * B * N * S * H * elem + B * N * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2 * 2 * H * pairs * B * N           # q.k^T and p.v
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_times(dev, B, N, S, H):
    """The main-path call (bf16, causal, strided bnsh views of one fused
    qkv projection) timed three ways."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qkv = torch.randn((B, S, 3, N, H), generator=gen, device=dev,
                      dtype=torch.bfloat16).permute(0, 2, 3, 1, 4)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    kernel = time_ms(lambda: flash_attention_fwd(q, k, v, True,
                                                 layout="bnsh"), 50)
    plain = time_ms(lambda: flash_attention_reference(q, k, v, True,
                                                      layout="bnsh"), 5)
    library = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 50)
    bound, bound_by = flash_bound_ms(B, N, S, H, "bfloat16", True)
    return {"ms": kernel, "plain_ms": plain, "library_ms": library,
            "bound_ms": bound, "bound_by": bound_by}


# -------------------------------------------------------------------- main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "card", file=sys.stderr)
        return 2
    from ray_tpu_torch.models import GPTConfig, gpt_init
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", torch_name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(built.values()))

    errs = phase_kernel(dev)

    cfg = GPTConfig.gpt2_small()
    params = gpt_init(SEED, cfg, device=dev)
    flash_attention.launches = 0              # the main path starts here
    fwd = phase_forward(dev, cfg, params, B=4, S=1024)
    phase_serve(dev, cfg, params, n_req=12, prompt_lo=32, max_prompt=512,
                max_new=64, page=16, max_batch=8, n_checked=3, n_greedy=16)
    main_launches = flash_attention.launches  # ... and ends here
    check(main_launches > 0, "the main path never launched the flash kernel")
    del params
    torch.cuda.empty_cache()

    times = phase_kernel_times(dev, B=4, N=12, S=1024, H=64)
    main_o, main_lse = errs[KERNEL_CASES[0][0]]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:91",
        "launches": main_launches,
        "launches_per_forward": fwd["launches_per_forward"],
        "max_abs_err": main_o, "lse_max_abs_err": main_lse,
        "kernel_ms": times["ms"], **times,
        "shape": [4, 12, 1024, 64], "dtype": "bfloat16", "causal": True,
        "card": smi}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

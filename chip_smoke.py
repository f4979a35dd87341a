#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA card, nvcc
and PyTorch built for CUDA:

    python3 chip_smoke.py

Every phase prints one JSON line and any failure exits nonzero:

  device   torch's device name; nvidia-smi's name and power limit (also
           printed raw, as nvidia-smi gives them)
  build    nvcc seconds and the ptxas register/spill/warning lines of each
           source; for each redesigned kernel (the bf16 splash forward, dq
           and dk/dv and the bf16 flash forward, dq and dk/dv, each at head
           dims 64 and 128: twelve instantiations) its registers and
           spills, whether ptxas ignored setmaxnreg (C7508), and whether
           its SASS (cuobjdump -sass) holds HGMMA (wgmma) and UTMALDG (TMA
           loads);
           the phase fails if one is missing, lacks either, spills, or
           setmaxnreg was ignored
  kernel   the flash kernel against its plain version run in f32 on the
           same seeded inputs: the forward's shape (bf16, causal,
           [4,12,1024,64] bnsh), non-causal, bsnh, f32, ragged tails, the
           other head dims, ragged S at the wgmma kernels' head dims, and
           the training call ([32,12,1024,64] bf16 causal, q/k/v strided
           views of one fused qkv tensor)
  kernel_bwd  the backward kernels (dq; dk and dv) against the plain
           backward run in f32 on the same seeded q, k, v, dO, over the
           same cases (dO contiguous): max |err| <= tol x max |ref| per
           tensor
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
  train    GPT-2-small training at full width (MFU from bench.py's count,
           6 N + 12 L S D per token over 989e12): (a) f32 loss and grads
           with flash against dense at [2, 1024]; (b) bf16 flash grads as
           close to the f32 dense grads as the bf16 dense grads are (per
           leaf: relative distance ||g - g32|| / ||g32|| and cosine);
           (d) flash launches of one step under the
           remat policies full, attn, attn_dots; (c) bench.py's
           configuration (B=32, S=1024, bf16, remat "dots", ce_block 256,
           AdamW 3e-4 b2 0.95 wd 1e-4): 2 warm and 10 timed steps on one
           batch, loss finite and falling, exact launches per step, ms per
           step, samples/s, tokens/s, MFU; (e) a profile of one step
  llama_forward, llama_serve, llama_train_check, llama_train
           the same four phases (and their profiles) on LLaMA-125M (12
           layers, 12 query and 4 KV heads of 64, SwiGLU 2048, vocab 32000,
           untied head): the forward [4, 1024] with flash (K/V repeated to
           the query heads for the kernels), the engine with model="llama"
           under the serve phase's traffic, and training at bench.py's
           _llama_point (B=32, S=1024, bf16, remat "dots", ce_block 256,
           AdamW 3e-4 b2 0.95 wd 1e-4), under the same limits and exact
           launch counts as GPT's
  kernel_splash  the three splash kernels (forward; dq; dk and dv) against
           their plain versions run in f32: Llama 2 7B's attention
           [2,32,4096,128] bf16 causal at 128-blocks, [1,2,256,*] with
           partial, empty and full blocks (bf16, f32, H 64 and 128), one
           map per head with unequal blocks (f32 at H 64, bf16 at H 128),
           and [2,4,1024,128] at every candidate block size of the sweep
  autotune the autotune path under a fresh cache file ($RT_AUTOTUNE_CACHE
           set to a temporary file): tune_attention at (a) GPT-2-small's
           training attention [B=32,S=1024,N=12,H=64] (flash and dense
           timed, splash absent) and (b) [2,4096,32,128] (all 9 splash
           candidates, flash and dense); every record read back by a fresh
           cache; dispatch.attention with no variant runs each recorded
           winner, as the launch counters show; the model's
           attention="auto" takes the record; then the bf16 grads of the
           splash variant at (b) no further from the f32 dense grads than
           REL_MULT x the bf16 dense grads' distance
  attention_shapes  device times of the bf16 flash forward (causal and
           not), the splash forward and dq, and SDPA's forward at
           GPT-2-small's inference and training calls, a long sequence
           ([2,12,8192,64]) and shape (b)
  kernels  per kernel: its time, its plain version's, one library call's
           (scaled_dot_product_attention's forward, or its backward timed
           as forward+backward less forward: a yardstick the port never
           calls), the least time the card could take, its launches on
           the main paths (forward and serve for the forward kernel, the
           timed training steps for the flash kernels, the autotune path
           for the splash kernels; the flash entries also each family's
           inference and training launches), its error and its bf16 design
           ("wgmma+tma" or "mma.sync"); all but the flash forward's entry
           also their achieved TFLOP/s and the share of their bound they
           reach (the flash forward's under "train_call" and at the
           inference call); the flash backward's library time is SDPA's
           backward by device time, its event time beside it; the
           flash forward is timed at the inference call [4,12,1024,64] and
           at the training call [32,12,1024,64], each with the device time
           of scaled_dot_product_attention's forward beside its event time

The last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits nonzero before printing any result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes over the memory rate and operations over
# the tensor-core rate of its type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, shape in its layout, layout, causal, dtype, q/k/v as the strided
# qkv[:, i] views of one [B, S, 3, N, H] projection)
KERNEL_CASES = [
    ("main bnsh causal bf16", (4, 12, 1024, 64), "bnsh", True, "bfloat16",
     False),
    ("bnsh non-causal bf16", (4, 12, 1024, 64), "bnsh", False, "bfloat16",
     False),
    ("bsnh causal bf16", (4, 1024, 12, 64), "bsnh", True, "bfloat16", False),
    ("bnsh causal f32", (4, 12, 1024, 64), "bnsh", True, "float32", False),
    ("ragged H16 S200 bf16", (2, 4, 200, 16), "bnsh", True, "bfloat16",
     False),
    ("ragged H16 S200 f32", (2, 200, 4, 16), "bsnh", False, "float32",
     False),
    ("ragged H32 S300 bf16", (2, 300, 4, 32), "bsnh", True, "bfloat16",
     False),
    ("H128 S256 bf16", (2, 4, 256, 128), "bnsh", False, "bfloat16", False),
    ("H128 S256 f32", (2, 4, 256, 128), "bnsh", True, "float32", False),
    # Ragged S on the wgmma kernels: padded queries in the dk/dv kernel, a
    # ragged key tile in dq.
    ("ragged H64 S200 bsnh causal bf16", (2, 200, 4, 64), "bsnh", True,
     "bfloat16", False),
    ("ragged H128 S320 bnsh bf16", (2, 4, 320, 128), "bnsh", False,
     "bfloat16", False),
    # The training call (bench.py's batch): q/k/v as the GPT block hands
    # them over, dO contiguous as autograd does.
    ("train call bnsh causal bf16 qkv views", (32, 12, 1024, 64), "bnsh",
     True, "bfloat16", True),
]
MAIN_CASE, TRAIN_CASE = KERNEL_CASES[0], KERNEL_CASES[-1]
# Against the plain version in f32: (o atol = o rtol, lse atol).
KERNEL_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}
# Backward against the plain version in f32: max |err| <= tol x max |ref|
# per tensor (bf16: P and dS are rounded before their products, and the
# outputs to bf16; f32: sums in another order).
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Training checks: f32 flash loss within this relative distance of dense,
# each grad leaf within GRAD_TOL x max |leaf|; per leaf, the bf16 flash
# grads' distance ||g - g32|| / ||g32|| from the f32 dense grads at most
# REL_MULT x the bf16 dense grads', and their cosine with them at most
# COS_MARGIN below the bf16 dense grads'.  GPT-2-small at [2, 1024], seed
# 0, on an H100 read a worst distance ratio of 1.077 and a worst cosine
# gap of 5.1e-6; the limits leave room above those readings.
LOSS_RTOL, GRAD_TOL, REL_MULT, COS_MARGIN = 1e-5, 1e-3, 1.25, 5e-5


# Device time by kind of kernel in a profile, matched by name in order:
# the port's kernels, cuBLAS GEMMs, reductions (softmax, norms, sums),
# then element-wise and copy kernels.
KERNEL_CLASSES = (
    ("flash", ("flash_",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("reduce", ("reduce_kernel", "softmax", "norm")),
    ("elementwise_copy", ("elementwise", "copy", "Copy", "Functor",
                          "index")),
)


@dataclasses.dataclass(frozen=True)
class Family:
    """A model family's entry points, as the phases call them.  ``model`` is
    the engine's model name; ``prefix`` starts the family's phase names
    (GPT's phases keep their bare names)."""
    model: str
    prefix: str
    init: object
    forward: object
    loss: object
    train_state: object
    train_step: object
    decode_step: object
    init_cache: object


def family(cfg) -> Family:
    from ray_tpu_torch import models as m
    if isinstance(cfg, m.LlamaConfig):
        return Family("llama", "llama_", m.llama_init, m.llama_forward,
                      m.llama_loss, m.llama_make_train_state,
                      m.llama_make_train_step, m.llama_decode_step,
                      m.llama_init_paged_cache)
    return Family("gpt", "", m.gpt_init, m.gpt_forward, m.gpt_loss,
                  m.make_train_state, m.make_train_step, m.gpt_decode_step,
                  m.init_paged_cache)


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


KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "splash_fwd",
                "splash_bwd_dq", "splash_bwd_dkv")


def _counted():
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.splash_attention import splash_attention
    return (flash_attention, splash_attention)


def launch_counts():
    """Launches so far of each kernel, in KERNEL_NAMES order: flash
    forward, dq, dkv, then splash forward, dq, dkv."""
    return tuple(getattr(fn, name) for fn in _counted()
                 for name in ("launches", "dq_launches", "dkv_launches"))


def reset_launch_counts():
    for fn in _counted():
        fn.launches = fn.dq_launches = fn.dkv_launches = 0


def case_inputs(gen, dev, shape, dtype, views, n):
    """``n`` seeded normal tensors of ``shape`` (q, k, v, then dO).  With
    ``views`` (bnsh) q, k and v are the strided qkv[:, i] views of one
    [B, S, 3, N, H] tensor, as the GPT block hands them to the kernels."""
    import torch
    dt = getattr(torch, dtype)
    out = []
    if views:
        B, N, S, H = shape
        qkv = torch.randn((B, S, 3, N, H), generator=gen, device=dev,
                          dtype=dt).permute(0, 2, 3, 1, 4)
        out = [qkv[:, 0], qkv[:, 1], qkv[:, 2]]
    return out + [torch.randn(shape, generator=gen, device=dev, dtype=dt)
                  for _ in range(n - len(out))]


def named_leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from named_leaves(v, name)
        else:
            yield name, v


# ------------------------------------------------------------------ phases

# The kernels redesigned on wgmma, TMA and warp specialisation (bf16, head
# dims 64 and 128), as (source, the name each has in its library).
REDESIGNED = [("splash_attention.cu", "splash_fwd_kernel"),
              ("splash_attention.cu", "splash_dq_kernel"),
              ("splash_attention.cu", "splash_dkv_kernel"),
              ("flash_fwd.cu", "flash_fwd_kernel"),
              ("flash_bwd.cu", "flash_bwd_dq_kernel"),
              ("flash_bwd.cu", "flash_bwd_dkv_kernel")]
REDESIGNED_HEAD_DIMS = (64, 128)


def ptxas_by_kernel(lines):
    """{mangled kernel name: the ptxas lines that follow its "Compiling
    entry function" line}."""
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(ln)
    return out


def sass_by_kernel(lib):
    """{mangled kernel name: its SASS} of a built library, read with
    cuobjdump -sass from the toolkit beside nvcc."""
    from ray_tpu_torch.ops import _build
    sass = subprocess.run([_build.find_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        out[name.strip()] = body
    return out


def phase_build():
    """Build every source (one nvcc each, in parallel) and show, for each
    redesigned kernel, its registers, spills and ptxas warnings, whether
    setmaxnreg was ignored (C7508), and whether its SASS holds HGMMA
    (wgmma) and UTMALDG (TMA tile loads)."""
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    redesigned, ignored = {}, []
    for source in sorted({src for src, _ in REDESIGNED}):
        kernels = [k for src, k in REDESIGNED if src == source]
        ptxas = built[source]["ptxas"]
        ignored += [ln for ln in ptxas if "C7508" in ln]
        per_kernel = ptxas_by_kernel(ptxas)
        sass = sass_by_kernel(_build.library_path(source))
        for name, body in sorted(sass.items()):
            # the length-prefixed name, so splash_dq_kernel is not
            # splash_dq_f32_kernel and flash_bwd_dq_kernel not
            # flash_bwd_dq_mma_kernel
            if not any(f"{len(k)}{k}" in name for k in kernels):
                continue
            lines = per_kernel.get(name, [])
            regs = re.search(r"Used (\d+) registers", " ".join(lines))
            spills = next((ln for ln in lines if "spill" in ln), None)
            redesigned[name] = {
                "source": source,
                "registers": int(regs.group(1)) if regs else None,
                "spills": spills,
                "spilled": bool(spills and
                                re.search(r"[1-9]\d* bytes spill", spills)),
                "setmaxnreg_ignored": any("C7508" in ln for ln in lines),
                "warnings": [ln for ln in lines
                             if re.search(r"warning|\(C\d+\)", ln, re.I)],
                "HGMMA": "HGMMA" in body, "UTMALDG": "UTMALDG" in body}
    emit("build", seconds=secs, sources=list(built.values()),
         redesigned=redesigned, setmaxnreg_ignored_lines=ignored)
    check(len(redesigned) == len(REDESIGNED) * len(REDESIGNED_HEAD_DIMS),
          f"redesigned kernels found in the libraries: {sorted(redesigned)}")
    missing = [n for n, r in redesigned.items()
               if not (r["HGMMA"] and r["UTMALDG"])]
    check(not missing, f"no HGMMA or no UTMALDG in the SASS of {missing}")
    spilled = [n for n, r in redesigned.items() if r["spilled"]]
    check(not spilled, f"redesigned kernels that spill: {spilled}")
    check(not ignored, f"ptxas ignored setmaxnreg: {ignored}")
    return redesigned


def phase_kernel(dev, cases=KERNEL_CASES):
    """Each case: the wrapper (the kernel on a card) against the plain
    version run in f32 on the same inputs.  Returns {name: (o err, lse
    err)}."""
    import torch
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)
    errs = {}
    for i, (name, shape, layout, causal, dtype, views) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        q, k, v = case_inputs(gen, dev, shape, dtype, views, 3)
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
             causal=causal, dtype=dtype, qkv_views=views,
             o_max_abs_err=errs[name][0],
             lse_max_abs_err=err_lse, o_tol=tol_o, lse_tol=tol_lse, ok=ok)
        check(ok, f"flash kernel case {name!r} outside tolerance")
    return errs


def phase_kernel_bwd(dev, cases=KERNEL_CASES):
    """Each case: dq, dk, dv from the backward kernels (o and lse from the
    forward kernel) against the plain backward run in f32 on the same
    inputs.  Returns {name: {"dq": err, "dk": err, "dv": err}}."""
    import torch
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
    errs = {}
    for i, (name, shape, layout, causal, dtype, views) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        q, k, v, do = case_inputs(gen, dev, shape, dtype, views, 4)
        o, lse = flash_attention_fwd(q, k, v, causal, layout=layout)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal, layout=layout)
        sync(dev)
        want = flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            causal, layout=layout)
        tol, fields, ok = BWD_TOL[dtype], {}, True
        errs[name] = {}
        for t, a, b in zip(("dq", "dk", "dv"), got, want):
            err, ref = float((a.float() - b).abs().max()), float(
                b.abs().max())
            errs[name][t] = err
            fields[f"{t}_max_abs_err"], fields[f"{t}_max_abs_ref"] = err, ref
            ok = ok and err <= tol * ref and bool(torch.isfinite(a).all())
        emit("kernel_bwd", case=name, shape=list(shape), layout=layout,
             causal=causal, dtype=dtype, qkv_views=views, tol_rel=tol,
             ok=ok, **fields)
        check(ok, f"flash backward case {name!r} outside tolerance")
    return errs


def phase_forward(dev, cfg, params, B, S, windows_n=5, per_window=4):
    """The model's forward (GPT or LLaMA, by ``cfg``; phase ``forward`` or
    ``llama_forward``) with the flash kernel, against the dense forward.

    f32: flash logits within 2e-3 of dense.  bf16: logits finite, and the
    flash forward's top-1 agrees with the f32 forward's at least as often
    as the dense bf16 forward's does (less half a point).  With random
    weights the top two logits of a few percent of positions lie closer
    than bf16's logit error, so neither bf16 path can match the other or
    the f32 forward everywhere; the comparison with f32 says whether flash
    is the less accurate of the two."""
    import torch
    from ray_tpu_torch.ops.flash_attention import flash_attention
    fam = family(cfg)
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
    per_fwd = cfg.num_layers if dev.type == "cuda" else 0

    def forward(dtype, attention):
        n0 = flash_attention.launches
        logits = fam.forward(params, tokens, dataclasses.replace(
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
    fam.forward(params, tokens, bf)          # warm
    sync(dev)
    n0 = flash_attention.launches
    windows = []
    for _ in range(windows_n):
        t0 = time.perf_counter()
        for _ in range(per_window):
            fam.forward(params, tokens, bf)
        sync(dev)
        windows.append((time.perf_counter() - t0) / per_window * 1e3)
    ms = statistics.median(windows)
    launched = flash_attention.launches - n0
    emit(fam.prefix + "forward", batch=B, seq=S,
         launches_per_forward=per_fwd,
         bf16_ms_per_forward=ms, bf16_ms_windows=windows,
         bf16_tokens_per_s=B * S / (ms / 1e3), f32_tol=2e-3, **out)
    if dev.type == "cuda":
        profile_window(fam.prefix + "forward_profile",
                       lambda: fam.forward(params, tokens, bf), dev)
    check(launched == per_fwd * windows_n * per_window,
          "timed forwards launched the kernel a wrong number of times")
    check(out["f32_max_abs_diff_vs_dense"] <= 2e-3,
          "f32 flash logits not within 2e-3 of dense")
    check(out["bf16_top1_flash_vs_f32"] >=
          out["bf16_top1_dense_vs_f32"] - 0.005,
          "bf16 flash top-1 is further from the f32 forward than dense's")
    return {"launches_per_forward": per_fwd, "ms": ms}


PROFILER_SESSIONS = 3


def profiled(fn, iters, activities, want=None):
    """``fn`` run ``iters`` times under torch.profiler (CUPTI); returns the
    key averages of its CUDA kernels, each as (device us, name), and the
    wall ms per call.  A session whose trace came back with no CUDA kernel
    whose name holds ``want`` (no kernel at all when ``want`` is None) is
    run again, up to PROFILER_SESSIONS sessions, since the profiler now and
    then hands back a session without its device events; every such miss
    is printed as a ``profiler_miss`` line."""
    import torch
    from torch.profiler import profile
    for session in range(PROFILER_SESSIONS):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        kernels = [(e.self_device_time_total, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(us > 0 and (want is None or want in k) for us, k in kernels):
            return kernels, wall
        emit("profiler_miss", want=want, session=session + 1,
             of=PROFILER_SESSIONS, kernels_seen=len(kernels))
    return kernels, wall


def profile_window(phase, fn, dev, iters=3, top=8):
    """Where one call of ``fn`` spends its time on the card: device time
    by kernel (torch.profiler, CUPTI) against the wall clock of the same
    window, per call."""
    from torch.profiler import ProfilerActivity
    sync(dev)
    kernels, wall = profiled(fn, iters, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    if not any(us > 0 for us, _ in kernels):
        emit(phase, wall_ms_per_call=wall, device_trace="missing")
        return
    kernels = sorted(((us / 1e3 / iters, k) for us, k in kernels),
                     reverse=True)
    busy = sum(ms for ms, _ in kernels)
    flash = {name: sum(ms for ms, k in kernels if name in k)
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    by_class = {}
    for ms, k in kernels:
        cls = next((c for c, words in KERNEL_CLASSES
                    if any(w in k for w in words)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + ms
    emit(phase, wall_ms_per_call=wall, device_busy_ms_per_call=busy,
         device_idle_share=1 - busy / wall,
         flash_ms_per_call=sum(flash.values()),
         flash_share_of_busy=sum(flash.values()) / busy,
         flash_kernels_ms_per_call=flash, device_ms_by_class=by_class,
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
    eng_cfg = EngineConfig(model=family(cfg).model, model_config=cfg,
                           page_size=page,
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
    """The engine (GPT or LLaMA, by ``cfg``; phase ``serve`` or
    ``llama_serve``) in f32 (greedy held to the dense forward) and in bf16
    (throughput, time to first token)."""
    import torch
    fam = family(cfg)
    prompts = _prompts(n_req, prompt_lo, max_prompt, cfg.vocab_size)
    c32 = dataclasses.replace(cfg, dtype=torch.float32, attention="dense")
    res, wall32, _ = _serve_once(dev, c32, params, prompts, page, max_prompt,
                                 max_new, max_batch)
    ties = 0
    for p, (toks, _) in list(zip(prompts, res))[:n_checked]:
        # Teacher-forced along the engine's tokens: one causal forward
        # gives the dense model's prediction at every step.
        seq = torch.tensor([p + toks[:n_greedy - 1]], device=dev)
        logits = fam.forward(params, seq, c32)[0, len(p) - 1:]
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
    emit(fam.prefix + "serve", requests=n_req, slots=max_batch,
         page_size=page,
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
    fam = family(cfg)
    need = -(-(max_prompt + max_new) // page)
    kp, vp = fam.init_cache(cfg, 1 + max_batch * need, page, device=dev)
    tables = torch.arange(1, 1 + max_batch * need,
                          device=dev).reshape(max_batch, need)
    pos = torch.tensor([len(p) for p in prompts[:max_batch]], device=dev)
    token = torch.zeros(max_batch, dtype=torch.long, device=dev)
    profile_window(fam.prefix + "decode_profile", lambda: fam.decode_step(
        params, cfg, token, pos, kp, vp, tables), dev)


def _loss_and_grads(params, tokens, cfg):
    """Loss and grads of one backward of the family's loss (no optimizer
    step); the params' .grad are cleared again."""
    leaves = [p for _, p in named_leaves(params)]
    for p in leaves:
        p.grad = None
    loss = family(cfg).loss(params, {"tokens": tokens}, cfg)
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def _cosine(a, b):
    import torch
    a, b = a.flatten().double(), b.flatten().double()
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def _rel_dist(a, b):
    """||a - b|| / ||b||: unlike the cosine, it sees a wrong scale."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def phase_train(dev, cfg, B, S, check_B=2, warm=2, steps=10):
    """Training at full width (GPT or LLaMA, by ``cfg``; phases
    ``train_check``, ``train``, ``train_profile``, with ``llama_`` before
    LLaMA's); see the module docstring.  ``cfg`` is the training
    configuration itself: bf16 compute, flash attention, remat "dots"
    (what the launch counts expect), its ``ce_block``.  On the CPU (a
    rehearsal at a tiny config) no kernel launches."""
    import torch
    fam = family(cfg)
    check(cfg.dtype == torch.bfloat16 and cfg.attention == "flash" and
          cfg.remat and cfg.remat_policy == "dots",
          f"phase_train takes a bf16 flash config under remat dots: {cfg}")
    params, opt = fam.train_state(SEED, cfg, learning_rate=3e-4,
                                  weight_decay=1e-4, device=dev)
    names = [n for n, _ in named_leaves(params)]
    # bench.py's model FLOPs per token: 6 N + 12 L S D
    n_params = sum(p.numel() for _, p in named_leaves(params))
    mflop_per_token = (6 * n_params + 12 * cfg.num_layers * S *
                       cfg.embed_dim) / 1e6
    gen = torch.Generator().manual_seed(SEED + 1)
    check_tokens = torch.randint(0, cfg.vocab_size, (check_B, S + 1),
                                 generator=gen).to(dev)
    L = cfg.num_layers if dev.type == "cuda" else 0

    # (a) f32: flash against dense, loss and every grad leaf.
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss_f, g_flash = _loss_and_grads(params, check_tokens, c32)
    loss_d, g_dense32 = _loss_and_grads(
        params, check_tokens, dataclasses.replace(c32, attention="dense"))
    ratios = [float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(g_flash, g_dense32)]
    del g_flash
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    # (b) bf16: flash grads no further from f32 dense than dense bf16's.
    _, g_fb = _loss_and_grads(params, check_tokens, cfg)
    cos_flash = [_cosine(a, b) for a, b in zip(g_fb, g_dense32)]
    rel_flash = [_rel_dist(a, b) for a, b in zip(g_fb, g_dense32)]
    del g_fb
    _, g_db = _loss_and_grads(params, check_tokens,
                              dataclasses.replace(cfg, attention="dense"))
    cos_dense = [_cosine(a, b) for a, b in zip(g_db, g_dense32)]
    rel_dense = [_rel_dist(a, b) for a, b in zip(g_db, g_dense32)]
    del g_db, g_dense32
    gaps = [d - f for f, d in zip(cos_flash, cos_dense)]
    rel_ratios = [f / d for f, d in zip(rel_flash, rel_dense)]
    worst_rel = max(range(len(rel_ratios)), key=rel_ratios.__getitem__)
    emit(fam.prefix + "train_check", batch=check_B, seq=S,
         f32_loss_flash=loss_f,
         f32_loss_dense=loss_d, f32_loss_rel_diff=loss_rel,
         loss_rtol=LOSS_RTOL, f32_grad_worst_leaf=names[worst],
         f32_grad_worst_err_over_max=ratios[worst], grad_tol=GRAD_TOL,
         bf16_min_cos_flash=min(cos_flash), bf16_min_cos_dense=min(cos_dense),
         bf16_worst_cos_gap=max(gaps),
         bf16_worst_cos_gap_leaf=names[max(range(len(gaps)),
                                           key=gaps.__getitem__)],
         cos_margin=COS_MARGIN, bf16_max_rel_dist_flash=max(rel_flash),
         bf16_max_rel_dist_dense=max(rel_dense),
         bf16_worst_rel_dist_ratio=rel_ratios[worst_rel],
         bf16_worst_rel_dist_ratio_leaf=names[worst_rel],
         bf16_worst_rel_dist_ratio_leaf_flash_dense=[rel_flash[worst_rel],
                                                     rel_dense[worst_rel]],
         rel_mult=REL_MULT)
    check(loss_rel <= LOSS_RTOL, "f32 flash loss not within 1e-5 of dense")
    check(max(ratios) <= GRAD_TOL,
          f"f32 flash grad of {names[worst]} too far from dense")
    check(max(gaps) <= COS_MARGIN,
          "bf16 flash grads' cosine further from f32 than bf16 dense's")
    check(all(f <= REL_MULT * d for f, d in zip(rel_flash, rel_dense)),
          f"bf16 flash grad of {names[worst_rel]} further from f32 than "
          f"{REL_MULT} x the bf16 dense grad's distance")

    # (d) launches of one backward under the other remat policies
    policies = {}
    for policy, fwd in (("full", 2 * L), ("attn", L), ("attn_dots", L)):
        n0 = launch_counts()
        loss, _ = _loss_and_grads(params, check_tokens, dataclasses.replace(
            cfg, remat_policy=policy))
        sync(dev)
        n = [b - a for a, b in zip(n0, launch_counts())]
        policies[policy] = n
        want = [fwd, L, L, 0, 0, 0]
        check(n == want and math.isfinite(loss),
              f"remat {policy}: launches {n}, expected {want}")

    # (c) bench.py's configuration: the training cfg path
    step = fam.train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=gen).to(dev)
    batch = {"tokens": tokens}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                     # the training path starts
    metrics = [step(params, batch) for _ in range(warm)]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics.append(step(params, batch))
    sync(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()                # ... and ends here
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    ms = secs / steps * 1e3
    tok_s = B * S * steps / secs
    per_step = [2 * L, L, L, 0, 0, 0]
    emit(fam.prefix + "train", batch=B, seq=S, dtype="bfloat16",
         remat_policy="dots", ce_block=cfg.ce_block, warm_steps=warm,
         timed_steps=steps, ms_per_step=ms, samples_per_s=B * steps / secs,
         tokens_per_s=tok_s, mfu=tok_s * mflop_per_token * 1e6 / 989e12,
         n_params=n_params, mflop_per_token=mflop_per_token, losses=losses,
         grad_norms=norms,
         launches=dict(zip(KERNEL_NAMES, launches)),
         launches_per_step=per_step, other_policies_launches=policies,
         peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                         if dev.type == "cuda" else None))
    check(all(math.isfinite(x) for x in losses + norms),
          "training loss or grad norm not finite")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    check(list(launches) == [n * (warm + steps) for n in per_step],
          f"training launches {launches}, expected {per_step} per step")
    if dev.type == "cuda":
        profile_window(fam.prefix + "train_profile",
                       lambda: step(params, batch), dev, iters=2)
    return {"launches": launches, "per_step": per_step, "ms": ms}


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


# (tensors of [B, N, S, H], f32 [B*N, S] statistics, products) each
# function must move or do: fwd q k v o, lse, q.k^T and p.v; dq q k v dO
# dQ, lse and D, q.k^T, dO.v^T and dS.k; dkv q k v dO dK dV, lse and D,
# q.k^T, dO.v^T, P^T.dO and dS^T.q.
FLASH_WORK = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}


def device_ms(fn, kernel, iters):
    """Warm, then the device time per call of the kernels whose name holds
    ``kernel`` (every kernel the call launches when ``kernel`` is None),
    from torch.profiler (CUPTI) over ``iters`` calls: the kernels' own time
    even where the host cannot enqueue calls as fast as the card runs
    them."""
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kernels, _ = profiled(fn, iters, [ProfilerActivity.CUDA], kernel)
    us = sum(t for t, k in kernels if kernel is None or kernel in k)
    if us > 0:
        return us / 1e3 / iters
    # No session traced the kernel: its time between CUDA events instead,
    # which holds the host's gaps between calls too, and says so.
    ms = time_ms(fn, iters)
    emit("profiler_miss", want=kernel, timed_by="cuda_events", ms=ms,
         kernels_seen=sorted({k[:60] for _, k in kernels}))
    return ms


def flash_bound_ms(B, N, S, H, dtype, causal, kind="fwd"):
    """Least time for one flash function: each input and output moved
    once, over the memory rate; the products these inputs need (causal:
    key j <= row i only) over the tensor-core rate of the dtype."""
    tensors, stats, products = FLASH_WORK[kind]
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * B * N * S * H * elem + stats * B * N * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = products * 2 * H * pairs * B * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_times(dev, B, N, S, H):
    """A main-path call of the forward kernel (bf16, causal, strided bnsh
    views of one fused qkv projection) timed three ways.  ``ms`` is the
    kernel's device time; ``event_ms`` the wrapper's time per call between
    CUDA events, which the host's dispatch bounds when it is slower than
    the kernel.  The library yardstick, scaled_dot_product_attention's
    forward on the same views, likewise: ``library_ms`` the device time of
    every kernel it launches, ``library_event_ms`` between events."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 3)

    def call():
        return flash_attention_fwd(q, k, v, True, layout="bnsh")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    # "flash_fwd_" names both the wgmma kernel (flash_fwd_kernel) and the
    # mma.sync one (flash_fwd_mma_kernel), whichever this call launches
    kernel = device_ms(call, "flash_fwd_", 50)
    bound, bound_by = flash_bound_ms(B, N, S, H, "bfloat16", True)
    flop = FLASH_WORK["fwd"][2] * 2 * H * S * (S + 1) // 2 * B * N
    return {"shape": [B, N, S, H], "ms": kernel,
            "event_ms": time_ms(call, 50),
            "plain_ms": time_ms(lambda: flash_attention_reference(
                q, k, v, True, layout="bnsh"), 3),
            "library_ms": device_ms(sdpa, None, 50),
            "library_event_ms": time_ms(sdpa, 50),
            "bound_ms": bound, "bound_by": bound_by,
            "tflops": flop / 1e12 / (kernel / 1e3),
            "bound_share": bound / kernel}


def phase_kernel_bwd_times(dev, B, N, S, H):
    """The training call of each backward kernel (bf16, causal, q/k/v
    strided bnsh views of one fused qkv projection, dO contiguous, as
    autograd hands it over) timed three ways, with its achieved TFLOP/s
    and the share of its bound it reaches.  The library yardstick is
    scaled_dot_product_attention's backward (dq, dk and dv together),
    timed as forward+backward less forward on the same views: by device
    time (``library_ms``, from the profiler) and between CUDA events
    (``library_event_ms``)."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (
        _delta, _launch_dkv, _launch_dq, flash_attention_dkv_reference,
        flash_attention_dq_reference, flash_attention_fwd)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 4)
    o, lse = flash_attention_fwd(q, k, v, True, layout="bnsh")
    delta = _delta(o, do, "bnsh")
    scale = 1.0 / math.sqrt(H)
    args = (q, k, v, do, lse, delta, True, scale, "bnsh")
    ref_args = (q, k, v, o, lse, do, True)
    out = {}
    for kind, launch, plain in (
            ("dq", _launch_dq, flash_attention_dq_reference),
            ("dkv", _launch_dkv, flash_attention_dkv_reference)):
        out[kind] = {
            "ms": device_ms(lambda: launch(*args), f"flash_bwd_{kind}_", 20),
            "event_ms": time_ms(lambda: launch(*args), 20),
            "plain_ms": time_ms(lambda: plain(*ref_args, layout="bnsh"), 3)}
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd_bwd():
        for x in (ql, kl, vl):
            x.grad = None
        F.scaled_dot_product_attention(ql, kl, vl,
                                       is_causal=True).backward(do)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

    fwd_bwd, fwd = time_ms(sdpa_fwd_bwd, 20), time_ms(sdpa_fwd, 20)
    fwd_bwd_dev = device_ms(sdpa_fwd_bwd, None, 20)
    fwd_dev = device_ms(sdpa_fwd, None, 20)
    for kind in ("dq", "dkv"):
        bound, bound_by = flash_bound_ms(B, N, S, H, "bfloat16", True, kind)
        flop = FLASH_WORK[kind][2] * 2 * H * S * (S + 1) // 2 * B * N
        ms = out[kind]["ms"]
        out[kind].update(library_ms=fwd_bwd_dev - fwd_dev,
                         library_event_ms=fwd_bwd - fwd, bound_ms=bound,
                         bound_by=bound_by,
                         tflops=flop / 1e12 / (ms / 1e3),
                         bound_share=bound / ms)
    emit("kernel_bwd_times", shape=[B, N, S, H], dtype="bfloat16",
         causal=True, library="scaled_dot_product_attention backward "
         "(dq+dk+dv) = fwd+bwd - fwd", library_fwd_bwd_ms=fwd_bwd_dev,
         library_fwd_ms=fwd_dev, library_fwd_bwd_event_ms=fwd_bwd,
         library_fwd_event_ms=fwd, **out)
    return out


# ------------------------------------------------------- splash and autotune

# The autotune path's two full-width shapes ([B, N, S, H], bf16, causal):
# (a) GPT-2-small's training attention (bench.py's configuration), where
# splash does not apply (head dim 64); (b) Llama 2 7B's attention, 32 heads
# of 128 over a 4096 context (Touvron et al. 2023, Table 1), batch 2 as the
# repo's long-context bench takes it at S=4096: the shape that reaches
# splash.
GPT2_ATTN = (32, 12, 1024, 64)
SPLASH_SHAPE = (2, 32, 4096, 128)
# (name, [B, N, S, H], dtype, fwd blocks, bwd blocks, per-head offsets)
SPLASH_CASES = [
    ("llama2-7b attention", SPLASH_SHAPE, "bfloat16", (128, 128),
     (128, 128), ()),
    ("map [[1,0],[2,1]] bf16", (1, 2, 256, 128), "bfloat16", (128, 128),
     (128, 128), ()),
    ("map [[1,0],[2,1]] f32", (1, 2, 256, 128), "float32", (128, 128),
     (128, 128), ()),
    ("H64 bf16", (1, 2, 256, 64), "bfloat16", (128, 128), (128, 128), ()),
    ("per-head offsets, unequal blocks f32", (2, 2, 512, 64), "float32",
     (256, 128), (128, 256), (0, 128)),
    ("per-head offsets, unequal blocks bf16 H128", (2, 2, 512, 128),
     "bfloat16", (256, 128), (128, 256), (0, 128)),
] + [(f"blocks fwd {f} bwd {b}", (2, 4, 1024, 128), "bfloat16", (f, f),
      (b, b), ()) for f in (128, 256, 512) for b in (128, 256, 512)]
SPLASH_MAIN = SPLASH_CASES[0]
# The design of each bf16 kernel on its main path: "wgmma+tma"
# (warp-specialised, TMA ring, wgmma from shared memory) or "mma.sync" (the
# first design).
SPLASH_BF16_DESIGN = {"fwd": "wgmma+tma", "dq": "wgmma+tma",
                      "dkv": "wgmma+tma"}
FLASH_BF16_DESIGN = {"fwd": "wgmma+tma", "dq": "wgmma+tma",
                     "dkv": "wgmma+tma"}


def splash_case_inputs(gen, dev, shape, dtype, n):
    """``n`` seeded normal tensors (q, k, v, then dO), q pre-scaled by
    1/sqrt(H) as the splash caller does."""
    import torch
    dt = getattr(torch, dtype)
    xs = [torch.randn(shape, generator=gen, device=dev, dtype=dt)
          for _ in range(n)]
    xs[0] = (xs[0] * shape[-1] ** -0.5).to(dt)
    return xs


def phase_kernel_splash(dev, cases=SPLASH_CASES):
    """Each case: the three splash kernels (forward; dq; dk and dv, from
    the forward kernel's o and lse) against their plain versions run in f32
    on the same inputs and block maps.  Returns {name: {"o", "lse", "dq",
    "dk", "dv": max |err|}}."""
    import torch
    from ray_tpu_torch.ops import splash_attention as sp
    errs = {}
    for i, (name, shape, dtype, fwd, bwd, offsets) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(SEED + 200 + i)
        q, k, v, do = splash_case_inputs(gen, dev, shape, dtype, 4)
        mask = sp.causal_mha_mask(shape[1], shape[2], offsets)
        fi, bi = sp.process_mask(mask, fwd), sp.process_mask(mask, bwd)
        o, lse = sp.splash_attention_fwd(q, k, v, fi)
        got = sp.splash_attention_bwd(q, k, v, o, lse, do, bi)
        sync(dev)
        f32 = [x.float() for x in (q, k, v)]
        ro, rl = sp.splash_attention_reference(*f32, fi)
        want = (sp.splash_dq_reference(*f32, o.float(), lse, do.float(), bi),
                *sp.splash_dkv_reference(*f32, o.float(), lse, do.float(),
                                         bi))
        tol_o, tol_lse = KERNEL_TOL[dtype]
        err_o = (o.float() - ro).abs()
        errs[name] = {"o": float(err_o.max()),
                      "lse": float((lse - rl).abs().max())}
        ok = bool((err_o <= tol_o + tol_o * ro.abs()).all()) and \
            errs[name]["lse"] <= tol_lse and bool(torch.isfinite(o).all())
        fields = {}
        for t, a, b in zip(("dq", "dk", "dv"), got, want):
            err, ref = float((a.float() - b).abs().max()), float(
                b.abs().max())
            errs[name][t] = err
            fields[f"{t}_max_abs_err"], fields[f"{t}_max_abs_ref"] = err, ref
            ok = ok and err <= BWD_TOL[dtype] * ref and \
                bool(torch.isfinite(a).all())
        emit("kernel_splash", case=name, shape=list(shape), dtype=dtype,
             fwd_blocks=list(fwd), bwd_blocks=list(bwd),
             offsets=list(offsets), block_map=fi.block_mask.tolist()
             if fi.block_mask.size <= 16 else None,
             o_max_abs_err=errs[name]["o"], lse_max_abs_err=errs[name]["lse"],
             o_tol=tol_o, lse_tol=tol_lse, bwd_tol_rel=BWD_TOL[dtype], ok=ok,
             **fields)
        check(ok, f"splash kernel case {name!r} outside tolerance")
        del q, k, v, do, o, lse, got, f32, ro, rl, want
    return errs


def phase_autotune(dev, cfg, shapes=(GPT2_ATTN, SPLASH_SHAPE)):
    """The autotune path at full width under a fresh cache: tune_attention
    at shapes (a) and (b) (per-variant timings, winners), a fresh
    AutotuneCache over the file reads every record back, then
    dispatch.attention(q, k, v) with no variant runs each recorded winner,
    as the launch counters show, and the model's attention="auto" takes
    the record at (a)."""
    import torch
    from ray_tpu_torch.autotune import (AutotuneCache, attention_key,
                                        backend_fingerprint, cache_path)
    from ray_tpu_torch.autotune import dispatch
    from ray_tpu_torch.models.gpt import _auto_attention_variant
    from ray_tpu_torch.ops.flash_attention import _dense_reference
    backend = backend_fingerprint(dev)
    on_card = dev.type == "cuda"
    want_variants = {shape: {"flash", "dense"} | (
        {"splash"} if shape[3] % 128 == 0 else set()) for shape in shapes}
    ops = {"splash": "splash_attention", "flash": "flash_attention",
           "dense": "dense_attention"}
    out = {}
    for B, N, S, H in want_variants:
        t0 = time.perf_counter()
        rec = dispatch.tune_attention(B, S, N, H, "bfloat16", True,
                                      device=dev)
        secs = time.perf_counter() - t0
        timings = rec["meta"]["timings"]
        key = attention_key(B, S, N, H, "bfloat16", True)
        fresh = AutotuneCache(cache_path())       # the file, read anew
        records = {v: fresh.lookup(ops[v], key, backend=backend,
                                   count=False) for v in timings}
        winner = fresh.lookup(dispatch.VARIANT_OP, key, backend=backend,
                              count=False)
        emit("autotune_sweep", shape=[B, N, S, H], dtype="bfloat16",
             backend=backend, seconds=secs, winner=rec["config"]["variant"],
             timings_ms=timings,
             records={v: {"config": r["config"], "ms": r["ms"],
                          "meta": r.get("meta")} for v, r in records.items()})
        check(set(timings) == want_variants[(B, N, S, H)],
              f"variants timed at {[B, N, S, H]}: {sorted(timings)}")
        check(all(ms is not None and math.isfinite(ms)
                  for ms in timings.values()), f"a variant did not run: "
              f"{timings}")
        check(winner is not None and winner["config"] == rec["config"] and
              all(r is not None for r in records.values()),
              "the records were not read back from the file")
        if "splash" in timings:
            check(records["splash"]["meta"]["swept"] == (9 if on_card
                                                         else 1),
                  "the splash sweep did not time all its candidates")
        out[(B, N, S, H)] = rec["config"]["variant"]

    dispatch.clear_memo()
    for i, ((B, N, S, H), winner) in enumerate(out.items()):
        gen = torch.Generator(device=dev).manual_seed(SEED + 300 + i)
        q, k, v = (torch.randn((B, S, N, H), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        n0 = launch_counts()
        o = dispatch.attention(q, k, v)
        sync(dev)
        n = [b - a for a, b in zip(n0, launch_counts())]
        ran = ("flash" if n == [1, 0, 0, 0, 0, 0] else
               "splash" if n == [0, 0, 0, 1, 0, 0] else
               "dense" if not any(n) else f"launches {n}")
        ref = _dense_reference(q.float(), k.float(), v.float(), True, None)
        tol = KERNEL_TOL["bfloat16"][0]
        err = (o.float() - ref).abs()
        emit("autotune_dispatch", shape=[B, N, S, H], winner=winner,
             ran=ran, launches=dict(zip(KERNEL_NAMES, n)),
             max_abs_err_vs_dense_f32=float(err.max()), tol=tol)
        check(ran == winner or not on_card, f"dispatch at {[B, N, S, H]} "
              f"ran {ran}, the record says {winner}")
        check(bool((err <= tol + tol * ref.abs()).all()),
              f"dispatched {winner} at {[B, N, S, H]} is off dense f32")
        del q, k, v, o, ref, err
    B, N, S, H = shapes[0]
    model_auto = _auto_attention_variant(
        B, S, dataclasses.replace(cfg, dtype=torch.bfloat16), dev)
    emit("autotune_model_auto", shape=[B, N, S, H], variant=model_auto,
         record=out[shapes[0]])
    check(model_auto == out[shapes[0]],
          "the model's attention='auto' did not take the record")
    return out


def phase_splash_grad_check(dev, shape=SPLASH_SHAPE):
    """bf16 grads of attention(variant="splash") at shape (b): per tensor,
    the relative distance ||g - g32|| / ||g32|| from the f32 dense grads at
    most REL_MULT x the bf16 dense grads' (as train_check holds flash)."""
    import torch
    from ray_tpu_torch.autotune import dispatch
    B, N, S, H = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    q, k, v, do = (torch.randn((B, N, S, H), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))

    def grads(variant, dtype):
        leaves = [x.to(dtype, copy=True).requires_grad_(True)
                  for x in (q, k, v)]
        o = dispatch.attention(*leaves, variant=variant, layout="bnsh")
        o.backward(do.to(dtype))
        out = [x.grad.float() for x in leaves]
        del o, leaves
        torch.cuda.empty_cache()
        return out

    g32 = grads("dense", torch.float32)
    rel = {}
    for variant in ("splash", "dense"):
        rel[variant] = [_rel_dist(g, r) for g, r in zip(
            grads(variant, torch.bfloat16), g32)]
    ratios = [s / d for s, d in zip(rel["splash"], rel["dense"])]
    emit("splash_grad_check", shape=[B, N, S, H], layout="bnsh",
         bf16_rel_dist_splash=dict(zip(("dq", "dk", "dv"), rel["splash"])),
         bf16_rel_dist_dense=dict(zip(("dq", "dk", "dv"), rel["dense"])),
         ratios=dict(zip(("dq", "dk", "dv"), ratios)), rel_mult=REL_MULT)
    check(max(ratios) <= REL_MULT, f"bf16 splash grads further from f32 "
          f"than {REL_MULT} x the bf16 dense grads': {ratios}")


def splash_bound_ms(kind, B, N, S, H, pairs):
    """Least time for one splash function at bf16: each input and output
    moved once, over the memory rate; the products over the pairs
    (query, key) the mask leaves visible, over the tensor-core rate."""
    tensors, stats, products = FLASH_WORK[kind]
    nbytes = tensors * B * N * S * H * 2 + stats * B * N * S * 4
    flops = products * 2 * H * pairs * B
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_splash_kernel_times(dev):
    """Each splash kernel at shape (b) (bf16, the causal map at 128-blocks,
    the default config) timed as the flash kernels are: device time from
    the profiler, CUDA-event time of the wrapper, the plain version's
    time; the library yardstick is scaled_dot_product_attention
    (is_causal, scale 1: q is pre-scaled), forward for the forward kernel
    and fwd+bwd less fwd for the pair."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import splash_attention as sp
    B, N, S, H = SPLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = splash_case_inputs(gen, dev, SPLASH_SHAPE, "bfloat16", 4)
    info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
    offsets, rows, cols = info.tensors(dev)
    blocks = (info.block_q, info.block_kv)
    o, lse = sp._launch_fwd(q, k, v, offsets, rows, *blocks)
    di = sp._di(o, do)
    # the (query, key) pairs the mask leaves visible, over all heads
    pairs = sum(int(m[0:S, 0:S].sum())
                for m in sp.causal_mha_mask(N, S).masks)
    tflop = {kind: FLASH_WORK[kind][2] * 2 * H * pairs * B / 1e12
             for kind in FLASH_WORK}
    calls = {
        "fwd": (lambda: sp._launch_fwd(q, k, v, offsets, rows, *blocks),
                "splash_fwd_kernel",
                lambda: sp.splash_attention_reference(q, k, v, info)),
        "dq": (lambda: sp._launch_dq(q, k, v, do, lse, di, offsets, rows,
                                     *blocks), "splash_dq_kernel",
               lambda: sp.splash_dq_reference(q, k, v, o, lse, do, info)),
        "dkv": (lambda: sp._launch_dkv(q, k, v, do, lse, di, offsets, cols,
                                       *blocks), "splash_dkv_kernel",
                lambda: sp.splash_dkv_reference(q, k, v, o, lse, do, info)),
    }
    out = {}
    for kind, (fn, kernel, plain) in calls.items():
        bound, bound_by = splash_bound_ms(kind, B, N, S, H, pairs)
        ms = device_ms(fn, kernel, 20)
        out[kind] = {"ms": ms, "event_ms": time_ms(fn, 20),
                     "plain_ms": time_ms(plain, 2),
                     "bound_ms": bound, "bound_by": bound_by,
                     "tflops": tflop[kind] / (ms / 1e3),
                     "bound_share": bound / ms,
                     "design": SPLASH_BF16_DESIGN[kind]}
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                              scale=1.0)

    def sdpa_fwd_bwd():
        for x in (ql, kl, vl):
            x.grad = None
        sdpa().backward(do)

    fwd_bwd, fwd = time_ms(sdpa_fwd_bwd, 20), time_ms(sdpa, 20)
    out["fwd"]["library_ms"] = fwd
    for kind in ("dq", "dkv"):
        out[kind]["library_ms"] = fwd_bwd - fwd
    emit("splash_kernel_times", shape=list(SPLASH_SHAPE), dtype="bfloat16",
         blocks=list(blocks), visible_pairs=pairs,
         library="scaled_dot_product_attention (is_causal, scale 1); "
         "backward = fwd+bwd - fwd (dq+dk+dv)", library_fwd_bwd_ms=fwd_bwd,
         library_fwd_ms=fwd, **out)
    return out


# Where the bf16 forward kernels stand against SDPA's forward beyond the
# main paths' shapes: GPT-2-small's inference and training calls, a long
# sequence at its head dim, and shape (b).
ATTENTION_SHAPES = [(4, 12, 1024, 64), (32, 12, 1024, 64),
                    (2, 12, 8192, 64), SPLASH_SHAPE]


def phase_attention_shapes(dev, shapes=ATTENTION_SHAPES):
    """At each shape ([B, N, S, H], bf16, q/k/v strided bnsh views of one
    fused qkv projection): device ms of the flash forward and of
    scaled_dot_product_attention's forward, causal and not, and of the
    splash forward and dq over the causal map at 128-blocks."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import splash_attention as sp
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    for B, N, S, H in shapes:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v, do = case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 4)
        row = {}
        for causal in (True, False):
            tag = "causal" if causal else "full"
            row[f"flash_fwd_{tag}_ms"] = device_ms(
                lambda: flash_attention_fwd(q, k, v, causal, layout="bnsh"),
                "flash_fwd_", 20)
            row[f"sdpa_fwd_{tag}_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                None, 20)
        info = sp.process_mask(sp.causal_mha_mask(N, S), (128, 128))
        offsets, rows, _ = info.tensors(dev)
        o, lse = sp._launch_fwd(q, k, v, offsets, rows, 128, 128)
        di = sp._di(o, do)
        row["splash_fwd_ms"] = device_ms(lambda: sp._launch_fwd(
            q, k, v, offsets, rows, 128, 128), "splash_fwd_", 20)
        row["splash_bwd_dq_ms"] = device_ms(lambda: sp._launch_dq(
            q, k, v, do, lse, di, offsets, rows, 128, 128), "splash_dq_", 20)
        emit("attention_shapes", shape=[B, N, S, H], dtype="bfloat16",
             **row)
        del q, k, v, do, o, lse, di


# -------------------------------------------------------------------- main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "card", file=sys.stderr)
        return 2
    # A fresh autotune cache, so no file under the card's home can steer
    # the "auto" paths; removed at the end.
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["RT_AUTOTUNE_CACHE"] = os.path.join(cache_dir,
                                                   "autotune.jsonl")
    try:
        return run()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


# The engine's traffic on both families: 12 requests of 32..512 prompt
# tokens, 64 new tokens each, 8 decode slots, page 16; three f32 streams
# held to the dense forward's greedy tokens over 16 steps.
SERVE = dict(n_req=12, prompt_lo=32, max_prompt=512, max_new=64, page=16,
             max_batch=8, n_checked=3, n_greedy=16)


def model_paths(dev, cfg, train_cfg, B=4, S=1024, train_B=32, serve=SERVE):
    """One family's main paths at full width: the inference path (forward
    [B, S] with flash, then the engine) with the launch counts set to 0
    before it and read after, then the training path at [train_B, S]
    (``phase_train`` counts its timed steps itself).  Returns (the forward
    phase's result, the inference path's launches, the training phase's
    result)."""
    params = family(cfg).init(SEED, cfg, device=dev)
    reset_launch_counts()                     # the inference path starts
    fwd = phase_forward(dev, cfg, params, B=B, S=S)
    phase_serve(dev, cfg, params, **serve)
    infer = launch_counts()                   # ... and ends here
    del params
    empty_cache(dev)
    train = phase_train(dev, train_cfg, B=train_B, S=S)
    empty_cache(dev)
    return fwd, infer, train


def empty_cache(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run() -> int:
    import torch
    from ray_tpu_torch.models import GPTConfig, LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", torch_name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    phase_build()

    errs = phase_kernel(dev)
    bwd_errs = phase_kernel_bwd(dev)
    splash_errs = phase_kernel_splash(dev)

    # GPT-2-small, then LLaMA-125M at bench.py's _llama_point: the same
    # training settings (B=32, S=1024, bf16, flash, remat dots, ce_block 256)
    train_kw = dict(attention="flash", remat=True, remat_policy="dots",
                    ce_block=256)
    cfg = GPTConfig.gpt2_small()
    fwd, infer_launches, train = model_paths(
        dev, cfg, dataclasses.replace(cfg, **train_kw))
    llama_fwd, llama_infer, llama_train = model_paths(
        dev, LlamaConfig.llama_125m(),
        LlamaConfig(max_seq_len=1024, **train_kw))
    for name, launches in (("GPT", infer_launches), ("LLaMA", llama_infer)):
        check(launches[0] > 0 and launches[1:] == (0, 0, 0, 0, 0),
              f"{name} inference path launches {launches}")
    for name, t in (("GPT", train), ("LLaMA", llama_train)):
        check(all(t["launches"][:3]), f"the {name} training path missed a "
              f"kernel")

    reset_launch_counts()                     # the autotune path starts
    phase_autotune(dev, cfg)
    tune_launches = launch_counts()           # ... and ends here
    emit("autotune_launches", launches=dict(zip(KERNEL_NAMES,
                                                tune_launches)))
    check(all(tune_launches[3:]), "the autotune path missed a splash kernel")
    torch.cuda.empty_cache()
    phase_splash_grad_check(dev)
    torch.cuda.empty_cache()

    times = phase_kernel_times(dev, *MAIN_CASE[1])
    train_times = phase_kernel_times(dev, *TRAIN_CASE[1])
    emit("kernel_times", inference_call=times, train_call=train_times)
    bwd_times = phase_kernel_bwd_times(dev, *TRAIN_CASE[1])
    splash_times = phase_splash_kernel_times(dev)
    phase_attention_shapes(dev)
    main_o, main_lse = errs[MAIN_CASE[0]]
    train_errs = bwd_errs[TRAIN_CASE[0]]
    splash_main = splash_errs[SPLASH_MAIN[0]]
    common = {"route": "cuda", "dtype": "bfloat16", "causal": True,
              "card": smi}
    splash_common = {"source": "ray_tpu_torch/csrc/splash_attention.cu",
                     "reached_via": "ray_tpu/autotune/dispatch.py:238",
                     "shape": list(SPLASH_SHAPE), "blocks": [128, 128],
                     **common}
    splash_kernel = ("jax/experimental/pallas/ops/tpu/splash_attention/"
                     "splash_attention_kernel.py")
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "source": "ray_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:91",
         "launches": infer_launches[0] + train["launches"][0] +
         llama_infer[0] + llama_train["launches"][0],
         "launches_inference": infer_launches[0],
         "launches_train": train["launches"][0],
         "launches_llama_inference": llama_infer[0],
         "launches_llama_train": llama_train["launches"][0],
         "launches_autotune": tune_launches[0],
         "launches_per_forward": fwd["launches_per_forward"],
         "launches_per_llama_forward": llama_fwd["launches_per_forward"],
         "launches_per_train_step": train["per_step"][0],
         "launches_per_llama_train_step": llama_train["per_step"][0],
         "max_abs_err": main_o, "lse_max_abs_err": main_lse,
         "train_call_max_abs_err": errs[TRAIN_CASE[0]][0],
         "train_call_lse_max_abs_err": errs[TRAIN_CASE[0]][1],
         **times, "train_call": train_times,
         "design": FLASH_BF16_DESIGN["fwd"], **common},
        {"name": "flash_bwd_dq", "source": "ray_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:217",
         "launches": train["launches"][1] + llama_train["launches"][1],
         "launches_train": train["launches"][1],
         "launches_llama_train": llama_train["launches"][1],
         "launches_llama_inference": llama_infer[1],
         "launches_autotune": tune_launches[1],
         "launches_per_train_step": train["per_step"][1],
         "max_abs_err": train_errs["dq"],
         **bwd_times["dq"], "library_covers": "dq+dk+dv",
         "design": FLASH_BF16_DESIGN["dq"], "shape": list(TRAIN_CASE[1]),
         **common},
        {"name": "flash_bwd_dkv", "source": "ray_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "ray_tpu/ops/flash_attention.py:263",
         "launches": train["launches"][2] + llama_train["launches"][2],
         "launches_train": train["launches"][2],
         "launches_llama_train": llama_train["launches"][2],
         "launches_llama_inference": llama_infer[2],
         "launches_autotune": tune_launches[2],
         "launches_per_train_step": train["per_step"][2],
         "max_abs_err": max(train_errs["dk"], train_errs["dv"]),
         **bwd_times["dkv"], "library_covers": "dq+dk+dv",
         "design": FLASH_BF16_DESIGN["dkv"], "shape": list(TRAIN_CASE[1]),
         **common},
        {"name": "splash_fwd", "replaces": f"{splash_kernel}:696",
         "launches": tune_launches[3], "max_abs_err": splash_main["o"],
         "lse_max_abs_err": splash_main["lse"], **splash_times["fwd"],
         **splash_common},
        {"name": "splash_bwd_dq", "replaces": f"{splash_kernel}:1307",
         "launches": tune_launches[4], "max_abs_err": splash_main["dq"],
         **splash_times["dq"], "library_covers": "dq+dk+dv",
         **splash_common},
        {"name": "splash_bwd_dkv", "replaces": f"{splash_kernel}:1669",
         "launches": tune_launches[5],
         "max_abs_err": max(splash_main["dk"], splash_main["dv"]),
         **splash_times["dkv"], "library_covers": "dq+dk+dv",
         **splash_common},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's attention kernels in several checkouts on one card, so
that two versions are compared on the same card in one run.

    python3 scripts/torch_kernel_ab.py DIR [DIR ...]
    python3 scripts/torch_kernel_ab.py --interleave ROUNDS DIR [DIR ...]

Each DIR is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a directory that git
ignores, beside the working tree ``.``).  A checkout builds its kernels
into its own ``ray_tpu_torch/_build/`` on first use.  One line with the
card's name and power limit comes first.

In turns (the default), each DIR is run in a process of its own, in the
order given (give parent, change, change, parent to see the spread
between two runs of one version): that checkout's own ``chip_smoke.py``
timing phases ``kernel_times`` (the flash forward at the inference and
training calls), ``kernel_bwd_times`` (the flash backward at the training
call) and ``splash_kernel_times`` (the splash kernels at
[2,32,4096,128]), their JSON lines printed with the checkout and the turn
added.  Then one ``sass`` line per checkout: for each wgmma kernel its
SASS instruction count and a hash of its SASS (addresses and encodings
left out), so two checkouts whose hashes agree compiled that kernel to
the same code.

A card slows as it warms, so turns seconds apart read the same code up
to 10% apart.  ``--interleave`` takes that out: one process builds every
checkout's libraries, then for each kernel and each of ROUNDS rounds
times 20 launches of every checkout's build in turn (CUDA events), each
through this checkout's wrapper with the same inputs.  That needs the
checkouts' C entry points to agree, as they do while a change leaves
them alone.  It prints one ``interleave`` line per kernel: per checkout
the median, lowest and highest ms per launch, and how many rounds each
later checkout beat the first.  Exits nonzero without a CUDA card or when
a checkout's run fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

CODE = """
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
cs.emit("kernel_times", inference_call=cs.phase_kernel_times(
    dev, *cs.MAIN_CASE[1]), train_call=cs.phase_kernel_times(
    dev, *cs.TRAIN_CASE[1]))
cs.phase_kernel_bwd_times(dev, *cs.TRAIN_CASE[1])
cs.phase_splash_kernel_times(dev)
"""

SASS = """
import hashlib, re
import chip_smoke as cs
from ray_tpu_torch.ops import _build
out = {}
for source in sorted({src for src, _ in cs.REDESIGNED}):
    for name, body in cs.sass_by_kernel(_build.library_path(source)).items():
        m = re.search(r"\\d+((?:splash|flash)_\\w+_kernel)ILi(\\d+)E", name)
        if m is None or m.group(1) not in {k for _, k in cs.REDESIGNED}:
            continue
        code = [re.sub(r"/\\*[^*]*\\*/", "", ln).strip()
                for ln in body.splitlines()]
        code = [ln for ln in code if ln]
        out[f"{m.group(1)}<{m.group(2)}>"] = {
            "instructions": len(code),
            "sha": hashlib.sha256("\\n".join(code).encode()).hexdigest()[:16]}
cs.emit("sass", kernels=out)
"""

# Builds a checkout's libraries and prints {source: library path}.
BUILD = """
import json
from ray_tpu_torch.ops import _build
_build.build_all()
print(json.dumps({s: _build.library_path(s) for s in
                  ("flash_fwd.cu", "flash_bwd.cu", "splash_attention.cu")}))
"""


def run_turns(dirs) -> int:
    runs = [(turn, d, CODE) for turn, d in enumerate(dirs)]
    runs += [(None, d, SASS) for d in dict.fromkeys(dirs)]
    for turn, d, code in runs:
        proc = subprocess.run([sys.executable, "-c", code],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"checkout": d, "turn": turn,
                                  **json.loads(line)}), flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


def run_interleaved(dirs, rounds: int, launches: int = 20) -> int:
    import ctypes
    import importlib

    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ray_tpu_torch.ops import _build
    # the package exports functions of these names, so import the modules
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    sp = importlib.import_module("ray_tpu_torch.ops.splash_attention")

    libs = {}
    for d in dict.fromkeys(dirs):
        proc = subprocess.run([sys.executable, "-c", BUILD],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        paths = json.loads(proc.stdout.strip().splitlines()[-1])
        libs[d] = {s: ctypes.CDLL(p) for s, p in paths.items()}

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, N, S, H = cs.TRAIN_CASE[1]
    q, k, v, do = cs.case_inputs(gen, dev, (B, N, S, H), "bfloat16", True, 4)
    o, lse = fa.flash_attention_fwd(q, k, v, True, layout="bnsh")
    delta = fa._delta(o, do, "bnsh")
    bwd = (q, k, v, do, lse, delta, True, H ** -0.5, "bnsh")
    sq, sk, sv, sdo = cs.splash_case_inputs(gen, dev, cs.SPLASH_SHAPE,
                                            "bfloat16", 4)
    info = sp.process_mask(sp.causal_mha_mask(*cs.SPLASH_SHAPE[1:3]),
                           (128, 128))
    offsets, rows, cols = info.tensors(dev)
    so, slse = sp._launch_fwd(sq, sk, sv, offsets, rows, 128, 128)
    di = sp._di(so, sdo)
    kernels = {
        "flash_fwd": ("flash_fwd.cu", lambda: fa._launch_fwd(
            q, k, v, True, None, "bnsh")),
        "flash_bwd_dq": ("flash_bwd.cu", lambda: fa._launch_dq(*bwd)),
        "flash_bwd_dkv": ("flash_bwd.cu", lambda: fa._launch_dkv(*bwd)),
        "splash_fwd": ("splash_attention.cu", lambda: sp._launch_fwd(
            sq, sk, sv, offsets, rows, 128, 128)),
        "splash_bwd_dq": ("splash_attention.cu", lambda: sp._launch_dq(
            sq, sk, sv, sdo, slse, di, offsets, rows, 128, 128)),
        "splash_bwd_dkv": ("splash_attention.cu", lambda: sp._launch_dkv(
            sq, sk, sv, sdo, slse, di, offsets, cols, 128, 128)),
    }
    for name, (source, fn) in kernels.items():
        times = {d: [] for d in libs}
        for _ in range(rounds):
            for d in libs:
                _build._libs[source] = libs[d][source]
                times[d].append(cs.time_ms(fn, launches))
        first = next(iter(libs))
        print(json.dumps({"phase": "interleave", "kernel": name,
                          "launches_per_round": launches, "rounds": rounds,
                          "checkouts": {d: {
                              "median_ms": statistics.median(t),
                              "min_ms": min(t), "max_ms": max(t),
                              "rounds_faster_than_first": sum(
                                  a < b for a, b in zip(t, times[first]))}
                              for d, t in times.items()}}), flush=True)
    return 0


def main(argv) -> int:
    import torch
    rounds = None
    if argv[:1] == ["--interleave"]:
        rounds, argv = int(argv[1]), argv[2:]
    if not torch.cuda.is_available() or not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    if rounds is None:
        return run_turns(argv)
    return run_interleaved(argv, rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

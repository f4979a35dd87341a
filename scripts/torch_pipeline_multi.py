#!/usr/bin/env python3
"""The pipeline's schedules across several cards: GPipe and 1F1B of
GPT-2-small over pp (and dp) in an NCCL gang, against the unpipelined step
on one card.

    python3 scripts/torch_pipeline_multi.py                # 4 cards, NCCL
    python3 scripts/torch_pipeline_multi.py --device cpu   # 4 gloo ranks

Each rank of a gang of four (``ray_tpu_torch.parallel.gang.run_gang``)
builds GPT-2-small from seed 0 (bf16 compute, flash attention, full remat
in the stages, the full-logit head) and takes AdamW steps (3e-4, b2 0.95,
wd 1e-4) on one seeded [32, 1024] batch in 8 microbatches, for each mesh,
pp=4 (3 layers a stage) and pp=2 x dp=2, and each schedule,
``make_pipeline_train_step`` (GPipe) and ``make_1f1b_train_step``.  Rank 0
first takes the unpipelined step of the same configuration.  For each
(mesh, schedule) one JSON line: the first step's loss and grad norm and
their relative distance from the unpipelined step's (at most 1e-2, the
bf16 limit of ``chip_smoke.py``'s pipeline phase), ms per step and
tokens per second over the timed steps and rank 0's time of each,
peak memory (the most of any rank), each rank's flash launches per step,
and the time of the all-reduce that sums the whole gradient over the
mesh at the end of the backward (``pipeline._SumGrads``: one flat f32
buffer of every parameter, each mesh dim larger than 1 in turn; the mean
of 5 after a warm one).  The card's name and power
limit come first.  ``--device cpu`` runs a tiny config on four gloo ranks
(a rehearsal: no kernel launches).  Exits nonzero when a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RTOL = 1e-2
WORLD = 4


def _config(device_type: str):
    import torch
    from ray_tpu_torch.models import GPTConfig
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), attention="flash",
                              remat=True, remat_policy="full")
    if device_type == "cpu":
        cfg = dataclasses.replace(cfg, vocab_size=256, max_seq_len=64,
                                  num_layers=4, num_heads=4, embed_dim=64,
                                  dtype=torch.float32)
    return cfg


def _rank(rank, world, device_type, B, S, M, steps):
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.gpt import make_train_state, make_train_step
    from ray_tpu_torch.ops.flash_attention import flash_attention as fa
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.parallel import pipeline as pl

    cuda = device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    cfg = _config(device_type)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen).to(dev)}

    def state():
        return make_train_state(0, cfg, learning_rate=3e-4,
                                weight_decay=1e-4, device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = {"allreduce_ms": {}}
    if rank == 0:
        params, opt = state()
        m = make_train_step(cfg, opt)(params, batch)
        out["unpipelined"] = (float(m["loss"]), float(m["grad_norm"]))
        del params, opt, m
    dist.barrier()
    for spec in (MeshSpec(pp=4), MeshSpec(dp=2, pp=2)):
        mesh = spec.build(device_type)
        for name, make in (("gpipe", pl.make_pipeline_train_step),
                           ("1f1b", pl.make_1f1b_train_step)):
            params, opt = state()
            step = make(cfg, opt, mesh, num_microbatches=M)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            fa.launches = fa.dq_launches = fa.dkv_launches = 0
            first = step(params, batch)
            sync()
            launches = [fa.launches, fa.dq_launches, fa.dkv_launches]
            dist.barrier()
            t0 = time.perf_counter()
            losses, step_ms = [], []
            for _ in range(steps):
                t1 = time.perf_counter()
                losses.append(float(step(params, batch)["loss"]))
                step_ms.append((time.perf_counter() - t1) * 1e3)
            sync()
            dist.barrier()
            secs = time.perf_counter() - t0
            out[f"{spec.pp}x{spec.dp} {name}"] = {
                "loss": float(first["loss"]),
                "grad_norm": float(first["grad_norm"]),
                "losses": [float(first["loss"])] + losses,
                "ms_per_step": secs / steps * 1e3,
                "ms_steps_rank0": step_ms,
                "tokens_per_s": B * S * steps / secs,
                "peak_memory_gb": (torch.cuda.max_memory_allocated(dev)
                                   / 1e9 if cuda else None),
                "flash_launches_first_step": launches}
            del params, opt, step, first
        out["allreduce_ms"][f"{spec.pp}x{spec.dp}"] = _allreduce_ms(
            cfg, mesh, dev, sync)
    return out


def _allreduce_ms(cfg, mesh, dev, sync, reps=5):
    """ms of the pipeline's gradient sum: every parameter's gradient in
    one flat f32 buffer, all-reduced over each mesh dim larger than 1."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.gpt import _leaves, gpt_init
    from ray_tpu_torch.parallel import pipeline as pl
    n = sum(t.numel() for t in _leaves(gpt_init(0, cfg, device="meta")))
    flat = torch.zeros(n, dtype=torch.float32, device=dev)
    groups = pl._groups(mesh.mesh_dim_names, mesh)

    def reduce():
        for group in groups:
            dist.all_reduce(flat, group=group)
    reduce()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        reduce()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from ray_tpu_torch.parallel.gang import run_gang

    cuda = args.device == "cuda"
    if cuda and torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    B, S, M = (32, 1024, 8) if cuda else (8, 64, 4)
    card = None
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        print(card[0], flush=True)
    res = run_gang(_rank, WORLD, (args.device, B, S, M, args.steps),
                   timeout_s=900, backend="nccl" if cuda else "gloo")
    loss0, norm0 = res[0]["unpipelined"]
    cfg = _config(args.device)
    ok = True
    for key in res[0]:
        if key in ("unpipelined", "allreduce_ms"):
            continue
        r = res[0][key]
        line = {"case": key, "world": WORLD, "batch": B, "seq": S,
                "microbatches": M, "layers": cfg.num_layers,
                "dtype": str(cfg.dtype), "unpipelined_loss": loss0,
                "unpipelined_grad_norm": norm0,
                "loss_rel_diff": abs(r["loss"] - loss0) / loss0,
                "grad_norm_rel_diff": abs(r["grad_norm"] - norm0) / norm0,
                **r,
                "grad_allreduce_ms": res[0]["allreduce_ms"][key.split()[0]],
                "peak_memory_gb_max_rank": (max(o[key]["peak_memory_gb"]
                                                for o in res) if cuda
                                            else None),
                "flash_launches_first_step_by_rank": [
                    o[key]["flash_launches_first_step"] for o in res],
                "card": card}
        ok &= (line["loss_rel_diff"] <= RTOL
               and line["grad_norm_rel_diff"] <= RTOL
               and all(map(lambda x: x == x, r["losses"])))
        print(json.dumps(line), flush=True)
    print(json.dumps({"ok": ok, "device": args.device, "world": WORLD}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's limits are set from, in one process on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 101,102,... \
        [--control-seeds 201,...] [--control-kind hybrid|e4m3] \
        [--faults half,token] [--fault-seeds ...] [--seconds 12]

One JSON line per reading on standard output: the program's numbers on each
seed (a run of the cell as ``run.py`` makes it, with a short window); the
control's, the reference computed from fp8 operands in the program's place
(training: its steps against the f32 reference's; serving: at each position
of the sampled requests, the gap of the token the fp8 model puts first); and
the program's with a fault planted in its timed path (``FAULTS``).  The
training control is fp8 training's hybrid format (``reference.gpt``'s
``low``); ``--control-kind e4m3`` leaves its gradients unrounded (e4m3
operands alone).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _half_batch(driver):
    """Each step takes the first half of its batch's rows: the mean is
    over the rest."""
    make = driver.make_step

    def broken(cfg, opt):
        step = make(cfg, opt)

        def half(params, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, {"tokens": batch["tokens"][:rows]})
        return half
    driver.make_step = broken
    try:
        yield
    finally:
        driver.make_step = make


@contextlib.contextmanager
def _unchanged(driver):
    """Each step computes its loss and grads and leaves the state as it
    was: the optimizer never steps."""
    make = driver.make_step

    def broken(cfg, opt):
        opt.step = lambda *a, **k: None
        return make(cfg, opt)
    driver.make_step = broken
    try:
        yield
    finally:
        driver.make_step = make


TOKEN_EVERY = 16


@contextlib.contextmanager
def _token(driver):
    """Every ``TOKEN_EVERY``-th decode step hands each slot the next token
    id after the one the model chose."""
    from ray_tpu_torch.serve.engine.engine import InferenceEngine
    decode = InferenceEngine._decode
    calls = [0]

    def broken(self, token, pos, tables):
        out = decode(self, token, pos, tables)
        calls[0] += 1
        if calls[0] % TOKEN_EVERY == 0:
            out = (out + 1) % self.model_config.vocab_size
        return out
    InferenceEngine._decode = broken
    try:
        yield
    finally:
        InferenceEngine._decode = decode


@contextlib.contextmanager
def _kv_unchanged(driver):
    """Decode steps write no key or value into the pools: the cache's
    state stays as the prefill left it."""
    from ray_tpu_torch.models import gpt
    append = gpt.append_kv
    gpt.append_kv = lambda k, v, *a: (k, v)
    try:
        yield
    finally:
        gpt.append_kv = append


@contextlib.contextmanager
def _e4m3_only():
    """The control's gradients left unrounded: e4m3 operands alone."""
    from perfbench.reference import gpt as reference
    apply = reference._E5M2Grad.apply
    reference._E5M2Grad.apply = staticmethod(lambda x: x)
    try:
        yield
    finally:
        reference._E5M2Grad.apply = apply


FAULTS = {"half": _half_batch, "unchanged": _unchanged, "token": _token,
          "kv": _kv_unchanged}


def program_numbers(root, workload, seed, seconds, device, fault=None,
                    control=False):
    """The numbers of one run of the cell (short window), with a fault
    planted when named; serving with ``control`` adds the control's."""
    from perfbench import run, spec
    cell = spec.load(root, workload)
    ctx = run.Context(cell, seed, seconds, False, device,
                      time.perf_counter())
    ctx.control = control
    driver = spec.module(cell.base, "drivers", cell.traffic["driver"])
    with (FAULTS[fault](driver) if fault else contextlib.nullcontext()):
        return driver.run(ctx)["numbers"]


def train_control(root, workload, seed, device):
    """The fp8 reference's steps against the f32 reference's."""
    from perfbench import compare, spec, traffic, weights
    from perfbench.reference import gpt as reference
    cell = spec.load(root, workload)
    m, tr, hp = (weights.sizes(cell.config), cell.traffic,
                 cell.config["train"])
    pool = traffic.train_batches(tr, m["token_vocab"], seed, device)
    batches = pool[:tr["check_steps"]]
    reference.no_tf32()
    ref = reference.train_readings(m, weights.make_params(m, seed, device),
                                   batches, hp)
    low = reference.train_readings(m, weights.make_params(m, seed, device),
                                   batches, hp, low=True)
    return {k: v[0] for k, v in compare.train_numbers(low, ref).items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-kind", choices=("hybrid", "e4m3"),
                   default="hybrid")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from perfbench import run, spec
    run.environment(run.ROOT)
    import torch
    dev = torch.device("cuda", 0)
    root = run.ROOT
    kind = spec.load(root, args.workload).traffic["driver"]

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        numbers = program_numbers(root, args.workload, seed, args.seconds,
                                  dev)
        emit(seed=seed, kind="program", s=time.perf_counter() - t,
             numbers=numbers)
    control = f"control:{args.control_kind}"
    for seed in seeds(args.control_seeds):
        with (_e4m3_only() if args.control_kind == "e4m3"
              else contextlib.nullcontext()):
            numbers = (train_control(root, args.workload, seed, dev)
                       if kind == "train" else
                       program_numbers(root, args.workload, seed,
                                       args.seconds, dev, control=True))
        emit(seed=seed, kind=control, numbers=numbers)
    for fault in (f for f in args.faults.split(",") if f):
        for seed in seeds(args.fault_seeds):
            emit(seed=seed, kind=f"fault:{fault}",
                 numbers=program_numbers(root, args.workload, seed,
                                         args.seconds, dev, fault=fault))
    return 0


if __name__ == "__main__":
    sys.exit(main())

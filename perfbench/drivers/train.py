"""Training cells: AdamW steps of the port's ``make_train_step`` on batches of
the traffic's size.

Set-up makes the weights on the device from the seed, builds the one step
object (the port's step over the port's AdamW, with the configuration's
settings), and drives it through the traffic's ``check_steps`` first steps,
each on its own batch of the pool: those are the warm-up, and their losses,
the first gradient as AdamW holds it and the params' change are read on the
way.  The window runs the same object on the pool's batches in turn until
``seconds`` have passed on the host, then waits for the card: the window
ends when the last step enqueued has ended.  No step waits for the one
before (the port keeps a step's metrics on the device so that a loop need
not), so the host's launches for a step overlap the card's work on the last.  Afterwards the program's state is freed and the
reference follows the first steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import compare, traffic, weights
from perfbench.reference import gpt as reference
from perfbench.trace import Window


def program_config(m, train):
    from ray_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(
        vocab_size=m["vocab_size"], max_seq_len=m["max_seq_len"],
        num_layers=m["num_layers"], num_heads=m["num_heads"],
        embed_dim=m["embed_dim"], mlp_ratio=m["mlp_dim"] // m["embed_dim"],
        dtype=getattr(torch, train["dtype"]), remat=True,
        remat_policy=train["remat_policy"], attention=train["attention"],
        ce_block=train["ce_block"], num_experts=m["num_experts"],
        expert_top_k=m["expert_top_k"] or 2,
        capacity_factor=m["capacity_factor"] or 1.25,
        moe_aux_coef=m["moe_aux_coef"])


def make_optimizer(params, hp):
    """(params, AdamW over them) from the port's own constructor, the one
    every family's ``make_train_state`` uses, with the configuration's
    rate and decay; its betas and eps are the port's, and have to be the
    configuration's."""
    from ray_tpu_torch.models.gpt import _adamw_state
    params, opt = _adamw_state(params, hp["learning_rate"],
                               hp["weight_decay"])
    got = opt.defaults
    if list(got["betas"]) != list(hp["betas"]) or got["eps"] != hp["eps"]:
        raise ValueError(f"the port's AdamW has betas {got['betas']} and "
                         f"eps {got['eps']}; the configuration states "
                         f"{hp['betas']} and {hp['eps']}")
    return params, opt


def make_step(cfg, optimizer):
    """The window's call: ``step(params, batch)``."""
    from ray_tpu_torch.models.gpt import make_train_step
    return make_train_step(cfg, optimizer)


def _grad_norms(params, optimizer, beta1):
    """Each leaf part's first gradient, as AdamW holds it after one step:
    its first moment over (1 - beta1); zero for a leaf it never moved."""
    out = {}
    for name, p in weights.named_leaves(params):
        st = optimizer.state.get(p, {})
        g = st["exp_avg"] / (1 - beta1) if "exp_avg" in st else \
            torch.zeros_like(p)
        out[name] = weights.slice_norms(name, g)
    return out


def _change(params, m, seed):
    return {name: weights.slice_norms(
                name, p.detach() - weights.make_leaf(m, seed, name, p.device))
            for name, p in weights.named_leaves(params)}


def _intervals(xs, side):
    """Median, longest and the longest five of a window's step intervals,
    in seconds, for the run's log: a stall shows as a few long ones."""
    if not xs:
        return {}
    xs = sorted(xs)
    return {f"{side}_median_s": xs[len(xs) // 2], f"{side}_max_s": xs[-1],
            f"{side}_top5_s": xs[-5:][::-1]}


def run(ctx):
    m, hp, tr = ctx.sizes, ctx.config["train"], ctx.traffic
    dev = ctx.device
    cfg = program_config(m, hp)
    ctx.mark("program_import")
    params = weights.make_params(m, ctx.seed, dev)
    ctx.mark("weights")
    params, opt = make_optimizer(params, hp)
    step = make_step(cfg, opt)
    pool = traffic.train_batches(tr, m["token_vocab"], ctx.seed, dev)
    tokens_per_step = tr["batch"] * tr["seq"]

    n_check = tr["check_steps"]
    prog = {"losses": []}
    for i in range(n_check):
        out = step(params, {"tokens": pool[i]})
        prog["losses"].append(float(out["loss"]))
        if i == 0:
            ctx.mark("first_step")
            prog["grad_norms"] = _grad_norms(params, opt, hp["betas"][0])
    ctx.mark("check_steps")
    prog["change"] = _change(params, m, ctx.seed)
    ctx.sync()
    ctx.mark("change_norms")
    ctx.log("set-up", check_losses=prog["losses"])

    losses, at, host_t, ends = [], [n_check], [], []

    def one():
        losses.append(step(params, {"tokens": pool[at[0] % len(pool)]})
                      ["loss"])
        at[0] += 1
        host_t.append(time.perf_counter())
        ends.append(ctx.event())

    trace, traced = None, 0
    w0 = time.perf_counter()
    ctx.window_opens()
    while True:
        if ctx.trace and trace is None and traced < 2:
            # One step under the profiler before the traced window opens.
            win = Window()
            win.start()
            one()
            win.open()
            for _ in range(tr["trace_steps"]):
                one()
            trace = win.stop()
            traced += 1
        else:
            one()
        if time.perf_counter() - w0 >= ctx.seconds:
            break
    sent = time.perf_counter()
    ctx.sync()
    window_s = time.perf_counter() - w0
    ctx.log("window_steps", drain_s=w0 + window_s - sent,
            **_intervals([b - a for a, b in zip(host_t, host_t[1:])],
                         "host"),
            **_intervals([a.elapsed_time(b) / 1e3
                          for a, b in zip(ends, ends[1:])] if ends[0]
                         else [], "device"))
    steps = len(losses)
    peak = ctx.memory_peak()
    failed = sum(1 for x in losses if not torch.isfinite(x))
    del step, opt, params, out, losses
    gc.collect()
    ctx.free_cache()

    reference.no_tf32()
    ref = reference.train_readings(m, weights.make_params(m, ctx.seed, dev),
                                   pool[:n_check], hp)
    numbers = compare.train_numbers(prog, ref)
    ctx.log("reference", losses=ref["losses"], numbers=numbers)
    return {
        "attempted": steps, "failed": failed, "memory_peak_bytes": peak,
        "numbers": {k: v[0] for k, v in numbers.items()},
        "window_s": window_s, "steps": steps,
        "tokens_in_window": steps * tokens_per_step,
        "tokens_per_step": tokens_per_step,
        "n_params": weights.n_params(m), "seq": tr["seq"],
        "batch": tr["batch"], "trace": trace,
        "trace_steps": tr["trace_steps"] if trace else 0,
    }

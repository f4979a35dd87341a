"""What the serving drivers share: the port's engine over the seed's weights,
the client that records every token it is handed, the correctness sample
and the run record the readers take.

Each request's record holds when it was sent, its prompt length,
the time of each token and the engine's step counter (``stats()["steps"]``)
read when the token arrived, which names the decode step that produced it.
Spans: a request runs from its call into ``generate`` to its first token to
its end.
"""

from __future__ import annotations

import asyncio
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import gpt as reference
from perfbench.trace import Window


def build_engine(m, serve, params, device):
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
    dt = getattr(torch, serve["dtype"])
    cfg = GPTConfig(vocab_size=m["vocab_size"], max_seq_len=m["max_seq_len"],
                    num_layers=m["num_layers"], num_heads=m["num_heads"],
                    embed_dim=m["embed_dim"],
                    mlp_ratio=m["mlp_dim"] // m["embed_dim"], dtype=dt,
                    remat=False)
    return InferenceEngine(EngineConfig(
        model="gpt", model_config=cfg, page_size=serve["page_size"],
        num_pages=serve["num_pages"], max_batch=serve["max_batch"],
        max_prompt_len=serve["max_prompt_len"],
        max_new_tokens=serve["max_new_tokens"], eos_token=None, dtype=dt,
        device=device), params=params)


def new_record(prompt, max_new) -> Dict:
    return {"prompt": prompt, "prompt_len": len(prompt), "max_new": max_new,
            "sent": None, "times": [], "steps": [], "tokens": [],
            "done": False, "error": None}


async def consume(engine, rec: Dict) -> None:
    """One request through ``generate``; every token recorded on arrival."""
    rec["sent"] = time.perf_counter()
    try:
        async for tok in engine.generate(rec["prompt"], rec["max_new"]):
            rec["times"].append(time.perf_counter())
            rec["steps"].append(engine.stats()["steps"])
            rec["tokens"].append(int(tok))
        rec["done"] = True
    except asyncio.CancelledError:
        raise
    except Exception as e:   # noqa: BLE001 - a failed request is counted
        rec["error"] = repr(e)


async def warm(ctx, engine, prompt: List[int]) -> None:
    """The cell's shapes once: one prefill (padded to ``max_prompt_len``)
    and one decode step over every slot."""
    rec = new_record(prompt, 2)
    await consume(engine, rec)
    if rec["error"]:
        raise RuntimeError(f"warm-up request failed: {rec['error']}")
    ctx.mark("warm")


async def trace_tail(ctx, w1: float):
    """Sleep until ``w1``; with ``--trace 1`` a traced window is opened
    over the last ``trace_seconds`` (the profiler started half a second
    before it) and returned running, for the caller to stop once it has
    read the window's end."""
    win = None
    if ctx.trace:
        opens = w1 - ctx.traffic["trace_seconds"]
        await asyncio.sleep(max(0.0, opens - 0.5 - time.perf_counter()))
        win = Window()
        win.start()
        await asyncio.sleep(max(0.0, opens - time.perf_counter()))
        win.open()
    await asyncio.sleep(max(0.0, w1 - time.perf_counter()))
    return win


async def drain(engine, tasks) -> None:
    """Cancel what is still running and wait until the engine is idle, so
    that no device work is in flight when it is closed."""
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    while engine.stats()["active"] or engine.stats()["waiting"]:
        await asyncio.sleep(0.005)


def finish(ctx, engine, params, records: List[Dict], trace, window,
           steps, extra: Dict) -> Dict:
    """Close the engine, then hold a sample of the finished requests
    (drawn from the seed, with the longest) to the reference."""
    peak = ctx.memory_peak()
    engine.close()
    del engine
    gc.collect()
    ctx.free_cache()
    finished = [r for r in records if r["done"] and r["tokens"]]
    if not finished:
        raise RuntimeError("no request finished: nothing to compare")
    rng = np.random.default_rng(ctx.seed + 2)
    k = min(ctx.traffic["check_requests"], len(finished))
    pick = set(rng.choice(len(finished), k, replace=False).tolist())
    pick.add(max(range(len(finished)),
                 key=lambda i: len(finished[i]["tokens"])))
    sample = [(finished[i]["prompt"], finished[i]["tokens"])
              for i in sorted(pick)]
    reference.no_tf32()
    gap, low_gap = reference.served_gaps(ctx.sizes, params, sample,
                                         ctx.control)
    numbers = {"logit_gap": gap}
    if ctx.control:
        numbers["control_logit_gap"] = low_gap
    ctx.log("reference", sampled=len(sample),
            served_tokens=sum(len(t) for _, t in sample))
    w0, w1 = window
    sent = [r for r in records
            if r["sent"] is not None and w0 <= r["sent"] <= w1]
    return dict(extra, **{
        "attempted": len(sent),
        "failed": sum(1 for r in sent if r["error"]),
        "memory_peak_bytes": peak, "numbers": numbers,
        "window": window, "window_s": w1 - w0, "steps_window": steps,
        "requests": [{k: v for k, v in r.items() if k not in ("prompt",
                                                               "tokens")}
                     for r in records],
        "sizes": ctx.sizes, "trace": trace,
    })


def setup(ctx):
    """(engine, params) over the seed's weights."""
    params = weights.make_params(ctx.sizes, ctx.seed, ctx.device)
    ctx.mark("weights")
    engine = build_engine(ctx.sizes, ctx.config["serve"], params, ctx.device)
    ctx.mark("engine")
    return engine, params

"""Closed-loop serving: ``clients`` callers, each sending its next request
through the port's ``InferenceEngine.generate`` as soon as its last one ends.

The clients start in set-up; the window opens at the first decode step with
every slot full, and ``serve_tokens_per_s`` counts every token handed to a
client in the window.
"""

from __future__ import annotations

import asyncio
import time

from perfbench import serving, traffic


async def _main(ctx):
    engine, params = serving.setup(ctx)
    tr = ctx.traffic
    reqs = traffic.requests(tr, ctx.sizes["token_vocab"], ctx.seed)
    await serving.warm(ctx, engine, reqs[0][0])
    records, nxt = [], [0]

    async def client():
        while True:
            rec = serving.new_record(*reqs[nxt[0] % len(reqs)])
            nxt[0] += 1
            records.append(rec)
            await serving.consume(engine, rec)

    steps0 = engine.stats()["steps"]
    tasks = [asyncio.get_running_loop().create_task(client())
             for _ in range(tr["clients"])]
    full = ctx.config["serve"]["max_batch"]
    while engine.stats()["steps"] == steps0 or \
            engine.stats()["active"] < full:
        await asyncio.sleep(0.001)
    w0 = time.perf_counter()
    ctx.window_opens()
    s0 = engine.stats()["steps"]
    win = await serving.trace_tail(ctx, w0 + ctx.seconds)
    w1 = time.perf_counter()
    s1 = engine.stats()["steps"]
    trace = win.stop() if win is not None else None
    await serving.drain(engine, tasks)
    return serving.finish(ctx, engine, params, records, trace, (w0, w1),
                          (s0, s1), {})


def run(ctx):
    return asyncio.run(_main(ctx))

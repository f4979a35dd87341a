"""The program's spans against a cell's window: one run of a cell as
``perfbench/run.py`` makes it, with the span recorder of
``ray_tpu_torch.util.tracing`` on, and the spans reduced beside the
harness's own reduction.  No cell runs this file; its readings go to a
file of their own.

    python3 perfbench/spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--record 0] --out <file.json>

Each traced window's profiler events are reduced with the spans recorded
until the window's end (``reduce_spans``):

- ``by_span``: device seconds of the window's kernels, each counted to the
  innermost span open at the host time of its launch record
  (``cudaLaunch*``/``cuLaunch*``, matched by correlation id), across
  threads; kernels with no launch record go to ``unlaunched_s``;
- ``idle_gaps``: the harness's idle gaps by host event
  (``trace._gaps_by_host``, its rule unchanged) with the spans among the
  host events, so a gap that no op names is named by the span open at its
  start; ``none_named_by``: how the gaps no op names split among spans.

Serving's engine lane is split over the part of the window before the
profiler starts (``serving_split``), where the profiler does not slow the
host; with ``--trace 0``, over the whole window.  The readings a
``per_layer`` entry would take are under ``metrics``, by those names, and
the autotune cache's misses and the nvcc builds over the window under
``rebuilds`` (both should be 0).  ``--record 0`` runs the cell with the
recorder off, for its cost.

To reach the window it wraps, in this process alone,
``trace.reduce_events``, ``trace.Window.start`` and the cell's driver: the
harness's files are read, not changed, and ``run.py``'s result line is
printed as it prints it.
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "perfbench"):
    sys.path[0] = ROOT

from perfbench import trace  # noqa: E402

LANE = ("engine.prefill", "engine.decode")
ENGINE = LANE + ("engine.schedule", "engine.deliver")


def innermost(points, intervals) -> List[Optional[str]]:
    """For each time of ``points`` (ascending), the name of the interval
    ``(start, end, name)`` open at it with the latest start, or None: the
    rule of ``trace._gaps_by_host``."""
    ivs = sorted(intervals)
    heap: List = []
    i, out = 0, []
    for t in points:
        while i < len(ivs) and ivs[i][0] <= t:
            heapq.heappush(heap, (-ivs[i][0], ivs[i][1], ivs[i][2]))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _split(events):
    """(kernels (start, end, correlation id), host events (start, end,
    name), launch host time by correlation id, the window or None), as
    ``trace.reduce_events`` sorts them."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host, launch_at, window = [], [], {}, None
    for e in events:
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and name != trace.WINDOW_MARK:
                kernels.append((start, end, e.correlation_id()))
        elif name == trace.WINDOW_MARK:
            window = (start, end)
        else:
            host.append((start, end, name))
            if name.startswith(trace._LAUNCH):
                launch_at[e.correlation_id()] = start
    return kernels, host, launch_at, window


def reduce_spans(events, spans: List[Dict], top: int = 12) -> Optional[Dict]:
    """The window's device time by span and its idle gaps named with the
    spans (module docstring); None without a window.  ``spans`` are the
    recorder's dicts."""
    kernels, host, launch_at, window = _split(events)
    if window is None:
        return None
    w0, w1 = window
    clipped = [(max(a, w0), min(b, w1), c) for a, b, c in kernels
               if min(b, w1) > max(a, w0)]
    sp = [(s["start_ns"], s["end_ns"], s["name"]) for s in spans]
    launched = sorted((launch_at[c], (b - a) / 1e9) for a, b, c in clipped
                      if c in launch_at)
    by_span: Dict[str, float] = {}
    for (_, secs), name in zip(launched,
                               innermost([t for t, _ in launched], sp)):
        key = name or "(no span)"
        by_span[key] = by_span.get(key, 0.0) + secs
    busy, gaps, cursor = 0, [], w0
    for a, b, _ in sorted(clipped):
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if w1 > cursor:
        gaps.append((cursor, w1))
    took: Dict[str, float] = {}
    starts = [g0 for g0, _ in gaps]
    for (g0, g1), op, name in zip(gaps, innermost(starts, host),
                                  innermost(starts, host + sp)):
        if op is None:
            took[name or "(none)"] = took.get(name or "(none)", 0.0) + \
                (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
        "by_span": by_span,
        "unlaunched_s": sum((b - a) / 1e9 for a, b, c in clipped
                            if c not in launch_at),
        "idle_gaps": trace._top(trace._gaps_by_host(gaps, host + sp), top),
        "none_named_by": trace._top(took, top),
    }


def _covered(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] inside the union of ``intervals``."""
    total, cursor = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, cursor), min(b, hi)
        if b > a:
            total += b - a
            cursor = b
    return total


def serving_split(spans: List[Dict], lo: int, hi: int) -> Dict:
    """The engine's spans that lie wholly in [lo, hi] (ns): for each name
    its count, median ms and share of the part; ``lane_idle_pct``, the
    share in which neither a prefill nor a decode span was open."""
    inside = [s for s in spans if s["start_ns"] >= lo and s["end_ns"] <= hi]
    part = hi - lo
    out: Dict = {"part_s": part / 1e9}
    for name in ENGINE:
        ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in inside
              if s["name"] == name]
        out[name] = {"count": len(ms),
                     "median_ms": statistics.median(ms) if ms else None,
                     "share_pct": 100 * sum(ms) / 1e3 / (part / 1e9)}
    lane = [(s["start_ns"], s["end_ns"]) for s in inside
            if s["name"] in LANE]
    out["lane_idle_pct"] = 100 * (1 - _covered(lane, lo, hi) / part)
    active = [s["attributes"]["active"] for s in inside
              if s["name"] == "engine.decode"]
    out["active_median"] = statistics.median(active) if active else None
    return out


def metrics(windows: List[Dict], steps: int,
            serving: Optional[Dict]) -> Dict[str, float]:
    """The per-layer readings, by the names of their ``per_layer``
    entries: training's from the last window the harness kept, in ms a
    traced step; serving's from the split."""
    out: Dict[str, float] = {}
    kept = [w for w in windows if w["kept"] and w["spans"]]
    if kept and steps:
        by = kept[-1]["spans"]["by_span"]
        for name, span in (("optimizer_ms_per_step.train", "train.optimizer"),
                           ("moe_ms_per_step.train", "moe.ffn")):
            if span in by:
                out[name] = 1e3 * by[span] / steps
    if serving and serving["engine.decode"]["count"]:
        out["decode_step_ms.serve"] = serving["engine.decode"]["median_ms"]
        out["prefill_ms.serve"] = serving["engine.prefill"]["median_ms"]
        out["lane_idle.serve"] = serving["lane_idle_pct"]
    return out


def _counters() -> Dict[str, int]:
    from ray_tpu_torch.autotune import metrics as tune
    from ray_tpu_torch.ops import _build
    return {"autotune_misses": tune.stats()["autotune_cache_misses"],
            "nvcc_builds": _build.build_count()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    from perfbench import run, spec
    run.environment(ROOT)    # before the port's import, as run.py orders it
    from ray_tpu_torch.util import tracing

    spans: List[Dict] = []
    windows: List[Dict] = []
    state: Dict = {"prof_start_ns": None, "run": {}, "counters": {}}
    reduce_events, window_start, load = (trace.reduce_events,
                                         trace.Window.start, spec.module)

    def reduce_wrapped(events, top=10):
        out = reduce_events(events, top)
        if a.record:
            spans.extend(tracing.stop_recording())
            tracing.start_recording()
        windows.append({"kept": out is not None,
                        "spans": reduce_spans(events, spans)})
        return out

    def start_wrapped(self):
        window_start(self)
        state["prof_start_ns"] = time.time_ns()

    def module_wrapped(base, kind, name):
        mod = load(base, kind, name)
        if kind != "drivers" or getattr(mod, "_spans_wrapped", False):
            return mod
        inner = mod.run

        def run_wrapped(ctx):
            opens, peak = ctx.window_opens, ctx.memory_peak

            def window_opens():
                state["counters"]["window_open"] = _counters()
                opens()

            def memory_peak():   # the drivers' first call after the window
                state["counters"].setdefault("window_end", _counters())
                return peak()
            ctx.window_opens, ctx.memory_peak = window_opens, memory_peak
            state["run"] = inner(ctx)
            return state["run"]
        mod.run, mod._spans_wrapped = run_wrapped, True
        return mod

    trace.reduce_events, trace.Window.start = reduce_wrapped, start_wrapped
    spec.module = module_wrapped
    offset_ns = time.time_ns() - time.perf_counter_ns()
    if a.record:
        tracing.start_recording()
    rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(a.seconds), "--trace", str(a.trace)])
    spans.extend(tracing.stop_recording())
    rec, counters = state["run"], state["counters"]
    serving = None
    if spans and "window" in rec:
        lo, hi = (int(t * 1e9) + offset_ns for t in rec["window"])
        if a.trace and state["prof_start_ns"]:
            hi = min(hi, state["prof_start_ns"])
        serving = serving_split(spans, lo, hi)
    out = {"workload": a.workload, "seed": a.seed, "trace": a.trace,
           "record": a.record, "rc": rc, "n_spans": len(spans),
           "rebuilds": ({k: counters["window_end"][k]
                         - counters["window_open"][k]
                         for k in counters["window_open"]}
                        if len(counters) == 2 else None),
           "harness_busy_s": (rec.get("trace") or {}).get("busy_s"),
           "trace_steps": rec.get("trace_steps"),
           "windows": windows, "serving": serving,
           "metrics": metrics(windows, rec.get("trace_steps") or 0,
                              serving)}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    brief = {k: out[k] for k in ("workload", "seed", "trace", "record",
                                 "n_spans", "rebuilds", "harness_busy_s",
                                 "metrics")}
    brief["by_span"] = [w["spans"] and w["spans"]["by_span"]
                        for w in windows]
    brief["none_named_by"] = [w["spans"] and w["spans"]["none_named_by"]
                              for w in windows]
    print("spans " + json.dumps(brief), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

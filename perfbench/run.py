"""Run one cell of ``BENCHMARK.json`` once, on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It makes the cell's weights and inputs from the seed, warms up every shape
the cell uses (set-up), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit, which also end standard
error.  Progress goes to standard error as JSON lines.

It exits non-zero and prints no result when there is no CUDA card or fewer
than the cell asks for, when the program or the benchmark fails, or when
JAX or the JAX package (``ray_tpu``) was loaded in this process.  Build and
kernel caches stay inside the checkout (``ray_tpu_torch/_build``, the
port's own; ``perfbench/_cache`` for Triton and torch extensions); the
autotune cache is a file of the run's ``TMPDIR``, removed at start, so that
no record carries over between runs.  CUDA's launch queues are four
times their default, so that the host can dispatch further ahead.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time


def _process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (from the
    kernel's clock ticks), so that set-up counts the interpreter's start."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_PROCESS = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Run as a script, this file's own directory heads sys.path, where its
# sibling modules would shadow the standard library's (``trace``): the
# checkout's root takes its place.
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "perfbench"):
    sys.path[0] = ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def environment(root: str) -> None:
    cache = os.path.join(root, "perfbench", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    tune = os.path.join(tempfile.gettempdir(), "perfbench-autotune.jsonl")
    if os.path.exists(tune):
        os.remove(tune)
    os.environ["RT_AUTOTUNE_CACHE"] = tune
    os.environ["RT_AUTOTUNE_ON_MISS"] = "default"
    # Four times CUDA's default launch queues: the host may run some
    # 0.3 s of kernels ahead of the card (a training step of GPT-2 XL, ~0.45
    # of one), so that a short pause of the host's does not leave the card
    # idle inside the window.
    os.environ["CUDA_SCALE_LAUNCH_QUEUES"] = "4x"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(phase: str, **fields) -> None:
    print(json.dumps({"perfbench": phase, **fields}, default=str),
          file=sys.stderr, flush=True)


class Context:
    """What a driver is handed: the cell's pieces, the run's arguments,
    and the card's few operations (a CPU device makes them no-ops)."""

    def __init__(self, cell, seed, seconds, trace, device, t_start):
        from perfbench import weights
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.config, self.traffic = cell.config, cell.traffic
        self.sizes = weights.sizes(cell.config)
        self.setup_s = None
        self.control = False      # serving: also read the fp8 control
        self.log = log

    def mark(self, phase: str) -> None:
        """Log the seconds from the start to the end of a set-up phase."""
        log("phase", name=phase, at_s=time.perf_counter() - self.t_start)

    def window_opens(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start
        log("window", setup_s=self.setup_s)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event(self):
        """A timing event recorded on the card's stream now (None on a
        CPU device)."""
        import torch
        if self.device.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free_cache(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(root, workload, seed, seconds, trace, device, t_start):
    """One run of the cell on ``device``: (result object, checks)."""
    import torch
    from perfbench import spec
    cell = spec.load(root, workload)
    ctx = Context(cell, seed, seconds, trace, device, t_start)
    driver = spec.module(cell.base, "drivers", cell.traffic["driver"])
    run = driver.run(ctx)
    run["setup_s"] = ctx.setup_s
    run["sizes"] = ctx.sizes
    checks = {name: {"value": run["numbers"][name], "limit": limit}
              for name, limit in cell.limits["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.module(cell.base, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.entry["chips"],
           "memory_peak_bytes": run["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": dev}
    tr = run.get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment(ROOT)
    import torch
    log("phase", name="torch_import", at_s=time.perf_counter() - T_PROCESS)
    from perfbench import spec
    chips = spec.load(ROOT, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    log("phase", name="cuda_init", at_s=time.perf_counter() - T_PROCESS)
    result, checks = run_cell(ROOT, args.workload, args.seed % (1 << 63),
                              args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_PROCESS)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"perfbench: this process loaded {', '.join(loaded)}: the "
              f"port is measured without JAX and without the JAX package",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Core microbenchmark (`ray microbenchmark` equivalent).

Port of ``ray_tpu/_private/microbenchmark.py``.

Reference analog: ``python/ray/_private/ray_perf.py`` run by
``release/microbenchmark/run_microbenchmark.py``; baseline numbers in
BASELINE.md come from release_logs/2.2.0/microbenchmark.json (m5.16xlarge).

Each workload runs for a fixed wall-time budget and reports calls/s (mean
over repeats).  Run directly::

    python -m ray_tpu_torch._private.microbenchmark [--quick]

prints one JSON line per metric: {"metric", "value", "unit", "baseline",
"vs_baseline"} — vs_baseline > 1.0 beats the reference's recorded number.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np

# Ray 2.2.0's release numbers (release_logs/2.2.0/microbenchmark.json,
# one AWS m5.16xlarge host, CPU only): a host yardstick, no accelerator's.
BASELINES = {
    "1_1_actor_calls_sync": 2181.5,
    "1_1_actor_calls_async": 5770.0,
    "1_n_actor_calls_async": 11646.4,
    "n_n_actor_calls_async": 35151.9,
    "tasks_per_second": 27.1,       # many_tasks end-to-end rate
    "put_calls_per_second": None,   # no direct published equivalent
    "put_gigabytes_per_second": 0.046,  # client put GiB/s (closest analog)
}


def _timeit(fn: Callable[[], int], budget_s: float,
            repeats: int = 3) -> float:
    """Run fn (returns ops done) until budget per repeat; mean ops/s."""
    rates = []
    for _ in range(repeats):
        t0 = time.monotonic()
        ops = 0
        while time.monotonic() - t0 < budget_s:
            ops += fn()
        rates.append(ops / (time.monotonic() - t0))
    return float(np.mean(rates))


def run_microbenchmark(budget_s: float = 2.0,
                       select: Optional[List[str]] = None) -> Dict[str, float]:
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0.25)
    class Echo:
        def ping(self, x=None):
            return x

    @ray_tpu_torch.remote(num_cpus=0.25)
    class Caller:
        """n:n source: drives async call batches at a target actor."""

        def __init__(self, target):
            self.target = target

        def drive(self, batch: int) -> int:
            ray_tpu_torch.get([self.target.ping.remote()
                               for _ in range(batch)])
            return batch

    @ray_tpu_torch.remote(num_cpus=0.25)
    def noop():
        return None

    results: Dict[str, float] = {}

    def want(name: str) -> bool:
        return select is None or name in select

    if want("1_1_actor_calls_sync"):
        a = Echo.remote()
        ray_tpu_torch.get(a.ping.remote())  # warm
        results["1_1_actor_calls_sync"] = _timeit(
            lambda: (ray_tpu_torch.get(a.ping.remote()), 1)[1], budget_s)

    if want("1_1_actor_calls_async"):
        a = Echo.remote()
        ray_tpu_torch.get(a.ping.remote())

        def batch_async():
            ray_tpu_torch.get([a.ping.remote() for _ in range(100)])
            return 100
        results["1_1_actor_calls_async"] = _timeit(batch_async, budget_s)

    if want("1_n_actor_calls_async"):
        actors = [Echo.remote() for _ in range(4)]
        ray_tpu_torch.get([x.ping.remote() for x in actors])

        def one_to_n():
            ray_tpu_torch.get([x.ping.remote() for x in actors
                         for _ in range(25)])
            return 100
        results["1_n_actor_calls_async"] = _timeit(one_to_n, budget_s)

    if want("n_n_actor_calls_async"):
        targets = [Echo.remote() for _ in range(4)]
        callers = [Caller.remote(t) for t in targets]
        ray_tpu_torch.get([c.drive.remote(1) for c in callers])

        def n_to_n():
            ray_tpu_torch.get([c.drive.remote(25) for c in callers])
            return 100
        results["n_n_actor_calls_async"] = _timeit(n_to_n, budget_s)

    if want("tasks_per_second"):
        # Warm the worker pool with a full-width batch first, otherwise the
        # measurement is dominated by one-time worker spawns.
        ray_tpu_torch.get([noop.remote() for _ in range(16)])

        def task_batch():
            ray_tpu_torch.get([noop.remote() for _ in range(16)])
            return 16
        results["tasks_per_second"] = _timeit(task_batch, budget_s)

    if want("put_calls_per_second"):
        small = np.ones(16)

        def puts():
            for _ in range(50):
                ray_tpu_torch.put(small)
            return 50
        results["put_calls_per_second"] = _timeit(puts, budget_s)

    if want("put_gigabytes_per_second"):
        big = np.ones(2_000_000, dtype=np.float64)  # 16 MB
        gb = big.nbytes / (1 << 30)

        def put_big():
            ref = ray_tpu_torch.put(big)
            del ref
            return 1
        rate = _timeit(put_big, budget_s)
        results["put_gigabytes_per_second"] = rate * gb

    return results


def main(budget_s: float = 2.0) -> List[dict]:
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=8)
    try:
        results = run_microbenchmark(budget_s)
    finally:
        ray_tpu_torch.shutdown()
    out = []
    for name, value in results.items():
        base = BASELINES.get(name)
        rec = {"metric": name, "value": round(value, 2),
               "unit": ("GiB/s" if "gigabytes" in name else "calls/s"),
               "baseline": base,
               "vs_baseline": (round(value / base, 3) if base else None)}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


if __name__ == "__main__":
    import sys
    main(0.5 if "--quick" in sys.argv else 2.0)

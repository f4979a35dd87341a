"""Scalability envelope benchmarks: many actors / tasks / placement groups.

Port of ``ray_tpu/_private/scale_bench.py``.

Design analog: reference ``release/benchmarks/distributed/test_many_actors.py``
/ ``test_many_tasks.py`` / ``test_many_pgs.py`` — the published envelope is
10k actors @ 600.4/s, 1k PGs @ 16.8/s, 10k one-second tasks, with GCS
peak RSS tracked (release/benchmarks/README.md; BASELINE.md).  Those run on
a 64-vCPU head + worker fleet; this box is ONE core, so entries report the
same metrics at box-feasible N plus head-process RSS, and vs_baseline
normalizes per-core (reference 600.4 actors/s / 64 vCPU = 9.4 actors/s/core).

Emits one JSON line per metric:
  {"metric": "many_actors_per_sec", "value": ..., "n": ..., "unit": ...,
   "head_rss_mb": ..., "vs_baseline": ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Reference numbers (BASELINE.md, 64-vCPU head node).
REF_ACTORS_PER_SEC = 600.4
REF_PGS_PER_SEC = 16.8
REF_CORES = 64


def _rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") / 1e6
    except Exception:
        return 0.0


def _head_rss_mb() -> float:
    """RSS of the head daemon (GCS+raylet live in it) plus this driver."""
    from ray_tpu_torch._private.worker import global_worker
    total = _rss_mb(os.getpid())
    proc = getattr(global_worker, "_daemon_proc", None)
    if proc is not None and getattr(proc, "pid", None):
        total += _rss_mb(proc.pid)
    return total


def many_actors(n: int) -> dict:
    """Launch n cheap actors, wait until every one answered a method call,
    measure creation throughput; then kill them all."""
    import ray_tpu_torch as rt

    @rt.remote(num_cpus=0)
    class Echo:
        def ping(self):
            return 1

    t0 = time.perf_counter()
    actors = [Echo.remote() for _ in range(n)]
    # One ping per actor proves each is alive (same readiness definition
    # as the reference's test_many_actors).
    rt.get([a.ping.remote() for a in actors], timeout=3600)
    dt = time.perf_counter() - t0
    rss = _head_rss_mb()
    for a in actors:
        rt.kill(a)
    return {"metric": "many_actors_per_sec", "value": round(n / dt, 2),
            "unit": "actors/s", "n": n, "wall_s": round(dt, 1),
            "head_rss_mb": round(rss, 1),
            "vs_baseline": round((n / dt) /
                                 (REF_ACTORS_PER_SEC / REF_CORES), 3)}


def many_tasks(n: int) -> dict:
    """Submit n no-op tasks and drain them: end-to-end scheduler/Raylet
    throughput with a deep queue (reference test_many_tasks uses 1s sleeps
    to hold 10k concurrent; on one core the interesting axis is queue
    depth, not concurrency, so tasks are no-ops)."""
    import ray_tpu_torch as rt

    @rt.remote
    def nop():
        return None

    t0 = time.perf_counter()
    refs = [nop.remote() for _ in range(n)]
    rt.get(refs, timeout=3600)
    dt = time.perf_counter() - t0
    return {"metric": "many_tasks_per_sec", "value": round(n / dt, 2),
            "unit": "tasks/s", "n": n, "wall_s": round(dt, 1),
            "head_rss_mb": round(_head_rss_mb(), 1),
            "vs_baseline": None}


def many_pgs(n: int) -> dict:
    """Create and ready n single-bundle placement groups, then remove
    them (reference test_many_pgs: 1k PGs @ 16.8 PGs/s on 64 vCPU)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    t0 = time.perf_counter()
    pgs = []
    for _ in range(n):
        pg = placement_group([{"CPU": 0.001}], strategy="PACK")
        pgs.append(pg)
    for pg in pgs:   # ready() is synchronous here (GCS round-trip)
        assert pg.ready(timeout=600)
    dt = time.perf_counter() - t0
    rss = _head_rss_mb()
    for pg in pgs:
        remove_placement_group(pg)
    return {"metric": "many_pgs_per_sec", "value": round(n / dt, 2),
            "unit": "pgs/s", "n": n, "wall_s": round(dt, 1),
            "head_rss_mb": round(rss, 1),
            "vs_baseline": round((n / dt) / (REF_PGS_PER_SEC / REF_CORES),
                                 3)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["many_actors", "many_tasks",
                                       "many_pgs", "all"], default="all")
    ap.add_argument("--actors", type=int, default=1000)
    ap.add_argument("--tasks", type=int, default=10000)
    ap.add_argument("--pgs", type=int, default=1000)
    ap.add_argument("--quick", action="store_true",
                    help="small-N smoke (200 actors / 2k tasks / 200 pgs)")
    args = ap.parse_args()
    if args.quick:
        args.actors, args.tasks, args.pgs = 200, 2000, 200

    import ray_tpu_torch as rt
    rt.init(num_cpus=4, log_level="ERROR")
    try:
        if args.mode in ("many_tasks", "all"):
            print(json.dumps(many_tasks(args.tasks)), flush=True)
        if args.mode in ("many_pgs", "all"):
            print(json.dumps(many_pgs(args.pgs)), flush=True)
        if args.mode in ("many_actors", "all"):
            print(json.dumps(many_actors(args.actors)), flush=True)
    finally:
        rt.shutdown()


if __name__ == "__main__":
    sys.exit(main())

"""Scalability-envelope smoke: the scale_bench entrypoints at tiny N.

Reference analog: release/benchmarks/distributed/test_many_{actors,pgs}.py
run nightly at 10k/1k; the full-N run lives in release_tests.yaml
(scale_envelope), this keeps the harness importable and correct in CI.

The port's ``_private/scale_bench.py``, as ``test_scale_bench.py`` runs
the reference's.
"""

import json
import subprocess
import sys


def test_scale_bench_quick_smoke():
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._private.scale_bench",
         "--mode", "all", "--actors", "40", "--tasks", "300", "--pgs",
         "50"],
        capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    metrics = {m["metric"]: m for m in lines}
    assert set(metrics) == {"many_actors_per_sec", "many_tasks_per_sec",
                            "many_pgs_per_sec"}
    for m in metrics.values():
        assert m["value"] > 0
        assert m["head_rss_mb"] > 0

"""Head-node HTTP dashboard (REST over GCS state + Prometheus metrics).

Reference analogs: dashboard REST modules + metrics agent exposition.

The port's runtime under ``test_dashboard.py``'s cases, one for one.
"""

import json
import os
import time
import urllib.request

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def dash_cluster():
    info = ray_tpu_torch.init(num_cpus=2)
    yield info
    ray_tpu_torch.shutdown()


def _get(base, path):
    try:
        with urllib.request.urlopen(f"http://{base}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_dashboard_endpoints(dash_cluster):
    base = dash_cluster.get("dashboard_address")
    assert base, f"no dashboard address in init info: {dash_cluster}"

    @ray_tpu_torch.remote
    def traced():
        return 42

    assert ray_tpu_torch.get(traced.remote()) == 42

    status, body = _get(base, "/api/nodes")
    assert status == 200
    nodes = json.loads(body)
    assert len(nodes) >= 1 and nodes[0]["alive"]

    status, body = _get(base, "/api/cluster_summary")
    summary = json.loads(body)
    assert summary["nodes"]["alive"] >= 1
    assert "CPU" in summary["resources"]["total"]

    deadline = time.monotonic() + 30
    while True:
        _, body = _get(base, "/api/tasks")
        tasks = json.loads(body)
        if any(t.get("name") == "traced" for t in tasks):
            break
        assert time.monotonic() < deadline, "task event never surfaced"
        time.sleep(0.5)

    status, body = _get(base, "/api/metrics")
    assert status == 200
    text = body.decode()
    assert "ray_tpu_nodes_alive 1" in text or \
        "ray_tpu_nodes_alive" in text

    status, body = _get(base, "/")
    assert status == 200 and b"dashboard" in body

    status, _ = _get(base, "/api/nope")
    assert status == 404


def test_loop_lag_exported_and_bounded(dash_cluster):
    """Control-plane liveness observability: the GCS's and every
    raylet's event-loop lag must be exported as ``loop_lag_ms`` in
    /api/metrics AND in the node-stats state API, and a healthy idle
    cluster's lag must be far below the health timeout."""
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch.util import state
    base = dash_cluster.get("dashboard_address")

    deadline = time.monotonic() + 30
    while True:
        _, body = _get(base, "/api/metrics")
        text = body.decode()
        has_gcs = 'ray_tpu_loop_lag_ms{component="gcs"}' in text
        has_raylet = ('ray_tpu_loop_lag_ms{component="raylet"' in text)
        if has_gcs and has_raylet:
            break
        assert time.monotonic() < deadline, \
            f"loop_lag_ms series missing from /api/metrics:\n{text}"
        time.sleep(0.5)

    lag_values = [float(line.rsplit(" ", 1)[1])
                  for line in text.splitlines()
                  if line.startswith("ray_tpu_loop_lag_ms{")]
    limit_ms = config().health_timeout_s * 1000
    assert lag_values, "no loop_lag_ms samples"
    assert all(0 <= v < limit_ms for v in lag_values), lag_values

    # same signal through the state API, per node
    deadline = time.monotonic() + 30
    while True:
        stats = state.node_stats()
        if stats and all("loop_lag_ms" in s for s in stats.values()):
            break
        assert time.monotonic() < deadline, \
            f"loop_lag_ms missing from node stats: {stats}"
        time.sleep(0.5)
    for s in stats.values():
        assert 0 <= s["loop_lag_ms"] < limit_ms
        assert 0 <= s["loop_lag_max_ms"] < limit_ms


def test_dashboard_jobs_listing(dash_cluster):
    base = dash_cluster.get("dashboard_address")
    _, body = _get(base, "/api/jobs")
    assert isinstance(json.loads(body), list)


def test_node_stats_and_worker_table(dash_cluster):
    """Per-node agent: raylets report per-worker cpu/rss
    and object-store occupancy to the GCS; /api/node_stats exposes it."""
    base = dash_cluster.get("dashboard_address")

    @ray_tpu_torch.remote
    class Pinger:
        def ping(self):
            return os.getpid()

    a = Pinger.remote()
    worker_pid = ray_tpu_torch.get(a.ping.remote())

    deadline = time.monotonic() + 30
    while True:
        _, body = _get(base, "/api/node_stats")
        stats = json.loads(body)
        pids = [w["pid"] for st in stats.values()
                for w in st.get("workers", [])]
        if worker_pid in pids:
            break
        assert time.monotonic() < deadline, \
            f"worker {worker_pid} never appeared in node stats: {stats}"
        time.sleep(0.5)
    st = next(iter(stats.values()))
    assert st["load_avg"] and st["mem_total"] > 0
    assert st["object_store"].get("capacity", 0) > 0
    w = next(w for w in st["workers"] if w["pid"] == worker_pid)
    assert w["rss_bytes"] > 10 * 1024 * 1024   # a live python process
    assert "cpu_percent" in w


def test_profile_endpoint_captures_busy_worker(dash_cluster):
    """/api/profile?pid= grabs a stack summary of a live worker; a busy
    sync actor method must dominate the samples."""
    base = dash_cluster.get("dashboard_address")

    @ray_tpu_torch.remote
    class Burner:
        def pid(self):
            return os.getpid()

        def burn_summing(self, seconds):
            t0 = time.monotonic()
            x = 0
            while time.monotonic() - t0 < seconds:
                x += sum(range(500))
            return x

    b = Burner.remote()
    pid = ray_tpu_torch.get(b.pid.remote())
    ref = b.burn_summing.remote(8.0)        # busy while we profile
    time.sleep(0.5)
    status, body = _get(base, f"/api/profile?pid={pid}&duration=2")
    assert status == 200
    prof = json.loads(body)
    assert prof.get("ok"), prof
    assert prof["samples"] > 10
    joined = json.dumps(prof["stacks"])
    assert "burn_summing" in joined, joined[:500]
    ray_tpu_torch.get(ref)


def test_dashboard_serve_status(dash_cluster):
    """/api/serve: controller publishes status into GCS KV each
    reconcile; the dashboard serves it without a cluster client."""
    from ray_tpu_torch import serve
    base = dash_cluster.get("dashboard_address")
    code, body = _get(base, "/api/serve")
    assert code == 200 and json.loads(body)["deployments"] == {}

    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.1})
    def echo(x):
        return x

    serve.run(echo.bind())
    deadline = time.monotonic() + 30
    deps = {}
    while time.monotonic() < deadline:
        code, body = _get(base, "/api/serve")
        deps = json.loads(body).get("deployments", {})
        if deps.get("echo", {}).get("running") == 1:
            break
        time.sleep(0.5)
    assert deps.get("echo", {}).get("running") == 1, deps
    serve.shutdown()

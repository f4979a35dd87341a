"""State API, Chrome-trace timeline, metrics.

Reference analogs: python/ray/tests/test_state_api.py, test_metrics_*, and
`ray timeline` output format.

The port's runtime under ``test_observability.py``'s cases, one for one.
"""

import json
import time

import pytest
from _torch_runtime import ray_start  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.util import metrics, state


@pytest.fixture(scope="module")
def obs_cluster():
    # One fake card for the GPU actor case; the reference's cases ask for
    # none.
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    yield
    ray_tpu_torch.shutdown()


def _wait_for(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while True:
        v = pred()
        if v:
            return v
        assert time.monotonic() < deadline, "condition never satisfied"
        time.sleep(0.5)


def test_list_tasks_records_executions(obs_cluster):
    @ray_tpu_torch.remote
    def traced_add(a, b):
        return a + b

    assert ray_tpu_torch.get([traced_add.remote(i, i) for i in range(4)]) == \
        [0, 2, 4, 6]
    def _all_four():
        ts = [t for t in state.list_tasks() if t["name"] == "traced_add"]
        return ts if len(ts) >= 4 else None  # event flushes are batched

    tasks = _wait_for(_all_four)
    t = tasks[0]
    assert t["status"] == "FINISHED"
    assert t["end"] >= t["start"]
    assert t["kind"] == "task"


def test_list_tasks_records_actor_calls_and_failures(obs_cluster):
    @ray_tpu_torch.remote
    class Obs:
        def ok(self):
            return 1

        def boom(self):
            raise ValueError("x")

    a = Obs.remote()
    assert ray_tpu_torch.get(a.ok.remote()) == 1
    with pytest.raises(Exception):
        ray_tpu_torch.get(a.boom.remote())
    calls = _wait_for(lambda: [t for t in state.list_tasks()
                               if t["kind"] == "actor_call" and
                               t["name"] in ("ok", "boom")])
    statuses = {t["name"]: t["status"] for t in calls}
    assert statuses.get("ok") == "FINISHED"
    assert statuses.get("boom") == "FAILED"


def test_list_actors_nodes_summary(obs_cluster):
    actors = state.list_actors()
    nodes = state.list_nodes()
    assert len(nodes) >= 1 and nodes[0]["alive"]
    s = state.cluster_summary()
    assert s["nodes"]["alive"] >= 1
    assert "CPU" in s["resources"]["total"]
    assert s["tasks"]["by_status"].get("FINISHED", 0) >= 1


def test_timeline_chrome_trace(obs_cluster, tmp_path):
    @ray_tpu_torch.remote
    def for_timeline():
        time.sleep(0.05)
        return 1

    ray_tpu_torch.get([for_timeline.remote() for _ in range(3)])
    _wait_for(lambda: len([t for t in state.list_tasks()
                           if t["name"] == "for_timeline"]) >= 3)
    path = str(tmp_path / "trace.json")
    events = ray_tpu_torch.timeline(path)
    with open(path) as f:
        loaded = json.load(f)
    assert loaded == events
    mine = [e for e in loaded if e["name"] == "for_timeline"]
    assert len(mine) >= 3
    e = mine[0]
    assert e["ph"] == "X" and e["dur"] > 0 and e["pid"].startswith("node-")


def test_metrics_counter_gauge_histogram(obs_cluster):
    c = metrics.Counter("rt_test_requests", tag_keys=("route",))
    c.inc(2.0, tags={"route": "/a"})
    c.inc(3.0, tags={"route": "/a"})
    g = metrics.Gauge("rt_test_queue_len")
    g.set(7.0)
    h = metrics.Histogram("rt_test_latency", boundaries=[0.1, 1.0])
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)

    def find(name):
        return [m for m in metrics.collect() if m["name"] == name]

    got = _wait_for(lambda: find("rt_test_requests"))
    assert got[0]["value"] == 5.0 and got[0]["labels"] == {"route": "/a"}
    assert find("rt_test_queue_len")[0]["value"] == 7.0
    hist = find("rt_test_latency")[0]
    assert hist["value"] == 3
    assert hist["buckets"]["0.1"] == 1
    assert hist["buckets"]["1.0"] == 1
    assert hist["buckets"]["+Inf"] == 1

    text = metrics.prometheus_text()
    # User metrics are namespaced away from built-in ray_tpu_* series,
    # identically on every exposition endpoint.
    assert 'ray_tpu_user_rt_test_requests{route="/a"} 5.0' in text
    assert "ray_tpu_user_rt_test_latency_bucket" in text


def test_metrics_aggregate_across_workers(obs_cluster):
    @ray_tpu_torch.remote
    class MetricActor:
        def __init__(self):
            from ray_tpu_torch.util import metrics as m
            self.c = m.Counter("rt_test_cross_proc")

        def bump(self):
            self.c.inc(1.0)
            from ray_tpu_torch.util import metrics as m
            m.flush()
            return True

    a, b = MetricActor.remote(), MetricActor.remote()
    ray_tpu_torch.get([a.bump.remote(), b.bump.remote(), a.bump.remote()])

    def total():
        vals = [m for m in metrics.collect()
                if m["name"] == "rt_test_cross_proc"]
        return vals[0]["value"] if vals else 0

    _wait_for(lambda: total() == 3.0)


def test_list_workers(ray_start):
    """state.list_workers surfaces per-node worker processes."""
    import time as _t

    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    def warm():
        return 1

    assert ray_tpu_torch.get(warm.remote()) == 1
    deadline = _t.monotonic() + 30
    workers = []
    while _t.monotonic() < deadline:
        workers = state.list_workers()
        if workers:
            break
        _t.sleep(0.5)
    assert workers and all("pid" in w and "node_id" in w for w in workers)


def test_gpu_actor_in_list_actors_and_timeline(obs_cluster, tmp_path):
    """A ``num_gpus=1`` actor shows its card request in list_actors()'s
    ``resources``, and the timeline holds one complete ("X") event on the
    actor's row for each of its finished method calls."""
    @ray_tpu_torch.remote(num_gpus=1)
    class OnCard:
        def step(self, i):
            time.sleep(0.01)
            return i

    a = OnCard.remote()
    assert ray_tpu_torch.get([a.step.remote(i) for i in range(3)],
                             timeout=120) == [0, 1, 2]
    aid = a._actor_id
    rec = next(r for r in state.list_actors() if r["actor_id"] == aid)
    assert rec["state"] == "ALIVE" and rec["resources"].get("GPU") == 1
    _wait_for(lambda: len([t for t in state.list_tasks(name="step")
                           if t.get("actor_id") == aid]) >= 3)
    path = str(tmp_path / "trace.json")
    ray_tpu_torch.timeline(path)
    with open(path) as f:
        mine = [e for e in json.load(f) if e["tid"] == aid]
    assert len(mine) == 3, mine
    assert all(e["ph"] == "X" and e["name"] == "step" and e["dur"] > 0
               and e["args"]["status"] == "FINISHED" for e in mine)
    ray_tpu_torch.kill(a)


def test_autotune_totals_sum_worker_counters(obs_cluster):
    """Worker-side autotune counters reach autotune_totals() through the
    util.metrics sink that autotune.metrics.bump() feeds."""
    @ray_tpu_torch.remote
    class Tuner:
        def tune(self, hits, misses, ms):
            from ray_tpu_torch.autotune import metrics as am
            from ray_tpu_torch.util import metrics as m
            am.bump("autotune_cache_hits", hits)
            am.bump("autotune_cache_misses", misses)
            am.bump("autotune_tune_ms", ms)
            m.flush()
            return am.stats()

    base = state.autotune_totals()
    a, b = Tuner.remote(), Tuner.remote()
    got = ray_tpu_torch.get([a.tune.remote(2, 1, 10.5),
                             b.tune.remote(3, 0, 4.0)])
    assert got == [{"autotune_cache_hits": 2, "autotune_cache_misses": 1,
                    "autotune_tune_ms": 10.5},
                   {"autotune_cache_hits": 3, "autotune_cache_misses": 0,
                    "autotune_tune_ms": 4}]
    want = {"autotune_cache_hits": base["autotune_cache_hits"] + 5,
            "autotune_cache_misses": base["autotune_cache_misses"] + 1,
            "autotune_tune_ms": base["autotune_tune_ms"] + 14.5}
    _wait_for(lambda: state.autotune_totals() == want)

"""Span tracing with cross-process propagation (VERDICT r2 missing #8 /
weak 5.1).  Reference analog: util/tracing/tracing_helper.py:53.

The port's runtime under ``test_tracing_usage.py``'s span, state and
usage cases, one for one, the two library-usage cases among them
(importing ``tune`` and ``data`` tags each library);
``test_runtime_never_cold_inits_jax_backend`` becomes
``test_runtime_never_inits_cuda``, and ``test_backend_summary_never_inits``
has no counterpart, since the port keeps no ``_private/jaxutil.py``.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import tracing


@pytest.fixture(scope="module")
def trace_cluster():
    ray_tpu_torch.init(num_cpus=4)
    tracing.enable()
    yield
    tracing.disable()
    ray_tpu_torch.shutdown()


def _wait_spans(pred, timeout=20):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = tracing.get_spans()
        if pred(spans):
            return spans
        time.sleep(0.5)
    raise AssertionError(f"spans never satisfied predicate: "
                         f"{tracing.get_spans()}")


def test_span_tree_spans_process_boundaries(trace_cluster):
    @ray_tpu_torch.remote
    def inner():
        return 1

    @ray_tpu_torch.remote
    def outer():
        return ray_tpu_torch.get(inner.remote()) + 1

    with tracing.span("driver-step") as (trace_id, root_id):
        assert ray_tpu_torch.get(outer.remote()) == 2

    spans = _wait_spans(lambda s: len(
        [x for x in s if x.get("trace_id") == trace_id]) >= 3)
    mine = {s["span_id"]: s for s in spans
            if s.get("trace_id") == trace_id}
    roots = [s for s in mine.values() if s["name"] == "driver-step"]
    outers = [s for s in mine.values() if s["name"] == "task:outer"]
    inners = [s for s in mine.values() if s["name"] == "task:inner"]
    assert roots and outers and inners
    # the tree: driver-step -> task:outer -> task:inner, across 3 processes
    assert outers[0]["parent_id"] == roots[0]["span_id"]
    assert inners[0]["parent_id"] == outers[0]["span_id"]
    assert roots[0]["parent_id"] is None


def test_span_records_errors(trace_cluster):
    with pytest.raises(ValueError):
        with tracing.span("bad-step") as (trace_id, _):
            raise ValueError("boom")
    spans = _wait_spans(lambda s: any(
        x.get("trace_id") == trace_id for x in s))
    bad = [s for s in spans if s.get("trace_id") == trace_id][0]
    assert bad["status"] == "FAILED"
    assert "boom" in bad["attributes"]["error"]


def test_get_spans_filters_by_trace(trace_cluster):
    with tracing.span("iso-a") as (ta, _):
        pass
    with tracing.span("iso-b") as (tb, _):
        pass
    spans_a = _wait_spans(lambda s: any(
        x.get("trace_id") == ta for x in s), timeout=10)
    only_a = tracing.get_spans(trace_id=ta)
    assert only_a and all(s["trace_id"] == ta for s in only_a)


def test_list_tasks_pagination_and_filters(trace_cluster):
    from ray_tpu_torch.util.state import list_tasks

    @ray_tpu_torch.remote
    def pageme():
        return None

    ray_tpu_torch.get([pageme.remote() for _ in range(12)])
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        evs = list_tasks(name="pageme", kind="task")
        if len(evs) >= 12:
            break
        time.sleep(0.5)
    assert len(evs) >= 12
    assert all(e["name"] == "pageme" for e in evs)
    page1 = list_tasks(limit=5, name="pageme", kind="task")
    page2 = list_tasks(limit=5, offset=5, name="pageme", kind="task")
    assert len(page1) == 5 and len(page2) == 5
    ids = {e["task_id"] for e in page1} & {e["task_id"] for e in page2}
    assert not ids                      # pages don't overlap


def test_usage_report_collects_cluster_and_libraries(trace_cluster):
    from ray_tpu_torch._private.usage_stats import (record_library_usage,
                                                    usage_report)
    import ray_tpu_torch.tune  # noqa: F401  - library import tags usage
    record_library_usage("custom-thing")
    rep = usage_report()
    assert "tune" in rep["libraries"]
    assert "custom-thing" in rep["libraries"]
    assert rep["cluster"]["alive_nodes"] >= 1
    assert rep["cluster"]["total_resources"].get("CPU", 0) > 0


def test_actor_call_spans_join_trace(trace_cluster):
    @ray_tpu_torch.remote
    class Worker:
        def work(self):
            return 7

    a = Worker.remote()
    ray_tpu_torch.get(a.work.remote())   # warm (outside the trace)
    with tracing.span("actor-step") as (trace_id, root_id):
        assert ray_tpu_torch.get(a.work.remote()) == 7
    spans = _wait_spans(lambda s: any(
        x.get("trace_id") == trace_id and x["name"] == "actor:work"
        for x in s))
    actor_spans = [s for s in spans if s.get("trace_id") == trace_id
                   and s["name"] == "actor:work"]
    assert actor_spans[0]["parent_id"] == root_id


def test_usage_report_written_at_shutdown(tmp_path, monkeypatch):
    import json
    import subprocess
    import sys
    env = dict(__import__("os").environ)
    env["RT_LOG_DIR"] = str(tmp_path)
    code = (
        "import ray_tpu_torch, ray_tpu_torch.data;"
        "ray_tpu_torch.init(num_cpus=1);"
        "ray_tpu_torch.shutdown()")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    rep = json.loads((tmp_path / "usage_report.json").read_text())
    assert "data" in rep["libraries"]


def test_runtime_never_inits_cuda(tmp_path):
    """Framework plumbing must not initialise CUDA as a side effect: a
    daemon, the template or a card-less worker that did would hold a
    context on a card it was never leased (the counterpart of the JAX
    package's cold-init regression, where usage_stats cold-inited the
    device backend at shutdown).  After a full init / put / get /
    usage_report / shutdown round trip with a CPU tensor through a
    card-less worker, no process asked CUDA to start: ``_lazy_init`` is
    recorded, since without a card is_initialized() alone stays False."""
    import json
    import subprocess
    import sys
    env = dict(__import__("os").environ)
    env["RT_LOG_DIR"] = str(tmp_path)
    code = r"""
import json, os
import torch
import ray_tpu_torch

def watch_cuda_init():
    calls = []
    real = torch.cuda._lazy_init
    def lazy_init():
        calls.append(1)
        return real()
    torch.cuda._lazy_init = lazy_init
    return calls

@ray_tpu_torch.remote
def on_worker(boxed):
    calls = watch_cuda_init()
    t = ray_tpu_torch.get(boxed[0])
    total = float((t * 2).sum())
    return {"calls": len(calls), "cuda": torch.cuda.is_initialized(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "total": total}

calls = watch_cuda_init()
ray_tpu_torch.init(num_cpus=1)
ref = ray_tpu_torch.put(torch.arange(1024, dtype=torch.float32))
worker = ray_tpu_torch.get(on_worker.remote([ref]), timeout=120)
assert torch.equal(ray_tpu_torch.get(ref), torch.arange(1024.))
import ray_tpu_torch._private.usage_stats as u
u.usage_report()
ray_tpu_torch.shutdown()
print(json.dumps({"driver_calls": len(calls),
                  "driver_cuda": torch.cuda.is_initialized(),
                  "worker": worker}))
"""
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         timeout=120, capture_output=True, text=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["driver_calls"] == 0 and not got["driver_cuda"], got
    w = got["worker"]
    assert w["calls"] == 0 and not w["cuda"], got
    assert w["visible"] == "" and w["total"] == 2 * sum(range(1024)), got

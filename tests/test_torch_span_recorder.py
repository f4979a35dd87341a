"""The in-process span recorder of ``ray_tpu_torch.util.tracing`` and the
spans of the engine, the train step and the MoE FFN, on the CPU.

Off, a span records nothing and never looks for a runtime; on, spans nest
with their thread and parent and share ``torch.profiler``'s clock.  A tiny
engine records one ``engine.prefill`` a request and one ``engine.decode``
a step, and its four spans never overlap; a train step records one
forward, backward and optimizer span, and an MoE model one ``moe.ffn`` a
layer in the forward and again in remat's recompute.  None of these
program spans reaches the runtime's task events, even with the
distributed path on.
"""

import asyncio
import threading

import pytest
import torch

from ray_tpu_torch._private import worker
from ray_tpu_torch.models.gpt import (GPTConfig, gpt_init, make_train_state,
                                      make_train_step)
from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.util import tracing

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_tracing(monkeypatch):
    """Both paths off, restored after the test."""
    for name, value in (("_enabled", False), ("_recording", None),
                        ("_on", None)):
        monkeypatch.setattr(tracing, name, value)
    yield
    tracing.stop_recording()


@pytest.fixture
def no_get_core(monkeypatch):
    """Fails the test if anything asks the runtime for its core."""
    def get_core():
        raise AssertionError("span() looked up the runtime")
    monkeypatch.setattr(worker, "get_core", get_core)


@pytest.fixture
def task_events(monkeypatch):
    """The distributed path on, over a runtime whose task events are the
    returned list."""
    events = []

    class Core:
        def record_task_event(self, event):
            events.append(event)

    monkeypatch.setattr(worker.global_worker, "core_worker", Core())
    tracing.enable()
    return events


def _names(spans):
    return [s["name"] for s in spans]


def test_recorder_off_records_nothing(no_get_core):
    with tracing.span("off", {"a": 1}) as ids:
        pass
    with tracing.local_span("local-off") as local_ids:
        pass
    assert ids is None and local_ids is None
    assert tracing.stop_recording() == []


def test_distributed_path_without_a_runtime_keeps_ids(no_get_core,
                                                      monkeypatch):
    monkeypatch.setattr(worker.global_worker, "core_worker", None)
    tracing.enable()
    with tracing.span("outer") as (trace_id, outer_id):
        with tracing.span("inner") as (inner_trace, _):
            assert tracing.current_context()[0] == trace_id
    assert inner_trace == trace_id and tracing.current_context() is None


def test_distributed_path_sends_to_the_runtime(task_events):
    tracing.start_recording()
    with pytest.raises(ValueError):
        with tracing.span("bad", {"k": 1}) as (trace_id, span_id):
            with tracing.local_span("local") as local_ids:
                pass
            raise ValueError("boom")
    local, rec = tracing.stop_recording()
    (ev,) = task_events
    assert local_ids is None and local["parent"] == "bad"
    assert (ev["trace_id"], ev["span_id"], ev["parent_id"]) == \
        (trace_id, span_id, None)
    assert ev["status"] == "FAILED" and "boom" in ev["attributes"]["error"]
    assert ev["start"] == rec["start_ns"] / 1e9
    assert ev["end"] == rec["end_ns"] / 1e9
    assert rec["attributes"] == ev["attributes"]


def test_recorded_spans_nest_with_thread_and_parent(no_get_core):
    def side():
        with tracing.span("side"):
            pass

    tracing.start_recording()
    with tracing.span("outer", {"n": 2}):
        with tracing.span("inner"):
            pass
        t = threading.Thread(target=side, name="side-thread")
        t.start()
        t.join(10)
    still_open = tracing.span("still-open")
    still_open.__enter__()
    spans = tracing.stop_recording()
    still_open.__exit__(None, None, None)
    assert not t.is_alive()
    assert _names(spans) == ["inner", "side", "outer"]
    inner, other, outer = spans
    assert [s["parent"] for s in spans] == ["outer", None, None]
    assert outer["attributes"] == {"n": 2} and inner["attributes"] == {}
    me = threading.current_thread().name
    assert inner["thread"] == outer["thread"] == me
    assert inner["tid"] == threading.get_native_id() != other["tid"]
    assert other["thread"] == "side-thread"
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= \
        outer["end_ns"]
    with tracing.span("after-stop"):
        pass
    assert tracing.stop_recording() == []


def test_a_failed_send_leaves_the_block_alone(monkeypatch):
    class Core:
        def record_task_event(self, event):
            raise RuntimeError("Event loop is closed")

    monkeypatch.setattr(worker.global_worker, "core_worker", Core())
    tracing.enable()
    with tracing.span("shutdown") as ids:
        pass
    assert ids is not None and tracing.current_context() is None


def test_recorder_capacity_drops_and_warns(monkeypatch):
    monkeypatch.setattr(tracing, "_CAPACITY", 2)
    tracing.start_recording()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    with pytest.warns(RuntimeWarning, match="dropped 3 spans"):
        spans = tracing.stop_recording()
    assert _names(spans) == ["s0", "s1"]


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("host"):
            with record_function("inside"):
                torch.ones(8) + 1
    (rec,) = tracing.stop_recording()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inside"]
    assert rec["start_ns"] <= ev.start_ns() <= ev.end_ns() <= rec["end_ns"]


def test_engine_spans(no_get_core, task_events):
    cfg = GPTConfig(vocab_size=97, max_seq_len=40, num_layers=1, num_heads=2,
                    embed_dim=16, dtype=torch.float32, attention="dense",
                    remat=False)
    prompts = [[(5 * i + j) % 97 for j in range(2 + i)] for i in range(5)]

    async def serve():
        eng = InferenceEngine(EngineConfig(
            model="gpt", model_config=cfg, page_size=8, num_pages=32,
            max_batch=3, max_prompt_len=16, max_new_tokens=6, device=CPU),
            params=gpt_init(0, cfg, CPU))

        async def consume(p):
            return [t async for t in eng.generate(p, 4)]

        out = await asyncio.gather(*[consume(p) for p in prompts])
        steps = eng.stats()["steps"]
        eng.close()
        return out, steps

    tracing.start_recording()
    out, steps = asyncio.run(serve())
    spans = tracing.stop_recording()
    assert all(len(t) == 4 for t in out)
    by = {n: [s for s in spans if s["name"] == n]
          for n in ("engine.prefill", "engine.decode", "engine.schedule",
                    "engine.deliver")}
    assert len(spans) == sum(map(len, by.values()))
    assert sorted(s["attributes"]["prompt_len"]
                  for s in by["engine.prefill"]) == sorted(map(len, prompts))
    assert len(by["engine.decode"]) == steps
    assert all(1 <= s["attributes"]["active"] <= 3
               for s in by["engine.decode"])
    assert task_events == []
    lane = {s["thread"] for s in by["engine.prefill"] + by["engine.decode"]}
    loop = {s["thread"] for s in by["engine.schedule"] + by["engine.deliver"]}
    assert len(lane) == 1 and lane.isdisjoint(loop)
    spans.sort(key=lambda s: s["start_ns"])
    for a, b in zip(spans, spans[1:]):
        assert a["end_ns"] <= b["start_ns"], (a, b)


@pytest.mark.parametrize("experts,remat", [(0, False), (4, False), (4, True)],
                         ids=["dense", "moe", "moe-remat"])
def test_train_step_spans(no_get_core, task_events, experts, remat):
    cfg = GPTConfig(vocab_size=64, max_seq_len=16, num_layers=2, num_heads=2,
                    embed_dim=16, dtype=torch.float32, attention="dense",
                    remat=remat, num_experts=experts, expert_top_k=2)
    params, opt = make_train_state(0, cfg, device=CPU)
    step = make_train_step(cfg, opt)
    tokens = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                           .manual_seed(0))
    tracing.start_recording()
    for _ in range(2):
        step(params, {"tokens": tokens})
    spans = tracing.stop_recording()
    assert task_events == []
    steps = [s["name"] for s in spans if s["name"].startswith("train.")]
    assert steps == ["train.forward", "train.backward",
                     "train.optimizer"] * 2
    moe = [s["parent"] for s in spans if s["name"] == "moe.ffn"]
    want = ["train.forward"] * cfg.num_layers
    if experts and remat:
        want += ["train.backward"] * cfg.num_layers
    assert moe == (want * 2 if experts else [])

"""``perfbench/spans.py`` on hand-made profiler events and spans: device
time by the span open at each kernel's launch, idle gaps named by spans
only where no host op names them, and the serving lane's split."""

import pytest
import torch

from perfbench import spans, trace

MS = 1_000_000    # ns


class Ev:
    """The few methods of a profiler event that the reductions call."""

    def __init__(self, start, end, name, device=False, corr=0):
        self._t, self._name, self._device, self._corr = \
            (start, end), name, device, corr

    def start_ns(self):
        return self._t[0]

    def end_ns(self):
        return self._t[1]

    def name(self):
        return self._name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._device
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr


def _span(name, start, end, **attributes):
    return {"name": name, "start_ns": start, "end_ns": end,
            "attributes": attributes}


# A window of [0, 100] ns: kernel 1 launched at 5 inside span b (inside a),
# kernel 2 at 35 inside a, kernel 3 with no launch record; an aten op open
# at the third gap's start.
EVENTS = [
    Ev(0, 100, trace.WINDOW_MARK),
    Ev(5, 6, "cudaLaunchKernel", corr=1),
    Ev(35, 36, "cudaLaunchKernel", corr=2),
    Ev(10, 30, "gemm", device=True, corr=1),
    Ev(40, 60, "gemm", device=True, corr=2),
    Ev(70, 80, "copy", device=True, corr=3),
    Ev(58, 65, "aten::mm"),
]
SPANS = [_span("b", 4, 8), _span("a", 0, 50)]


def test_innermost_takes_the_latest_start_still_open():
    ivs = [(0, 50, "a"), (4, 8, "b"), (20, 90, "c")]
    assert spans.innermost([0, 5, 8, 30, 60, 95], ivs) == \
        ["a", "b", "a", "c", "c", None]


def test_device_time_by_span_and_gaps_named():
    got = spans.reduce_spans(EVENTS, SPANS)
    assert got["by_span"] == {"b": pytest.approx(20e-9),
                              "a": pytest.approx(20e-9)}
    assert got["unlaunched_s"] == pytest.approx(10e-9)
    assert got["busy_s"] == pytest.approx(50e-9)
    assert sum(got["by_span"].values()) <= got["busy_s"]
    gaps = dict(got["idle_gaps"])
    # [0,10] and [30,40] fell in span a; [60,70] an aten op keeps; [80,100]
    assert gaps == {"a": pytest.approx(20e-9),
                    "aten::mm": pytest.approx(10e-9),
                    "(none)": pytest.approx(20e-9)}
    assert dict(got["none_named_by"]) == {"a": pytest.approx(20e-9),
                                          "(none)": pytest.approx(20e-9)}
    # The harness's own reduction of the same events is unchanged.
    plain = trace.reduce_events(EVENTS)
    assert plain["busy_s"] == pytest.approx(got["busy_s"])
    assert dict(plain["idle_gaps"])["(none)"] == pytest.approx(40e-9)
    assert spans.reduce_spans(EVENTS[1:], SPANS) is None


def test_serving_split_and_the_readings():
    lane = [_span("engine.prefill", 0, 100 * MS, prompt_len=30),
            _span("engine.schedule", 100 * MS, 110 * MS),
            _span("engine.decode", 150 * MS, 450 * MS, active=4),
            _span("engine.deliver", 450 * MS, 460 * MS),
            _span("engine.decode", 500 * MS, 900 * MS, active=6),
            _span("engine.decode", 950 * MS, 1100 * MS, active=6)]
    split = spans.serving_split(lane, 0, 1000 * MS)
    assert split["engine.decode"]["count"] == 2
    assert split["engine.decode"]["median_ms"] == pytest.approx(350.0)
    assert split["engine.prefill"]["share_pct"] == pytest.approx(10.0)
    assert split["lane_idle_pct"] == pytest.approx(20.0)
    assert split["active_median"] == 5
    windows = [{"kept": False, "spans": {"by_span": {"moe.ffn": 9.0}}},
               {"kept": True, "spans": {"by_span": {
                   "train.optimizer": 0.03, "moe.ffn": 0.6}}}]
    assert spans.metrics(windows, 3, split) == {
        "optimizer_ms_per_step.train": pytest.approx(10.0),
        "moe_ms_per_step.train": pytest.approx(200.0),
        "decode_step_ms.serve": pytest.approx(350.0),
        "prefill_ms.serve": pytest.approx(100.0),
        "lane_idle.serve": pytest.approx(20.0)}

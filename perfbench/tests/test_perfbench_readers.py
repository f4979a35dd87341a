"""Per-layer and end-to-end readers on hand-made run records."""

import pytest

from conftest import ROOT
from perfbench import arith, spec

BASE = ROOT + "/perfbench"
SIZES = {"vocab_size": 256, "num_layers": 2, "embed_dim": 64,
         "mlp_dim": 256, "num_heads": 4, "head_dim": 16}


def _read(name, run):
    return spec.module(BASE, "metrics", name).read(run)


def _serving_run():
    # Two requests; the window is [10, 20] s and the counter went 4 -> 6.
    a = {"prompt_len": 5, "times": [9.0, 11.0, 12.0],
         "steps": [3, 5, 6]}
    b = {"prompt_len": 7, "times": [12.5, 13.0, 21.0],
         "steps": [5, 6, 7]}
    return {"requests": [a, b], "window": (10.0, 20.0), "window_s": 10.0,
            "steps_window": (4, 6), "sizes": SIZES}


def test_tokens_per_step_counts_the_windows_decode_steps():
    # steps 5 and 6 handed over a[1], a[2], b[1]: 3 tokens in 2 steps
    assert _read("tokens_per_step.serve", _serving_run()) == 1.5


def test_serve_tokens_per_s_counts_tokens_in_the_window():
    assert _read("serve_tokens_per_s", _serving_run()) == 4 / 10.0


def test_mfu_serve_sums_each_steps_bound():
    busy = (arith.bound_s(*arith.prefill_work(SIZES, 7))
            + arith.bound_s(*arith.decode_step_work(SIZES, [5 + 1]))
            + arith.bound_s(*arith.decode_step_work(SIZES, [5 + 2, 7 + 1])))
    assert _read("mfu.serve", _serving_run()) == pytest.approx(
        100 * busy / 10.0)


def test_train_readers():
    trace = {"window_s": 2.0, "busy_s": 1.5,
             "by_class": {"flash": 0.1, "elementwise_copy": 0.6}}
    m = dict(SIZES, num_experts=0, expert_top_k=0)
    run = {"trace": trace, "trace_steps": 3, "tokens_per_step": 512,
           "sizes": m, "seq": 128, "batch": 4, "n_params": 1000,
           "tokens_in_window": 5120, "window_s": 4.0, "setup_s": 7.5}
    assert _read("train_tokens_per_s", run) == 1280.0
    assert _read("setup_s", run) == 7.5
    assert _read("device_idle.train", run) == pytest.approx(25.0)
    assert _read("elementwise_ms_per_step.train", run) == pytest.approx(200)
    flops = 3 * 512 * arith.dense_mflop_per_token(1000, 2, 128, 64) * 1e6
    assert _read("mfu.train", run) == pytest.approx(
        100 * flops / (2.0 * 989e12))
    bound = 3 * arith.attention_step_bound_s(4, 4, 128, 16, 2)
    assert _read("attention_roofline.train", run) == pytest.approx(
        100 * bound / 0.1)
    assert _read("device_idle.train", dict(run, trace=None)) is None

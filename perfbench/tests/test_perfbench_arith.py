"""The frozen arithmetic against PERF.md's figures."""

import pytest

from perfbench import arith, weights


def _sizes(D, N, L, E=0, k=0):
    return {"vocab_size": 50304, "token_vocab": 50257, "max_seq_len": 1024,
            "num_layers": L, "num_heads": N, "embed_dim": D,
            "head_dim": D // N, "mlp_dim": 4 * D, "num_experts": E,
            "expert_top_k": k, "capacity_factor": 1.25 if E else 0.0,
            "moe_aux_coef": 0.01 if E else 0.0, "layer_norm_eps": 1e-5}


def test_model_flops_per_token():
    small = _sizes(768, 12, 12)
    assert weights.n_params(small) == 124_448_256
    assert arith.train_mflop_per_token(small, 1024, weights.n_params(small)) \
        == pytest.approx(859.9, abs=0.05)
    moe = _sizes(768, 12, 12, E=8, k=2)
    assert weights.n_params(moe) == 521_206_272
    assert arith.train_mflop_per_token(moe, 1024, weights.n_params(moe)) \
        == pytest.approx(1200.4, abs=0.05)
    xl = _sizes(1600, 25, 48)
    assert weights.n_params(xl) == 1_557_456_000
    assert arith.train_mflop_per_token(xl, 1024, weights.n_params(xl)) \
        == pytest.approx(10288.45, abs=0.01)


def test_flash_bounds_at_the_training_call():
    us = {k: arith.flash_bound_s(32, 12, 1024, 64, "bfloat16", True, k)
          for k in ("fwd", "dq", "dkv")}
    assert us["fwd"][0] * 1e6 == pytest.approx(60.57, abs=0.005)
    assert us["dq"][0] * 1e6 == pytest.approx(78.25, abs=0.005)
    assert us["dkv"][0] * 1e6 == pytest.approx(104.33, abs=0.005)
    assert us["fwd"][1] == "bytes"


def test_moe_capacity():
    assert arith.moe_capacity(1024, 2, 8, 1.25) == 320
    assert arith.moe_capacity(3, 1, 8, 1.0) == 1


def test_serving_work_counts_the_true_lengths():
    m = _sizes(1600, 25, 48)
    f1, b1 = arith.decode_step_work(m, [100])
    f2, b2 = arith.decode_step_work(m, [100, 300])
    # one more slot adds its products, its keys and values, not weights
    assert b2 - b1 == 2 * 48 * 1600 * 2 * (300 + 1)
    assert f2 - f1 == pytest.approx(f1 + 4 * 48 * 1600 * 200)
    f, b = arith.prefill_work(m, 256)
    assert b == arith.serve_weight_bytes(m) + 2 * 48 * 1600 * 2 * 256
    assert arith.bound_s(f, b) == max(f / 989e12, b / 3.35e12)

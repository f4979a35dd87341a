"""The Hopper flash-attention backward kernels against their plain version,
and which kernels each dtype and head dim takes: bf16 at head dims 64 and
128 the warp-specialised wgmma kernels (``flash_bwd_dq_kernel``,
``flash_bwd_dkv_kernel``), f32 and bf16 at 16 and 32 the mma.sync kernels
(``flash_bwd_dq_mma_kernel``, ``flash_bwd_dkv_mma_kernel``).

Every test here needs a CUDA card and skips without one.  The module
imports nothing of JAX, so on the card (which has no JAX) it runs without
the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd_kernel.py
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# max |kernel - plain| <= TOL * max |plain| per tensor, the plain version
# run in f32 on the same inputs.  bf16: the kernels round P and dS to bf16
# before their products and dq/dk/dv to bf16.  f32: sums in another order
# (TF32 is off on both sides).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_flash_bwd_kernel.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, device, dtype, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for _ in range(n)]


def _assert_close_rel(got, want, tol, name):
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    assert torch.isfinite(got).all(), name
    assert err <= tol * scale, f"{name}: max err {err} > {tol} x {scale}"


def _qkv_views(B, N, S, H, device, seed):
    """q, k, v as the qkv[:, i] views of one [B, S, 3, N, H] projection (the
    training call's layout), and a contiguous dO."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, 3, N, H)).astype(
        np.float32)).to(device, torch.bfloat16)
    qkv = x.permute(0, 2, 3, 1, 4)
    do = torch.from_numpy(rng.standard_normal((B, N, S, H)).astype(
        np.float32)).to(device, torch.bfloat16)
    return qkv[:, 0], qkv[:, 1], qkv[:, 2], do


def _check_bwd_against_plain(q, k, v, do, causal, layout, dtype,
                             sm_scale=None):
    """dq, dk, dv from the kernels (one launch of each) against the plain
    backward run in f32 on the same inputs and the kernels' forward."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal, sm_scale=sm_scale,
                                    layout=layout)
    before = (fa.flash_attention.dq_launches, fa.flash_attention.dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                 sm_scale=sm_scale, layout=layout)
    torch.cuda.synchronize()
    assert (fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal,
        sm_scale=sm_scale, layout=layout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == q.shape and a.dtype == q.dtype, name
        _assert_close_rel(a, b, TOL[dtype], name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout, S", [("bnsh", 256), ("bsnh", 200)])
def test_kernels_match_plain(cuda, dtype, H, causal, layout, S):
    shape = (2, 3, S, H) if layout == "bnsh" else (2, S, 3, H)
    q, k, v, do = _inputs(shape, cuda, TORCH[dtype], seed=H)
    _check_bwd_against_plain(q, k, v, do, causal, layout, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 200, 320, 1024])
def test_wgmma_kernels_read_strided_qkv_views(cuda, H, causal, S):
    """The wgmma kernels' TMA maps over qkv[:, i] views, at S that fills
    one 128-row tile, cuts one (200, 320: padded queries in the dk/dv
    kernel, a ragged key tile in dq) or spans eight."""
    q, k, v, do = _qkv_views(2, 4, S, H, cuda, seed=S + H)
    _check_bwd_against_plain(q, k, v, do, causal, "bnsh", "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, H", [("bfloat16", 64), ("bfloat16", 128),
                                      ("float32", 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sm_scale", [0.0, -0.125])
def test_kernels_take_any_scale(cuda, dtype, H, causal, sm_scale):
    """sm_scale at or below zero, which the reference takes; S = 200."""
    q, k, v, do = _inputs((2, 3, 200, H), cuda, TORCH[dtype], seed=H + 2)
    _check_bwd_against_plain(q, k, v, do, causal, "bnsh", dtype, sm_scale)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 128])
def test_wgmma_kernels_are_deterministic(cuda, H):
    """dq, dk and dv bitwise equal over two runs at the training call's
    layout: every output row is stored once, with no atomics."""
    q, k, v, do = _qkv_views(2, 4, 1024, H, cuda, seed=H)
    o, lse = fa.flash_attention_fwd(q, k, v, True, layout="bnsh")
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, True, layout="bnsh")
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, True, layout="bnsh")
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def _launched_kernels(fn):
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, H, design", [
    ("bfloat16", 64, "_kernel<"), ("bfloat16", 128, "_kernel<"),
    ("bfloat16", 32, "_mma_kernel<"), ("float32", 64, "_mma_kernel<")])
def test_dtype_and_head_dim_pick_the_backward_kernels(cuda, dtype, H,
                                                      design):
    q, k, v, do = _inputs((1, 2, 256, H), cuda, TORCH[dtype])
    o, lse = fa.flash_attention_fwd(q, k, v, True, layout="bnsh")
    names = _launched_kernels(lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, do, True, layout="bnsh"))
    for kind in ("dq", "dkv"):
        launched = [n for n in names if f"flash_bwd_{kind}_" in n]
        assert len(launched) == 1, names
        assert f"flash_bwd_{kind}{design}" in launched[0], names


@pytest.mark.gpu
def test_autograd_through_strided_qkv_views(cuda):
    """Grads of qkv[:, i] views of a [B, 3, N, S, H] projection (the GPT
    block's call) through the kernels equal the plain path's."""
    B, N, S, H = 2, 4, 320, 64
    x = torch.randn(B, S, 3, N, H, device=cuda, dtype=torch.bfloat16)
    g = torch.randn(B, N, S, H, device=cuda, dtype=torch.bfloat16)

    def grad(dev, dtype):
        xi = x.detach().to(dev, dtype).clone().requires_grad_(True)
        qkv = xi.permute(0, 2, 3, 1, 4)
        o = fa.flash_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], layout="bnsh")
        (o * g.to(dev, dtype)).sum().backward()
        return xi.grad

    _assert_close_rel(grad(cuda, torch.bfloat16),
                      grad("cpu", torch.float32).to(cuda), 2e-2, "dqkv")


@pytest.mark.gpu
def test_gpt_grads_with_the_kernels_match_dense(cuda):
    cfg = GPTConfig(vocab_size=256, max_seq_len=256, num_layers=2,
                    num_heads=4, embed_dim=128, dtype=torch.float32,
                    attention="flash", remat_policy="dots", ce_block=64)
    params = gpt_init(0, cfg, device=cuda)
    for p in _leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, 256, (2, 257), device=cuda)

    def grads(c):
        for p in _leaves(params):
            p.grad = None
        loss = gpt_loss(params, {"tokens": tokens}, c)
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in _leaves(params)]

    counts = (fa.flash_attention.launches, fa.flash_attention.dq_launches,
              fa.flash_attention.dkv_launches)
    lf, gf = grads(cfg)
    L = cfg.num_layers
    assert (fa.flash_attention.launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches) == (counts[0] + 2 * L,
                                                 counts[1] + L, counts[2] + L)
    ld, gd = grads(dataclasses.replace(cfg, attention="dense"))
    torch.testing.assert_close(lf, ld, rtol=1e-5, atol=0)
    for a, b in zip(gf, gd):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))

"""The Hopper splash-attention kernels against their plain versions, dq
and dk/dv bitwise deterministic over two runs, and the dtype picking the
kernel (bf16: the warp-specialised wgmma kernels; f32: the first design).

Every test here needs a CUDA card and skips without one.  The module
imports nothing of JAX, so on the card (which has no JAX) it runs without
the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_splash_kernel.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.autotune.dispatch import make_splash_kernel
from ray_tpu_torch.ops import splash_attention as sp

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Against the plain versions run in f32 on the same inputs.  Forward: o
# within atol = rtol, lse within atol.  Backward: max |err| <= tol x max
# |ref| per tensor.  bf16: the kernels round p (and ds) to bf16 before
# their products and the outputs to bf16; f32: sums in another order.
FWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_splash_kernel.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, device, dtype, seed=0, n=4):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          for _ in range(n)]
    xs[0] = xs[0] * shape[-1] ** -0.5              # q arrives pre-scaled
    return [x.to(device, dtype) for x in xs]


def _check_case(shape, dtype, fwd_blocks, bwd_blocks, device, offsets=()):
    B, N, S, H = shape
    q, k, v, do = _inputs(shape, device, TORCH[dtype], seed=S + H)
    mask = sp.causal_mha_mask(N, S, offsets)
    fi = sp.process_mask(mask, fwd_blocks)
    bi = sp.process_mask(mask, bwd_blocks)
    before = (sp.splash_attention.launches, sp.splash_attention.dq_launches,
              sp.splash_attention.dkv_launches)
    o, lse = sp.splash_attention_fwd(q, k, v, fi)
    dq, dk, dv = sp.splash_attention_bwd(q, k, v, o, lse, do, bi)
    torch.cuda.synchronize()
    assert (sp.splash_attention.launches, sp.splash_attention.dq_launches,
            sp.splash_attention.dkv_launches) == tuple(n + 1 for n in before)
    f32 = [x.float() for x in (q, k, v)]
    ro, rl = sp.splash_attention_reference(*f32, fi)
    tol_o, tol_lse = FWD_TOL[dtype]
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro, atol=tol_o, rtol=tol_o)
    torch.testing.assert_close(lse, rl, atol=tol_lse, rtol=0)
    want = (sp.splash_dq_reference(*f32, o.float(), lse, do.float(), bi),
            *sp.splash_dkv_reference(*f32, o.float(), lse, do.float(), bi))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == shape and got.dtype == q.dtype, name
        assert torch.isfinite(got).all(), name
        err, scale = float((got.float() - ref).abs().max()), float(
            ref.abs().max())
        assert err <= BWD_TOL[dtype] * scale, f"{name}: {err} > tol x {scale}"
    # No atomics: the backward run twice on the same inputs gives the same
    # bits.
    dq2, dk2, dv2 = sp.splash_attention_bwd(q, k, v, o, lse, do, bi)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and \
        torch.equal(dv, dv2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [64, 128])
def test_partial_empty_and_full_blocks(cuda, dtype, H):
    """[1, 2, 256, 128-blocks]: the map [[1, 0], [2, 1]]."""
    _check_case((1, 2, 256, H), dtype, (128, 128), (128, 128), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("fwd", [128, 256, 512])
@pytest.mark.parametrize("bwd", [128, 256, 512])
@pytest.mark.parametrize("H", [64, 128])
def test_every_candidate_block_size(cuda, fwd, bwd, H):
    _check_case((2, 4, 1024, H), "bfloat16", (fwd, fwd), (bwd, bwd), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, H", [("float32", 64), ("bfloat16", 64),
                                      ("bfloat16", 128)])
def test_unequal_blocks_and_per_head_offsets(cuda, dtype, H):
    """block_q != block_kv, and one map per head (offsets 0 and 128)."""
    _check_case((2, 2, 512, H), dtype, (256, 128), (128, 256), cuda,
                offsets=(0, 128))


@pytest.mark.gpu
def test_strided_views_and_autograd(cuda):
    """q/k/v as strided views (bsnh memory read as bnsh), grads through
    the registered op equal the plain path's on the CPU."""
    B, N, S, H = 2, 4, 512, 128
    x = torch.randn(B, S, 3, N, H, device=cuda, dtype=torch.bfloat16)
    g = torch.randn(B, N, S, H, device=cuda, dtype=torch.bfloat16)

    def grad(dev, dtype):
        xi = x.detach().to(dev, dtype).clone().requires_grad_(True)
        qkv = xi.permute(0, 2, 3, 1, 4)
        kern = make_splash_kernel(N, S, {"block_q": 256, "block_kv": 256},
                                  dev)
        o = kern(qkv[:, 0] * H ** -0.5, qkv[:, 1], qkv[:, 2])
        (o * g.to(dev, dtype)).sum().backward()
        return xi.grad

    got, want = grad(cuda, torch.bfloat16), grad("cpu", torch.float32)
    err = float((got.float().cpu() - want).abs().max())
    assert err <= 2e-2 * float(want.abs().max())


@pytest.mark.gpu
def test_wrapper_raises_on_what_the_kernel_cannot_take(cuda):
    info = sp.process_mask(sp.causal_mha_mask(2, 256), (128, 128))
    q = torch.randn(1, 2, 256, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        sp.splash_attention(q, q, q, info)
    q = torch.randn(1, 2, 256, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sp.splash_attention(q, q, q, info)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, suffix", [("bfloat16", "_kernel<"),
                                           ("float32", "_f32_kernel<")])
def test_dtype_picks_the_kernels(cuda, dtype, suffix):
    from torch.profiler import ProfilerActivity, profile
    shape = (1, 2, 256, 128)
    q, k, v, do = _inputs(shape, cuda, TORCH[dtype])
    bi = sp.process_mask(sp.causal_mha_mask(2, 256), (128, 128))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, lse = sp.splash_attention_fwd(q, k, v, bi)
        sp.splash_attention_bwd(q, k, v, o, lse, do, bi)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    for kind in ("fwd", "dq", "dkv"):
        found = [n for n in names if f"splash_{kind}_" in n]
        assert len(found) == 1 and f"splash_{kind}{suffix}" in found[0], \
            names

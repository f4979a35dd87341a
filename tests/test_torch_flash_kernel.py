"""The Hopper flash-attention forward kernels against their plain PyTorch
version, and which kernel each dtype and head dim takes: bf16 at head dims
64 and 128 the warp-specialised wgmma kernel (``flash_fwd_kernel``), f32
and bf16 at 16 and 32 the mma.sync kernel (``flash_fwd_mma_kernel``).

Every test here needs a CUDA card and skips without one.  The module
imports nothing of JAX, so on the card (which has no JAX) it runs without
the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_kernel.py
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import GPTConfig, gpt_forward, gpt_init

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Against the plain version run in f32 on the same inputs.  bf16: the
# kernel rounds p to bf16 before P.V and o to bf16.  f32: sums in another
# order (TF32 is off on both sides).
ATOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-3)}   # (o, lse)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_flash_kernel.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, device, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for _ in range(3)]


def _check_against_plain(q, k, v, causal, layout, dtype, sm_scale=None):
    B, N, S = (q.shape[0], q.shape[1], q.shape[2]) if layout == "bnsh" \
        else (q.shape[0], q.shape[2], q.shape[1])
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal, sm_scale=sm_scale,
                                    layout=layout)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (B * N, S)
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                          causal, sm_scale=sm_scale,
                                          layout=layout)
    atol_o, atol_lse = ATOL[dtype]
    torch.testing.assert_close(o.float(), ro, atol=atol_o, rtol=atol_o)
    torch.testing.assert_close(lse, rl, atol=atol_lse, rtol=0)


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout, S", [("bnsh", 256), ("bsnh", 200)])
def test_kernel_matches_plain(cuda, dtype, H, causal, layout, S):
    shape = (2, 3, S, H) if layout == "bnsh" else (2, S, 3, H)
    q, k, v = _inputs(shape, cuda, TORCH[dtype], seed=H)
    _check_against_plain(q, k, v, causal, layout, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bnsh", "bsnh"])
@pytest.mark.parametrize("S", [128, 200, 320, 1024])
def test_wgmma_kernel_matches_plain(cuda, H, causal, layout, S):
    """bf16 at the wgmma kernel's head dims, at S that fills one 128-row
    tile, cuts one (200, 320) or spans eight."""
    shape = (2, 3, S, H) if layout == "bnsh" else (2, S, 3, H)
    q, k, v = _inputs(shape, cuda, torch.bfloat16, seed=S + H)
    _check_against_plain(q, k, v, causal, layout, "bfloat16")


@pytest.mark.gpu
def test_kernel_reads_strided_qkv_views(cuda):
    """qkv[:, i] of a [B, 3, N, S, H] view with a contiguous head dim, as
    the GPT block hands it over, is read in place."""
    B, N, S, H = 2, 4, 128, 64
    x = torch.randn(B, S, 3, N, H, device=cuda, dtype=torch.bfloat16)
    qkv = x.permute(0, 2, 3, 1, 4)
    o = fa.flash_attention(qkv[:, 0], qkv[:, 1], qkv[:, 2], layout="bnsh")
    ro, _ = fa.flash_attention_reference(
        *(qkv[:, i].float() for i in range(3)), True, layout="bnsh")
    torch.testing.assert_close(o.float(), ro, atol=1e-2, rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("S", [128, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_kernel_reads_strided_qkv_views(cuda, H, S, causal):
    """The TMA maps of the wgmma kernel over qkv[:, i] views of one
    [B, S, 3, N, H] projection (the training call's layout)."""
    x = torch.from_numpy(np.random.default_rng(H + S).standard_normal(
        (2, S, 3, 4, H)).astype(np.float32)).to(cuda, torch.bfloat16)
    qkv = x.permute(0, 2, 3, 1, 4)
    _check_against_plain(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal, "bnsh",
                         "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, H, kernel", [
    ("bfloat16", 64, "flash_fwd_kernel<"),
    ("bfloat16", 128, "flash_fwd_kernel<"),
    ("bfloat16", 32, "flash_fwd_mma_kernel<"),
    ("float32", 64, "flash_fwd_mma_kernel<")])
def test_dtype_and_head_dim_pick_the_kernel(cuda, dtype, H, kernel):
    q, k, v = _inputs((1, 2, 256, H), cuda, TORCH[dtype])
    names = _launched_kernels(
        lambda: fa.flash_attention_fwd(q, k, v, True, layout="bnsh"))
    flash = [n for n in names if "flash_fwd_" in n]
    assert len(flash) == 1 and kernel in flash[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, H", [("bfloat16", 64), ("bfloat16", 128),
                                      ("float32", 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sm_scale", [0.0, -0.125])
def test_kernel_takes_any_scale(cuda, dtype, H, causal, sm_scale):
    """sm_scale at or below zero, which the reference takes: the wgmma
    kernel (bf16) scales before the row max on that path, the mma.sync
    kernel (f32) always does.  S = 200 cuts a tile."""
    q, k, v = _inputs((2, 3, 200, H), cuda, TORCH[dtype], seed=H + 1)
    _check_against_plain(q, k, v, causal, "bnsh", dtype, sm_scale)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 16, 2, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)


@pytest.mark.gpu
def test_gpt_forward_with_the_kernel_matches_dense(cuda):
    cfg = GPTConfig(vocab_size=256, max_seq_len=256, num_layers=2,
                    num_heads=4, embed_dim=128, dtype=torch.float32,
                    attention="flash")
    params = gpt_init(0, cfg, device=cuda)
    tokens = torch.randint(0, 256, (2, 200), device=cuda)
    before = fa.flash_attention.launches
    flash = gpt_forward(params, tokens, cfg)
    assert fa.flash_attention.launches == before + cfg.num_layers
    dense = gpt_forward(params, tokens,
                        dataclasses.replace(cfg, attention="dense"))
    torch.testing.assert_close(flash, dense, atol=2e-4, rtol=0)

"""The port's LLaMA through the Hopper flash kernels, against its dense path.

GQA hands the kernels K/V repeated up to the query heads (contiguous
``repeat_interleave`` copies) and q/k after RoPE (contiguous), unlike the
GPT block's strided views of one qkv tensor.  Held here: the grads with
the kernels against the dense path's at head dim 64 (bf16: the wgmma
kernels) and 16 (the mma.sync kernels), with 3 query heads per KV head and
with 1, and the forward's launches per call.

- f32: loss rtol 1e-5 and each grad leaf within 1e-3 x its max |value|
  of the dense grads (the bound of
  test_gpt_grads_with_the_kernels_match_dense);
- bf16: per leaf, the flash grads' relative distance ||g - g32|| / ||g32||
  from the f32 dense grads at most 1.25x the bf16 dense grads' (the limit
  chip_smoke.py's train_check holds GPT-2-small and LLaMA to).

Every test here needs a CUDA card and skips without one.  The module
imports nothing of JAX, so on the card (which has no JAX) it runs without
the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_llama_kernel.py
"""

import dataclasses
import importlib

import pytest
import torch

from ray_tpu_torch.models import (LlamaConfig, llama_forward, llama_init,
                                  llama_loss)

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

REL_MULT = 1.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_llama_kernel.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _config(H, rep, dtype):
    N = 6
    return LlamaConfig(vocab_size=256, max_seq_len=256, num_layers=2,
                       num_heads=N, num_kv_heads=N // rep, embed_dim=N * H,
                       mlp_dim=256, dtype=dtype, attention="flash",
                       remat=True, remat_policy="dots", ce_block=64)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches)


def _grads(params, tokens, cfg):
    for p in _leaves(params):
        p.grad = None
    loss = llama_loss(params, {"tokens": tokens}, cfg)
    loss.backward()
    return loss.detach(), [p.grad.float().clone() for p in _leaves(params)]


def _rel_dist(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("rep", [3, 1])
@pytest.mark.parametrize("H", [64, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_grads_with_the_kernels_match_dense(cuda, dtype, H, rep):
    cfg = _config(H, rep, getattr(torch, dtype))
    params = llama_init(0, cfg, device=cuda)
    for p in _leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, 256, (2, 257), generator=gen, device=cuda)
    before = _counts()
    lf, gf = _grads(params, tokens, cfg)
    L = cfg.num_layers
    # remat "dots": each layer's forward runs again in the backward
    assert _counts() == (before[0] + 2 * L, before[1] + L, before[2] + L)
    dense = dataclasses.replace(cfg, attention="dense")
    if dtype == "float32":
        ld, gd = _grads(params, tokens, dense)
        torch.testing.assert_close(lf, ld, rtol=1e-5, atol=0)
        for a, b in zip(gf, gd):
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
        return
    _, g32 = _grads(params, tokens, dataclasses.replace(
        dense, dtype=torch.float32))
    _, gd = _grads(params, tokens, dense)
    assert torch.isfinite(lf)
    for a, d, b in zip(gf, gd, g32):
        assert torch.isfinite(a).all()
        assert _rel_dist(a, b) <= REL_MULT * _rel_dist(d, b)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_forward_launches_the_kernel_once_per_layer(cuda, dtype, H):
    """One forward kernel per layer and no backward one; f32 logits within
    2e-4 of the dense forward's, bf16 no further from the f32 dense logits
    than twice the bf16 dense forward's distance."""
    cfg = _config(H, 3, getattr(torch, dtype))
    params = llama_init(0, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, 256, (2, 200), generator=gen, device=cuda)
    before = _counts()
    flash = llama_forward(params, tokens, cfg).float()
    assert _counts() == (before[0] + cfg.num_layers, before[1], before[2])
    dense = dataclasses.replace(cfg, attention="dense")
    if dtype == "float32":
        torch.testing.assert_close(flash, llama_forward(params, tokens, dense),
                                   atol=2e-4, rtol=0)
        return
    f32 = llama_forward(params, tokens,
                        dataclasses.replace(dense, dtype=torch.float32))
    d16 = llama_forward(params, tokens, dense).float()
    assert float((flash - f32).abs().max()) <= \
        2 * float((d16 - f32).abs().max())

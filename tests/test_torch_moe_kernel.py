"""The port's MoE GPT through the Hopper flash kernels, against its dense
path.

The MoE FFN (ops/moe.py) is plain torch; what the kernels see is what
they see in the dense GPT (strided q/k/v views of one qkv projection), but
the grads now flow through the routing (top-2 of 8 experts, capacity
1.25) as well.  Held here at head dim 64 (bf16: the wgmma kernels):

- f32: loss rtol 1e-5 and each grad leaf within 1e-3 x its max |value|
  of the dense path's grads (the bound of the GPT and LLaMA kernel tests);
- bf16: per leaf, the flash grads' relative distance ||g - g32|| / ||g32||
  from the f32 dense grads at most 1.25x the bf16 dense grads' (the limit
  chip_smoke.py's train_check phases hold the models to);
- the launches: 2L forward (remat "dots" runs each layer's forward again)
  and L of each backward kernel per step, as the dense GPT's.

Every test here needs a CUDA card and skips without one.  The module
imports nothing of JAX, so on the card it runs without the repo's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_moe_kernel.py
"""

import dataclasses
import importlib

import pytest
import torch

from ray_tpu_torch.models import GPTConfig, gpt_init, gpt_loss

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

REL_MULT = 1.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_moe_kernel.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _config(dtype, H=64):
    N = 4
    return GPTConfig(vocab_size=256, max_seq_len=256, num_layers=2,
                     num_heads=N, embed_dim=N * H, dtype=dtype,
                     attention="flash", remat=True, remat_policy="dots",
                     ce_block=64, num_experts=8, expert_top_k=2)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _counts():
    return (fa.flash_attention.launches, fa.flash_attention.dq_launches,
            fa.flash_attention.dkv_launches)


def _grads(params, tokens, cfg):
    for p in _leaves(params):
        p.grad = None
    loss = gpt_loss(params, {"tokens": tokens}, cfg)
    loss.backward()
    return loss.detach(), [p.grad.float().clone() for p in _leaves(params)]


def _rel_dist(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gpt_grads_with_the_kernels_match_dense(cuda, dtype):
    cfg = _config(getattr(torch, dtype))
    params = gpt_init(0, cfg, device=cuda)
    for p in _leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, 256, (2, 257), generator=gen, device=cuda)
    before = _counts()
    lf, gf = _grads(params, tokens, cfg)
    L = cfg.num_layers
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

"""The Hopper flash kernels at every admitted (block_q, block_k) pair
against their plain version: the forward's o and lse, and dq, dk, dv from
the backward kernels, causal and not, bnsh and bsnh, strided qkv views and
an S that no tile divides; each pair's per-tile launch counter; the
default pair when nothing names one; and ``tune_flash_blocks`` persisting
a winner that later block_q=None calls launch.

Every test here needs a CUDA card and skips without one.  The module
imports nothing of JAX, so on the card (which has no JAX) it runs without
the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_tiles_kernel.py
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

PAIRS = [(128, 128), (128, 64), (64, 128), (64, 64)]
# Against the plain version run in f32 on the same inputs: o atol = o
# rtol, lse atol (bf16), and max |err| <= BWD_TOL x max |ref| per backward
# tensor (chip_smoke.py's KERNEL_TOL and BWD_TOL).
O_TOL, LSE_TOL, BWD_TOL = 1e-2, 1e-3, 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu "
                    "tests/test_torch_flash_tiles_kernel.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(shape, device, seed, views):
    """q, k, v (strided qkv[:, i] views of one [B, S, 3, N, H] tensor when
    ``views``; bnsh then) and dO, bf16."""
    rng = np.random.default_rng(seed)
    if views:
        B, N, S, H = shape
        x = torch.from_numpy(rng.standard_normal((B, S, 3, N, H)).astype(
            np.float32)).to(device, torch.bfloat16).permute(0, 2, 3, 1, 4)
        qkv = [x[:, 0], x[:, 1], x[:, 2]]
    else:
        qkv = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, torch.bfloat16) for _ in range(3)]
    do = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, torch.bfloat16)
    return (*qkv, do)


CASES = [((2, 4, 256, 64), "bnsh", True, False),
         ((2, 4, 256, 64), "bnsh", False, False),
         ((2, 256, 4, 128), "bsnh", True, False),
         ((2, 4, 320, 128), "bnsh", False, False),
         ((2, 4, 1000, 64), "bnsh", True, False),
         ((2, 1000, 4, 128), "bsnh", False, False),
         ((2, 4, 200, 64), "bnsh", True, True),
         ((4, 12, 1024, 64), "bnsh", True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("shape,layout,causal,views", CASES)
def test_pair_against_plain(cuda, pair, shape, layout, causal, views):
    bq, bk = pair
    q, k, v, do = _inputs(shape, cuda, sum(shape), views)
    before = dict(fa.flash_attention.tile_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, bq, bk, layout=layout)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, bq, bk,
                                 layout=layout)
    torch.cuda.synchronize()
    ro, rl = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                          causal, layout=layout)
    assert torch.isfinite(o).all()
    assert ((o.float() - ro).abs() <= O_TOL + O_TOL * ro.abs()).all()
    assert float((lse - rl).abs().max()) <= LSE_TOL
    want = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal,
        layout=layout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - b).abs().max())
        assert torch.isfinite(a).all(), name
        assert err <= BWD_TOL * float(b.abs().max()), (name, err)
    after = fa.flash_attention.tile_launches
    delta = {key: n - before.get(key, 0) for key, n in after.items()
             if n != before.get(key, 0)}
    assert delta == {("fwd", bq, bk): 1, ("dq", bq, bk): 1,
                     ("dkv", bq, bk): 1}


@pytest.mark.gpu
def test_no_pair_no_record_launches_the_defaults(cuda, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("RT_AUTOTUNE_CACHE", str(tmp_path / "a.jsonl"))
    monkeypatch.delenv("RT_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("RT_FLASH_BLOCK_K", raising=False)
    fa._TUNED.clear()
    for dtype, H, pair in ((torch.bfloat16, 64, (128, 128)),
                           (torch.bfloat16, 128, (128, 128)),
                           (torch.float32, 64, (64, 64)),
                           (torch.bfloat16, 32, (64, 64))):
        q, k, v = (torch.randn((2, 4, 256, H), device=cuda, dtype=dtype)
                   .requires_grad_(True) for _ in range(3))
        before = dict(fa.flash_attention.tile_launches)
        fa.flash_attention(q, k, v, layout="bnsh").float().sum().backward()
        torch.cuda.synchronize()
        after = fa.flash_attention.tile_launches
        delta = {key: n - before.get(key, 0) for key, n in after.items()
                 if n != before.get(key, 0)}
        assert delta == {("fwd", *pair): 1, ("dq", *pair): 1,
                         ("dkv", *pair): 1}, (dtype, H)


@pytest.mark.gpu
def test_unadmitted_pair_raises_on_the_card(cuda):
    q = torch.randn((1, 2, 128, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(block_q, block_k\)"):
        fa.flash_attention_fwd(q, q, q, True, 96, 64, layout="bnsh")
    q32 = q.float()
    with pytest.raises(ValueError, match=r"\(64, 64\)"):
        fa.flash_attention_fwd(q32, q32, q32, True, 128, 128, layout="bnsh")


@pytest.mark.gpu
def test_tuned_winner_is_launched(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("RT_AUTOTUNE_CACHE", str(tmp_path / "a.jsonl"))
    import ray_tpu_torch.autotune.cache as ac
    ac._CACHES.clear()
    fa._TUNED.clear()
    fa._CACHE_CONSULTED.clear()
    B, S, N, H = 4, 1024, 12, 64
    pair, secs = fa.tune_flash_blocks(B, S, N, H, torch.bfloat16, True,
                                      device=cuda)
    assert pair in PAIRS and secs is not None and secs > 0
    fa._TUNED.clear()                   # the file's record steers now
    q, k, v = (torch.randn((B, N, S, H), device=cuda, dtype=torch.bfloat16)
               for _ in range(3))
    before = dict(fa.flash_attention.tile_launches)
    fa.flash_attention(q, k, v, layout="bnsh")
    torch.cuda.synchronize()
    after = fa.flash_attention.tile_launches
    assert after[("fwd", *pair)] - before.get(("fwd", *pair), 0) == 1
    ac._CACHES.clear()
    fa._CACHE_CONSULTED.clear()

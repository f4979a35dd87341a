"""Tile choices of the port's flash kernels (``ray_tpu_torch.ops.
flash_attention``) against the JAX package's (``ray_tpu.ops.
flash_attention``): the admitted (block_q, block_k) sets, the refusal of a
pair the card's kernels were not compiled for, ``_default_blocks``,
``_cached_blocks``, ``_resolve`` (explicit, then ``_TUNED``, then the
autotune cache, then the default, in the reference's order) and
``tune_flash_blocks``, mirroring ``tests/test_autotune.py``'s
``test_tune_flash_blocks_shim`` and ``test_flash_resolve_consults_cache``.

Everything runs on the CPU: the plain versions take any pair, and the
card's refusal is checked on the wrapper's card path with host tensors,
which raises before any kernel is built.  The reference's
``test_strict_divisibility_error_suggests_padding`` has no mirror: it is
the TPU compiler's rule, and the card's kernels take any S.  Numerics
against JAX's ``_dense_reference`` on seeded numpy inputs, f32, within
2e-5 as the reference's test."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.autotune.cache as jcache
import ray_tpu_torch.autotune.cache as ac
from ray_tpu.ops.flash_attention import _dense_reference as jdense
from ray_tpu_torch.autotune import attention_key, get_cache
from ray_tpu_torch.autotune import metrics as am

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("ray_tpu.ops.flash_attention")

CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)     # named only; no tensor goes there
BF16, F32 = torch.bfloat16, torch.float32
SQUARE = {(bq, bk) for bq in (64, 128) for bk in (64, 128)}


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """A fresh cache file and clean process-local tile state."""
    path = str(tmp_path / "autotune.jsonl")
    monkeypatch.setenv("RT_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("RT_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("RT_FLASH_BLOCK_K", raising=False)

    def forget():
        for mod in (ac, jcache):
            mod._CACHES.clear()
        for mod in (fa, jfa):
            mod._TUNED.clear()
            mod._CACHE_CONSULTED.clear()
    forget()
    am.reset()
    yield path
    forget()


def _qkv(seed, B=1, S=64, N=2, H=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, N, H)).astype(np.float32)
                 for _ in range(3))


# ------------------------------------------------------------ admitted sets

@pytest.mark.parametrize("dtype,H,want", [
    (BF16, 64, SQUARE), (BF16, 128, SQUARE),
    (BF16, 16, {(64, 64)}), (BF16, 32, {(64, 64)}),
    (F32, 64, {(64, 64)}), (F32, 128, {(64, 64)}),
    (BF16, 80, set()), (torch.float16, 64, set())])
def test_admitted_sets(dtype, H, want):
    got = fa.admitted_blocks(dtype, H)
    assert set(got) == want and len(got) == len(want)
    if got:      # the kernel family's default comes first
        assert got[0] == ((128, 128) if want == SQUARE else (64, 64))


@pytest.mark.parametrize("dtype,H,pair", [
    (BF16, 64, (96, 128)), (BF16, 128, (128, 256)), (BF16, 64, (32, 64)),
    (F32, 64, (128, 128)), (BF16, 32, (64, 128))])
def test_card_path_refuses_an_unadmitted_pair(dtype, H, pair):
    """The wrapper's card path raises ValueError naming the admitted set
    before it builds anything (host tensors stand in for the card's: no
    nvcc is reached), for the forward and for the backward."""
    B, N, S = 1, 2, 128
    q, k, v, o, do = (torch.zeros((B, N, S, H), dtype=dtype)
                      for _ in range(5))
    lse = torch.zeros((B * N, S))
    allowed = str(list(fa.admitted_blocks(dtype, H)))
    with pytest.raises(ValueError) as e:
        fa._launch_fwd(q, k, v, True, None, "bnsh", *pair)
    assert allowed in str(e.value) and str(pair) in str(e.value)
    with pytest.raises(ValueError, match=r"\(block_q, block_k\)"):
        fa._launch_bwd(q, k, v, o, lse, do, True, *pair, None, "bnsh")


def test_default_blocks(monkeypatch):
    monkeypatch.delenv("RT_FLASH_BLOCK_Q", raising=False)
    monkeypatch.delenv("RT_FLASH_BLOCK_K", raising=False)
    # the CPU: the plain versions' 128 capped at S
    assert fa._default_blocks(1024, 64, BF16, CPU) == (128, 128)
    assert fa._default_blocks(100, 64, F32, CPU) == (100, 100)
    # the card: the kernel family's default
    assert fa._default_blocks(1024, 64, BF16, CARD) == (128, 128)
    assert fa._default_blocks(1024, 64, F32, CARD) == (64, 64)
    assert fa._default_blocks(1024, 16, BF16, CARD) == (64, 64)
    # overrides, checked against the admitted set on the card
    monkeypatch.setenv("RT_FLASH_BLOCK_Q", "64")
    assert fa._default_blocks(1024, 64, BF16, CARD) == (64, 128)
    assert fa._default_blocks(1024, 64, BF16, CPU) == (64, 128)
    monkeypatch.setenv("RT_FLASH_BLOCK_K", "96")
    assert fa._default_blocks(1024, 64, BF16, CPU) == (64, 96)
    with pytest.raises(ValueError, match=r"\(64, 96\)"):
        fa._default_blocks(1024, 64, BF16, CARD)


# ------------------------------------------------ the reference's mirrors

def test_tune_flash_blocks_shim(cache_file):
    """Mirror of the reference's test: the winner reaches the memo and
    the shared file, and a second call answers from the memo."""
    (bq, bk), t = fa.tune_flash_blocks(1, 64, 2, 8, torch.float32, True,
                                       candidates=(16, 32), steps=1,
                                       device="cpu")
    assert (bq, bk) in {(a, b) for a in (16, 32) for b in (16, 32)}
    assert t is not None and t > 0
    key = ("cpu:torch", 1, 64, 2, 8, "float32", True)
    assert fa._TUNED[key] == (bq, bk)
    rec = get_cache().lookup(
        "flash_attention", attention_key(1, 64, 2, 8, "float32", True),
        backend="cpu:torch", count=False)
    assert rec["config"] == {"block_q": bq, "block_k": bk}
    assert rec["meta"]["swept"] == 4
    # second call answers from the memo (no timing)
    assert fa.tune_flash_blocks(1, 64, 2, 8, torch.float32, True,
                                device="cpu") == ((bq, bk), None)


def test_flash_resolve_consults_cache(cache_file):
    """Mirror of the reference's test: a planted record drives the pair
    of a block_q=None call, and the output equals dense."""
    key = attention_key(1, 64, 2, 8, "float32", True)
    get_cache().put("flash_attention", key, {"block_q": 16, "block_k": 16},
                    1.0, backend="cpu:torch")
    arrays = _qkv(0)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    assert fa._resolve(q, True, None, None, "bsnh") == (16, 16)
    o = fa.flash_attention(q, k, v, True, None, None, None)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jdense(*map(jnp.asarray, arrays),
                                                 True, None)), atol=2e-5)


# Each stage adds one source of a pair; both packages' _resolve must pick
# the same pair from the same records, explicit values first.
STAGES = ["default", "cache", "tuned", "explicit"]


@pytest.mark.parametrize("stage", STAGES)
def test_resolve_order_matches_the_reference(cache_file, stage):
    B, S, N, H = 1, 64, 2, 8
    arrays = _qkv(1, B, S, N, H)
    q = torch.from_numpy(arrays[0])
    jq = jnp.asarray(arrays[0])
    upto = STAGES.index(stage)
    if upto >= 1:
        key = attention_key(B, S, N, H, "float32", True)
        for backend in ("cpu:torch", jcache.backend_fingerprint()):
            get_cache().put("flash_attention", key,
                            {"block_q": 16, "block_k": 32}, 1.0,
                            backend=backend)
        jcache._CACHES.clear()
    if upto >= 2:
        fa._TUNED[("cpu:torch", B, S, N, H, "float32", True)] = (32, 16)
        jfa._TUNED[("cpu", B, S, N, H, "float32", True)] = (32, 16)
    bq, bk = (8, None) if upto >= 3 else (None, None)
    want = {"default": (64, 64), "cache": (16, 32), "tuned": (32, 16),
            "explicit": (8, 16)}[stage]
    got = fa._resolve(q, True, bq, bk, "bsnh")
    ref = jfa._resolve(jq, True, bq, bk, True, "bsnh")[:2]
    assert got == tuple(ref) == want


def test_cached_blocks_skips_what_the_card_does_not_admit(cache_file,
                                                          monkeypatch):
    """A record whose pair the card's kernels were not compiled for, or
    that is not a pair of ints, is ignored, never raised; an admitted one
    is taken; the hit/miss counters count one lookup per shape, however
    many calls."""
    monkeypatch.setattr(ac, "_cuda_fingerprint", lambda index: "cuda:fake")
    cache = get_cache()
    bad = attention_key(32, 1024, 12, 64, "bfloat16", True)
    good = attention_key(4, 1024, 12, 64, "bfloat16", True)
    cache.put("flash_attention", bad, {"block_q": 96, "block_k": 64}, 1.0,
              backend="cuda:fake")
    cache.put("flash_attention", good, {"block_q": 64, "block_k": 128},
              1.0, backend="cuda:fake")
    am.reset()
    for _ in range(3):
        assert fa._cached_blocks(32, 1024, 12, 64, BF16, True, CARD) is None
        assert fa._cached_blocks(4, 1024, 12, 64, BF16, True, CARD) == \
            (64, 128)
    # the mma.sync kernels (f32) admit (64, 64) only
    cache.put("flash_attention", attention_key(4, 1024, 12, 64, "float32"),
              {"block_q": 128, "block_k": 128}, 1.0, backend="cuda:fake")
    assert fa._cached_blocks(4, 1024, 12, 64, F32, True, CARD) is None
    for config in ({"block_q": "64", "block_k": 64}, {"block_q": 64},
                   {}, None):
        cache.put("flash_attention", attention_key(8, 1024, 12, 64,
                                                   "bfloat16"),
                  config, 1.0, backend="cuda:fake")
        assert fa._cached_blocks(8, 1024, 12, 64, BF16, True, CARD) is None
    stats = am.stats()
    assert stats["autotune_cache_hits"] == 4
    assert stats.get("autotune_cache_misses", 0) == 0


def test_resolved_pair_reaches_the_plain_versions(cache_file, monkeypatch):
    """The forward and its backward run at the resolved pair (here a
    tune record's): the plain versions see it, and the result equals the
    default pair's."""
    seen = []
    real = fa.flash_attention_reference

    def spy(q, k, v, causal, block_q, block_k, *rest, **kw):
        seen.append((block_q, block_k))
        return real(q, k, v, causal, block_q, block_k, *rest, **kw)
    key = attention_key(1, 64, 2, 8, "float32", True)
    get_cache().put("flash_attention", key, {"block_q": 16, "block_k": 32},
                    1.0, backend="cpu:torch")
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(2))
    monkeypatch.setattr(fa, "flash_attention_reference", spy)
    o = fa.flash_attention(q, k, v)
    o.sum().backward()
    assert seen == [(16, 32)]
    g = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    o2 = fa.flash_attention(q, k, v, True, 64, 64)
    o2.sum().backward()
    torch.testing.assert_close(o, o2, atol=2e-6, rtol=0)
    for a, x in zip(g, (q, k, v)):
        torch.testing.assert_close(a, x.grad, atol=2e-5, rtol=0)

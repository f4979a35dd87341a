"""The port's autotune subsystem (``ray_tpu_torch.autotune``) against the
JAX package's (``ray_tpu.autotune``): cache durability, dispatcher
crossover, end-to-end tuning of the plain versions on the CPU, and the
dispatched variants' numerics, mirroring ``tests/test_autotune.py``.

Shapes are tiny and every variant runs its plain PyTorch version on the
CPU.  Numerics against JAX's ``_dense_reference`` on the same seeded numpy
inputs: f32, within 2e-5 (flash, dense) and 2e-4 (splash, as the
reference's own splash test)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tpu.autotune as jat
import ray_tpu.autotune.cache as jcache
from ray_tpu.autotune import dispatch as jdispatch
from ray_tpu.autotune import search as jsearch
from ray_tpu.ops.flash_attention import _dense_reference as jdense
import ray_tpu_torch.autotune.cache as ac
from ray_tpu_torch.autotune import attention_key, get_cache, norm_batch
from ray_tpu_torch.autotune import dispatch, search, sweep
from ray_tpu_torch.autotune import metrics as am
from ray_tpu_torch.autotune.cache import AutotuneCache

pytestmark = pytest.mark.autotune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """Fresh cache file + clean process-local state for every test."""
    path = str(tmp_path / "autotune.jsonl")
    monkeypatch.setenv("RT_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("RT_AUTOTUNE_ON_MISS", raising=False)
    ac._CACHES.clear()
    jcache._CACHES.clear()
    dispatch.clear_memo()
    jdispatch.clear_memo()
    am.reset()
    yield path
    ac._CACHES.clear()
    jcache._CACHES.clear()
    dispatch.clear_memo()
    jdispatch.clear_memo()


def _qkv(seed, B=1, S=32, N=2, H=8, layout="bsnh"):
    rng = np.random.default_rng(seed)
    shape = (B, N, S, H) if layout == "bnsh" else (B, S, N, H)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ----------------------------------------------------------------- cache

def test_cache_roundtrip_and_last_wins(cache_file):
    c = get_cache()
    key = attention_key(2, 64, 2, 8, "float32", True)
    c.put("flash_attention", key, {"block_q": 16, "block_k": 16}, 1.5)
    c.put("flash_attention", key, {"block_q": 32, "block_k": 32}, 0.9)
    rec = c.lookup("flash_attention", key)
    assert rec["config"] == {"block_q": 32, "block_k": 32}
    assert rec["ms"] == 0.9
    # a fresh view over the same file agrees (restart survival)
    c2 = AutotuneCache(cache_file)
    rec2 = c2.lookup("flash_attention", key, count=False)
    assert rec2["config"] == {"block_q": 32, "block_k": 32}
    # the file holds both appends until a rewrite compacts them
    assert sum(1 for _ in open(cache_file)) == 2
    assert c.rewrite() == 1
    assert sum(1 for _ in open(cache_file)) == 1


def test_cache_truncated_tail_recovery(cache_file):
    """The torn tail of a crashed append costs that line, not the cache."""
    c = get_cache()
    k1 = attention_key(1, 32, 2, 8, "float32", True)
    k2 = attention_key(1, 64, 2, 8, "float32", True)
    c.put("flash_attention", k1, {"block_q": 8, "block_k": 8}, 2.0)
    full_line = json.dumps({"v": 1, "op": "flash_attention",
                            "backend": ac.backend_fingerprint(),
                            "key": k2, "config": {}, "ms": 1.0})
    with open(cache_file, "a") as f:
        f.write(full_line[: len(full_line) // 2])   # crash mid-append
    c2 = AutotuneCache(cache_file)
    assert c2.corrupt_lines == 1
    assert c2.lookup("flash_attention", k1, count=False) is not None
    assert c2.lookup("flash_attention", k2, count=False) is None
    # rewrite drops the torn tail for good
    assert c2.rewrite() == 1
    assert AutotuneCache(cache_file).corrupt_lines == 0


def test_cache_foreign_schema_and_garbage_skipped(cache_file):
    with open(cache_file, "w") as f:
        f.write("not json at all\n")
        f.write(json.dumps({"v": 999, "op": "x", "backend": "b",
                            "key": "k", "config": {}}) + "\n")
        f.write(json.dumps({"v": 1, "op": "flash_attention",
                            "backend": "cpu:torch", "key": "K",
                            "config": {"block_q": 8, "block_k": 8},
                            "ms": 1.0}) + "\n")
    c = AutotuneCache(cache_file)
    assert len(c) == 1
    assert c.corrupt_lines == 1          # garbage; the foreign version is
    rec = c.lookup("flash_attention", "K", backend="cpu:torch",
                   count=False)          # skipped silently, not corrupt
    assert rec["ms"] == 1.0


def test_cache_cross_process_persistence(cache_file):
    """Tune in one process, hit the cache in a second (the cache survives
    a process restart)."""
    key = attention_key(1, 32, 2, 8, "float32", True)
    code = (
        "from ray_tpu_torch.autotune import search\n"
        f"rec = search.tune('flash_attention', {key!r}, device='cpu')\n"
        "assert rec is not None and rec['config'], rec\n"
        "print(rec['config'])\n"
    )
    env = dict(os.environ, RT_AUTOTUNE_CACHE=cache_file, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    # this (second) process sees the first one's sweep as a pure hit
    rec = get_cache().lookup("flash_attention", key, backend="cpu:torch")
    assert rec is not None
    assert "block_q" in rec["config"]
    assert am.stats()["autotune_cache_hits"] == 1
    assert am.stats()["autotune_cache_misses"] == 0


def test_cache_concurrent_append_interleaves_whole_lines(cache_file):
    c = get_cache()
    other = AutotuneCache(cache_file)      # second writer, same file
    for i in range(10):
        k = attention_key(1, 32 * (i + 1), 2, 8, "float32", True)
        (c if i % 2 else other).put("flash_attention", k,
                                    {"block_q": 8, "block_k": 8}, i + 1.0)
    fresh = AutotuneCache(cache_file)
    assert fresh.corrupt_lines == 0
    assert len(fresh) == 10


def test_key_normalization():
    # batch buckets to the next power of two; other dims are exact
    assert norm_batch(1) == 1 and norm_batch(3) == 4 and norm_batch(8) == 8
    assert attention_key(3, 128, 4, 64, torch.bfloat16, True) == \
        attention_key(4, 128, 4, 64, "bfloat16", 1)
    assert attention_key(1, 128, 4, 64, torch.float32, True) != \
        attention_key(1, 128, 4, 64, "float32", False)
    # one key format with the JAX package, so both may share one file
    for dt_torch, dt_jax in ((torch.bfloat16, jnp.bfloat16),
                             (torch.float32, jnp.float32)):
        assert attention_key(3, 256, 4, 64, dt_torch) == \
            jat.attention_key(3, 256, 4, 64, dt_jax)


def test_fingerprints_name_the_device(monkeypatch):
    assert ac.backend_fingerprint("cpu") == "cpu:torch"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ac._cuda_fingerprint.cache_clear()
    try:
        assert ac.backend_fingerprint(torch.device("cuda", 0)) == \
            "cuda:nvidiah10080gbhbm3x1"
    finally:
        ac._cuda_fingerprint.cache_clear()


def test_cpu_torch_never_reads_a_jax_interpret_record(cache_file):
    """The JAX package tunes into the same file (backend cpu:interpret);
    the port's lookups (cpu:torch) never see its records."""
    rec = jsearch.tune_flash(1, 32, 2, 8, "float32", True, interpret=True)
    jcache.get_cache().put("attention_variant", rec["key"],
                           {"variant": "flash"}, 1.0)
    assert rec["backend"] == "cpu:interpret"
    c = get_cache()
    assert len(c) == 2                   # the port's view reads both lines
    assert c.lookup("flash_attention", rec["key"]) is None
    # ... and the dispatcher falls back to its heuristic (dense on the CPU)
    v, vrec = dispatch.choose(1, 32, 2, 8, "float32", True, device=CPU)
    assert (v, vrec) == ("dense", None)


# ------------------------------------------------------------ dispatcher

def test_crossover_on_synthetic_timings():
    pick = dispatch.choose_variant_from_timings
    assert pick({"flash": 2.0, "dense": 5.0, "splash": None}) == "flash"
    assert pick({"flash": 2.0, "dense": 1.0}) == "dense"
    assert pick({"flash": 2.0, "dense": 1.0},
                allowed=("flash",)) == "flash"
    assert pick({"flash": None, "dense": float("inf")}) is None
    assert pick({}) is None


def test_choose_honors_cache_record(cache_file):
    key = attention_key(1, 32, 2, 8, "float32", True)
    get_cache().put(dispatch.VARIANT_OP, key, {"variant": "flash"}, 1.0,
                    backend="cpu:torch")
    v, rec = dispatch.choose(1, 32, 2, 8, "float32", True,
                             allowed=("flash", "dense"), device=CPU)
    assert v == "flash" and rec is not None
    # memoized: a second call doesn't touch the counters again
    before = am.stats()["autotune_cache_hits"]
    v2, _ = dispatch.choose(1, 32, 2, 8, "float32", True,
                            allowed=("flash", "dense"), device=CPU)
    assert v2 == "flash"
    assert am.stats()["autotune_cache_hits"] == before


def test_choose_miss_falls_back_to_heuristic(cache_file):
    # cold cache + default on-miss mode: the CPU -> dense, and the miss is
    # counted exactly once (memoized after that)
    v, rec = dispatch.choose(1, 32, 2, 8, "float32", True,
                             allowed=("flash", "dense"), device=CPU)
    assert v == "dense" and rec is None
    assert am.stats()["autotune_cache_misses"] == 1
    dispatch.choose(1, 32, 2, 8, "float32", True,
                    allowed=("flash", "dense"), device=CPU)
    assert am.stats()["autotune_cache_misses"] == 1
    # the JAX package's heuristic says the same on the CPU
    jv, _ = jdispatch.choose(1, 32, 2, 8, "float32", True,
                             allowed=("flash", "dense"), interpret=True)
    assert jv == v


def test_on_miss_inline_tunes_and_persists(cache_file, monkeypatch):
    monkeypatch.setenv("RT_AUTOTUNE_ON_MISS", "inline")
    monkeypatch.setenv("RT_AUTOTUNE_BUDGET_S", "60")
    v, rec = dispatch.choose(1, 32, 2, 8, "float32", True,
                             allowed=("flash", "dense"), device=CPU)
    assert rec is not None and rec["config"]["variant"] == v
    assert am.stats()["autotune_tune_ms"] > 0
    # the decision is now durable: a fresh process-view hits it
    c2 = AutotuneCache(cache_file)
    key = attention_key(1, 32, 2, 8, "float32", True)
    assert c2.lookup(dispatch.VARIANT_OP, key, backend="cpu:torch",
                     count=False) is not None


def test_end_to_end_tune_tiny_shape(cache_file):
    rec = search.tune("flash_attention",
                      attention_key(1, 32, 2, 8, "float32", True),
                      device=CPU)
    assert rec is not None
    assert rec["config"]["block_q"] >= 8
    assert rec["ms"] > 0
    assert rec["meta"]["swept"] == 4     # 2 x 2 plain-version blocks
    assert rec["backend"] == "cpu:torch"


def test_tune_attention_times_splash_where_it_applies(cache_file):
    """At H=128, S=256 the sweep times splash (one candidate on the CPU,
    as interpret mode), flash and dense, and persists each record and the
    winner; a fresh cache over the file reads them back."""
    rec = dispatch.tune_attention(1, 256, 2, 128, "float32", True,
                                  device=CPU)
    timings = rec["meta"]["timings"]
    assert set(timings) == {"splash", "flash", "dense"}
    assert rec["config"]["variant"] == min(timings, key=timings.get)
    key = attention_key(1, 256, 2, 128, "float32", True)
    fresh = AutotuneCache(cache_file)
    for op in ("splash_attention", "flash_attention", "dense_attention",
               dispatch.VARIANT_OP):
        assert fresh.lookup(op, key, backend="cpu:torch",
                            count=False) is not None, op
    splash = fresh.lookup("splash_attention", key, backend="cpu:torch")
    assert splash["config"] == {"block_q": 128, "block_kv": 128,
                                "block_q_bwd": 128, "block_kv_bwd": 128}
    # at H=64 splash does not apply, as in the reference
    assert dispatch.applicable_variants(
        search.parse_key(attention_key(1, 256, 2, 64, "float32")), CPU) == \
        ["flash", "dense"]


def test_card_candidates():
    """On the card flash has one candidate (the kernel picks its tiles) and
    splash the reference's 3 x 3 grid; at H=64 splash has none."""
    cuda = torch.device("cuda", 0)
    kd = search.parse_key(attention_key(2, 4096, 32, 128, "bfloat16"))
    assert search.flash_candidates(kd, cuda) == [{}]
    cands = search.splash_candidates(kd, cuda)
    assert len(cands) == 9
    assert cands == jsearch.splash_candidates(kd, False)
    kd64 = search.parse_key(attention_key(32, 1024, 12, 64, "bfloat16"))
    assert search.splash_candidates(kd64, cuda) == []


def test_candidate_that_raises_fails_the_sweep(cache_file):
    """No quiet fallback: only running out of device memory skips a
    candidate (and is recorded); any other failure propagates."""
    def oom(kd, cfg, device, context):
        if cfg["i"] == 0:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return lambda: None

    def broken(kd, cfg, device, context):
        raise RuntimeError("kernel launch failed")

    search.register_op("_test_oom", lambda kd, dev: [{"i": 0}, {"i": 1}],
                       oom)
    search.register_op("_test_broken", lambda kd, dev: [{"i": 0}], broken)
    key = attention_key(1, 32, 2, 8, "float32", True)
    rec = search.tune("_test_oom", key, device=CPU)
    assert rec["config"] == {"i": 1}
    assert rec["meta"]["skipped"] == [[{"i": 0}, "oom"]]
    with pytest.raises(RuntimeError, match="launch failed"):
        search.tune("_test_broken", key, device=CPU)
    assert get_cache().lookup("_test_broken", key, backend="cpu:torch",
                              count=False) is None


def test_ring_raises_until_the_parallel_slice(cache_file):
    q, k, v = _t(_qkv(4))
    with pytest.raises(NotImplementedError, match="parallel"):
        dispatch.attention(q, k, v, variant="ring")
    with pytest.raises(NotImplementedError, match="parallel"):
        search.tune("ring_attention",
                    attention_key(1, 32, 2, 8, "float32", True), device=CPU)


def test_entry_points_want_the_card_unless_told(cache_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.choose(1, 32, 2, 8, "float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.tune_attention(1, 32, 2, 8, "float32")


# ----------------------------------------------------- dispatched kernels

@pytest.mark.parametrize("variant", ["dense", "flash"])
@pytest.mark.parametrize("layout", ["bsnh", "bnsh"])
def test_dispatched_variants_match_dense_reference(cache_file, variant,
                                                   layout):
    """The dispatched variant against JAX's _dense_reference on the same
    inputs (f32, 2e-5)."""
    arrays = _qkv(1, B=2, S=32, N=2, H=8, layout=layout)
    jin = [a.swapaxes(1, 2) if layout == "bnsh" else a for a in arrays]
    ref = np.asarray(jdense(*jin, True, None))
    out = dispatch.attention(*_t(arrays), causal=True, variant=variant,
                             layout=layout).numpy()
    if layout == "bnsh":
        out = out.swapaxes(1, 2)
    np.testing.assert_allclose(out, ref, atol=2e-5, err_msg=variant)


def test_dispatched_splash_matches_dense_reference(cache_file):
    arrays = _qkv(2, B=1, S=128, N=1, H=128)
    ref = np.asarray(jdense(*arrays, True, None))
    out = dispatch.attention(*_t(arrays), causal=True, variant="splash")
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


def test_attention_auto_consults_variant_record(cache_file):
    """With a flash crossover record planted, the dispatcher takes flash
    where the heuristic would say dense: measured beats static."""
    key = attention_key(1, 32, 2, 8, "float32", True)
    get_cache().put(dispatch.VARIANT_OP, key, {"variant": "flash"}, 1.0,
                    backend="cpu:torch")
    get_cache().put("flash_attention", key,
                    {"block_q": 16, "block_k": 16}, 1.0, backend="cpu:torch")
    arrays = _qkv(3)
    out = dispatch.attention(*_t(arrays), causal=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jdense(*arrays, True, None)),
                               atol=2e-5)
    assert dispatch.choose(1, 32, 2, 8, "float32", True,
                           device=CPU)[0] == "flash"


def test_model_auto_variant_uses_record(cache_file):
    from ray_tpu_torch.models.gpt import GPTConfig, _auto_attention_variant
    cfg = GPTConfig(num_heads=2, embed_dim=16, dtype=torch.float32)
    # cold cache: the static rule (the CPU -> dense)
    assert _auto_attention_variant(1, 32, cfg, CPU) == "dense"
    key = attention_key(1, 32, 2, 8, "float32", True)
    get_cache().put(dispatch.VARIANT_OP, key, {"variant": "flash"}, 1.0,
                    backend="cpu:torch")
    dispatch.clear_memo()
    assert _auto_attention_variant(1, 32, cfg, CPU) == "flash"
    # splash is never selectable from the model
    get_cache().put(dispatch.VARIANT_OP, key, {"variant": "splash"}, 0.5,
                    backend="cpu:torch")
    dispatch.clear_memo()
    assert _auto_attention_variant(1, 32, cfg, CPU) == "dense"


def test_metrics_counters():
    """The counters are plain floats/ints keyed by the reference's names."""
    am.reset()
    am.bump("autotune_cache_hits")
    am.bump("autotune_tune_ms", 12.5)
    st = am.stats()
    assert st["autotune_cache_hits"] == 1
    assert st["autotune_tune_ms"] == 12.5
    assert set(st) == set(am.COUNTER_NAMES) == set(jat.metrics.COUNTER_NAMES)


# ------------------------------------------------------------------ sweep

def test_sweep_needs_a_card_or_allow_cpu(cache_file, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--shapes", "1x256x2x128"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_sweep_allow_cpu_persists_records(cache_file, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--allow-cpu", "--shapes", "1x256x2x128",
                       "--dtype", "float32", "--compact"]) == 0
    out = capsys.readouterr().out
    assert "backend=cpu:torch" in out and '"variant"' in out
    key = attention_key(1, 256, 2, 128, "float32", True)
    assert AutotuneCache(cache_file).lookup(
        dispatch.VARIANT_OP, key, backend="cpu:torch",
        count=False) is not None
    assert "2x4096x32x128" in sweep.DEFAULT_SHAPES

"""The port's continuous-batching engine (ray_tpu_torch.serve.engine).

Mirrors the engine and allocator tests of tests/test_serve_streaming.py on
the CPU (``device="cpu"``), and holds the engine's streams to the JAX
package's dense greedy tokens from the same converted weights.
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import (GPTConfig, LlamaConfig, gpt_forward,
                                  llama_forward, params_from_jax)
from ray_tpu_torch.serve.engine import (DeadlineExceeded, EngineConfig,
                                        InferenceEngine, PageAllocator,
                                        table_row)

CPU = "cpu"


def _tiny_gpt():
    # f32 end to end: the paged-vs-dense equivalence is exact in f32.
    return GPTConfig(vocab_size=97, max_seq_len=96, num_layers=2,
                     num_heads=4, embed_dim=32, dtype=torch.float32,
                     attention="dense", remat=False)


def _tiny_llama():
    # GQA (4 query heads over 2 KV heads), f32, dense
    return LlamaConfig(vocab_size=97, max_seq_len=96, num_layers=2,
                       num_heads=4, num_kv_heads=2, embed_dim=32, mlp_dim=64,
                       dtype=torch.float32, attention="dense", remat=False)


# model name -> (its tiny config, the JAX module, the port's forward)
_FAMILIES = {"gpt": (_tiny_gpt, jgpt, gpt_forward),
             "llama": (_tiny_llama, jllama, llama_forward)}


def _params(cfg, model="gpt"):
    fields = dict(vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len,
                  num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                  embed_dim=cfg.embed_dim, dtype=jnp.float32,
                  attention="dense", remat=False)
    if model == "gpt":
        jcfg = jgpt.GPTConfig(**fields)
        jp = jgpt.gpt_init(jax.random.PRNGKey(0), jcfg)
    else:
        jcfg = jllama.LlamaConfig(num_kv_heads=cfg.num_kv_heads,
                                  mlp_dim=cfg.mlp_dim, **fields)
        jp = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    return jp, jcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     cfg, device=CPU)


def _greedy_dense(params, cfg, prompt, n, forward=gpt_forward):
    cur, out = list(prompt), []
    for _ in range(n):
        logits = forward(params, torch.tensor([cur]), cfg)
        out.append(int(torch.argmax(logits[0, -1])))
        cur.append(out[-1])
    return out


def test_page_allocator_accounting():
    alloc = PageAllocator(8)
    assert alloc.free_pages == 7           # page 0 reserved
    pages = alloc.alloc(3)
    assert 0 not in pages
    assert alloc.free_pages == 4
    with pytest.raises(MemoryError):
        alloc.alloc(5)
    alloc.free(pages)
    assert alloc.free_pages == 7
    with pytest.raises(ValueError):
        alloc.free([0])                    # scratch page is untouchable
    with pytest.raises(ValueError, match="double free"):
        alloc.free([pages[0]])
    assert table_row([3, 1], 4).tolist() == [3, 1, 0, 0]
    with pytest.raises(ValueError):
        table_row([1, 2, 3], 2)


def _check_concurrent_sequences(model):
    """One engine decodes 10 concurrent sequences (> the 8 slots, so
    admission queues and retires mid-run); every stream matches the dense
    greedy reference of the port and of the JAX package; pages and slots
    fully recover."""
    make_cfg, jmod, forward = _FAMILIES[model]
    cfg = make_cfg()
    jp, jcfg, params = _params(cfg, model)
    jforward = jmod.gpt_forward if model == "gpt" else jmod.llama_forward
    eng_cfg = EngineConfig(model=model, model_config=cfg, page_size=8,
                           num_pages=64, max_batch=8, max_prompt_len=32,
                           max_new_tokens=12, device=CPU)

    async def run_all():
        eng = InferenceEngine(eng_cfg, params=params)
        prompts = [[(7 * i + j) % 97 for j in range(3 + i % 5)]
                   for i in range(10)]

        async def consume(p):
            return [t async for t in eng.generate(p, 10)]

        results = await asyncio.gather(*[consume(p) for p in prompts])
        stats = eng.stats()
        eng.close()
        return prompts, results, stats

    prompts, results, stats = asyncio.run(run_all())
    for p, got in zip(prompts, results):
        assert got == _greedy_dense(params, cfg, p, 10, forward), p
    # The JAX package's dense greedy on the same weights, for two streams.
    for p, got in list(zip(prompts, results))[:2]:
        cur, want = list(p), []
        for _ in range(10):
            lg = jforward(jp, jnp.asarray([cur], jnp.int32), jcfg)
            want.append(int(jnp.argmax(lg[0, -1])))
            cur.append(want[-1])
        assert got == want, p
    assert stats["active"] == 0 and stats["waiting"] == 0
    assert stats["free_pages"] == 63           # everything returned
    # Continuous batching: 10 sequences of 10 tokens in far fewer than
    # 10*10 decode steps.
    assert stats["steps"] < 40, stats


def test_engine_concurrent_sequences_match_dense():
    _check_concurrent_sequences("gpt")


def test_engine_concurrent_llama_sequences_match_dense():
    """The LLaMA case: GQA pools at KV-head width, keys after RoPE."""
    _check_concurrent_sequences("llama")


def test_engine_llama_default_config():
    """model="llama" with no config serves LlamaConfig.tiny(seq=max_prompt
    + max_new) from seed 0."""
    eng_cfg = EngineConfig(model="llama", page_size=8, num_pages=16,
                           max_batch=2, max_prompt_len=16, max_new_tokens=8,
                           device=CPU)

    async def run():
        eng = InferenceEngine(eng_cfg)
        toks = [t async for t in eng.generate([1, 2, 3], 8)]
        eng.close()
        return eng, toks

    eng, toks = asyncio.run(run())
    assert eng.model_config == LlamaConfig.tiny(seq=24)
    assert eng._k_pages.shape == (2, 2, 16, 8, 16)
    assert len(toks) == 8


def test_engine_cancel_frees_pages():
    cfg = _tiny_gpt()
    eng_cfg = EngineConfig(model="gpt", model_config=cfg, page_size=8,
                           num_pages=64, max_batch=4, max_prompt_len=32,
                           max_new_tokens=32, device=CPU)

    async def run():
        eng = InferenceEngine(eng_cfg, params=_params(cfg)[2])
        agen = eng.generate([1, 2, 3], 32)
        first = await agen.__anext__()
        assert isinstance(first, int)
        await agen.aclose()                    # client disconnected
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            st = eng.stats()
            if st["active"] == 0 and st["free_pages"] == 63:
                break
            await asyncio.sleep(0.05)
        st = eng.stats()
        eng.close()
        return st

    st = asyncio.run(run())
    assert st["active"] == 0
    assert st["free_pages"] == 63, st


def test_engine_rejects_oversized_request():
    cfg = _tiny_gpt()
    eng_cfg = EngineConfig(model="gpt", model_config=cfg, page_size=8,
                           num_pages=4, max_batch=2, max_prompt_len=32,
                           max_new_tokens=32, device=CPU)  # 3 usable pages

    async def run():
        eng = InferenceEngine(eng_cfg)
        with pytest.raises(MemoryError, match="KV pages"):
            async for _ in eng.generate(list(range(30)), 32):
                pass
        eng.close()

    asyncio.run(run())


def test_engine_expired_deadline_raises_and_frees_pages():
    cfg = _tiny_gpt()
    eng_cfg = EngineConfig(model="gpt", model_config=cfg, page_size=8,
                           num_pages=16, max_batch=2, max_prompt_len=16,
                           max_new_tokens=8, device=CPU)

    async def run():
        eng = InferenceEngine(eng_cfg)
        with pytest.raises(DeadlineExceeded):
            async for _ in eng.generate([1, 2, 3], 8,
                                        deadline=time.time() - 1.0):
                pass
        st = eng.stats()
        eng.close()
        return st

    st = asyncio.run(run())
    assert st["active"] == 0 and st["free_pages"] == 15


def test_engine_config_checks():
    with pytest.raises(ValueError, match="unknown engine model 'mamba'"):
        InferenceEngine(EngineConfig(model="mamba", device=CPU))
    with pytest.raises(TypeError, match="LlamaConfig"):
        InferenceEngine(EngineConfig(model="llama", model_config=_tiny_gpt(),
                                     device=CPU))
    with pytest.raises(ValueError, match="multiple of page_size"):
        InferenceEngine(EngineConfig(max_prompt_len=30, device=CPU))
    with pytest.raises(ValueError, match="max_seq_len"):
        InferenceEngine(EngineConfig(model_config=_tiny_gpt(),
                                     max_prompt_len=96, device=CPU))

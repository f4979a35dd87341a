"""The port's GPT (ray_tpu_torch.models) against the JAX package's.

Weights come from the JAX init through ``params_from_jax``; tokens are
made with numpy.  Mirrors tests/test_models.py (forward shape, causality)
and the paged-decode equivalence of tests/test_serve_streaming.py, and
holds the port's logits and tokens to the JAX ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import (GPTConfig, gpt_decode_step, gpt_forward,
                                  gpt_init, gpt_prefill, init_paged_cache,
                                  params_from_jax, token_loglikes)
from ray_tpu_torch.models.gpt import param_shapes

CPU = "cpu"


def _configs(attention="dense", **kw):
    base = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
                embed_dim=32, attention=attention, remat=False, **kw)
    return (jgpt.GPTConfig(dtype=jnp.float32, **base),
            GPTConfig(dtype=torch.float32, **base))


def _jax_params(jcfg, seed=0):
    return jgpt.gpt_init(jax.random.PRNGKey(seed), jcfg)


def _port_params(jparams, cfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                           device=CPU)


def _tokens(B=4, S=32, vocab=128, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int64)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_matches_jax(attention):
    jcfg, cfg = _configs(attention)
    jp = _jax_params(jcfg)
    toks = _tokens()
    want = np.asarray(jgpt.gpt_forward(jp, jnp.asarray(toks, jnp.int32),
                                       jcfg))
    got = gpt_forward(_port_params(jp, cfg), torch.from_numpy(toks), cfg)
    assert got.shape == (4, 32, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flash_and_dense_forwards_agree():
    jcfg, cfg = _configs("dense")
    p = _port_params(_jax_params(jcfg), cfg)
    toks = torch.from_numpy(_tokens(B=2))
    dense = gpt_forward(p, toks, cfg)
    flash = gpt_forward(p, toks, dataclasses.replace(cfg, attention="flash"))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=1e-5)


def test_bf16_forward_close_to_jax():
    base = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
                embed_dim=32, attention="dense", remat=False)
    jcfg = jgpt.GPTConfig(dtype=jnp.bfloat16, **base)
    cfg = GPTConfig(dtype=torch.bfloat16, **base)
    jp = _jax_params(jcfg)
    toks = _tokens(B=2)
    want = np.asarray(jgpt.gpt_forward(jp, jnp.asarray(toks, jnp.int32),
                                       jcfg))
    got = gpt_forward(_port_params(jp, cfg), torch.from_numpy(toks), cfg)
    assert torch.isfinite(got).all()
    # bf16 rounds at other places in the two frameworks: a few bf16 ulps
    # of logits whose magnitude is ~0.1.
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)


def test_forward_causality():
    """Changing future tokens must not change past logits."""
    _, cfg = _configs("flash")
    p = gpt_init(0, cfg, device=CPU)
    toks = torch.from_numpy(_tokens())
    toks2 = toks.clone()
    toks2[:, 20:] = 0
    l1, l2 = gpt_forward(p, toks, cfg), gpt_forward(p, toks2, cfg)
    np.testing.assert_allclose(l1[:, :20].numpy(), l2[:, :20].numpy(),
                               atol=1e-5)


def test_token_loglikes_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5))
    want = jgpt.token_loglikes(jnp.asarray(logits), jnp.asarray(targets))
    got = token_loglikes(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_init_layout_and_seed():
    _, cfg = _configs()
    a, b = gpt_init(7, cfg, device=CPU), gpt_init(7, cfg, device=CPU)
    shapes = param_shapes(cfg)
    assert a["layers"]["attn"]["wqkv"].shape == (2, 32, 3, 2, 16)
    assert tuple(a["wte"].shape) == shapes["wte"]
    assert a["wte"].dtype == torch.float32
    torch.testing.assert_close(a["wte"], b["wte"], rtol=0, atol=0)
    gen = torch.Generator().manual_seed(7)
    torch.testing.assert_close(gpt_init(gen, cfg, device=CPU)["wte"],
                               a["wte"], rtol=0, atol=0)
    # MoE: the expert tree of the reference (router [L,D,E], experts on a
    # leading E dim); serving keeps the dense FFN and refuses it.
    moe_cfg = dataclasses.replace(cfg, num_experts=4)
    moe = gpt_init(0, moe_cfg, device=CPU)
    want = param_shapes(moe_cfg)["layers"]["mlp"]
    assert {k: tuple(v.shape) for k, v in moe["layers"]["mlp"].items()} == {
        "router": (2, 32, 4), "wi": (2, 4, 32, 128), "bi": (2, 4, 128),
        "wo": (2, 4, 128, 32), "bo": (2, 4, 32)} == want
    with pytest.raises(ValueError, match="dense FFN"):
        init_paged_cache(moe_cfg, 4, 8, device=CPU)


def test_params_from_jax_rejects_mismatched_trees():
    jcfg, cfg = _configs()
    tree = jax.tree_util.tree_map(np.asarray, _jax_params(jcfg))
    bad = dict(tree, extra=np.zeros(3))
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(bad, cfg, device=CPU)
    with pytest.raises(ValueError, match="wte"):
        params_from_jax(tree, dataclasses.replace(cfg, vocab_size=64),
                        device=CPU)


def test_attention_choices():
    _, cfg = _configs("ring")
    p = gpt_init(0, cfg, device=CPU)
    toks = torch.from_numpy(_tokens(B=1, S=8))
    # "ring" without a mesh is dense attention, as in the reference.
    dense = gpt_forward(p, toks, dataclasses.replace(cfg, attention="dense"))
    torch.testing.assert_close(gpt_forward(p, toks, cfg), dense, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="unknown attention"):
        gpt_forward(p, toks, dataclasses.replace(cfg, attention="nope"))
    # "auto" on the CPU is dense (flash applies on a device at S >= 1024).
    auto = gpt_forward(p, toks, dataclasses.replace(cfg, attention="auto"))
    dense = gpt_forward(p, toks, dataclasses.replace(cfg, attention="dense"))
    torch.testing.assert_close(auto, dense, rtol=0, atol=0)


# ----------------------------------------------------------- paged decode


def _paged_tokens(prefill, decode, params, cfg, kp, vp, prompt, pt, S, n,
                  arr, as_len, argmax):
    """Greedy tokens: prefill, then n-1 decode steps (``arr`` makes the
    framework's index arrays from numpy)."""
    toks = np.zeros((1, S), np.int64)
    toks[0, :len(prompt)] = prompt
    logits, kp, vp = prefill(params, cfg, arr(toks), as_len(len(prompt)),
                             kp, vp, arr(pt))
    tok, pos, out = argmax(logits[0]), len(prompt), []
    out.append(tok)
    for _ in range(n - 1):
        lg, kp, vp = decode(params, cfg, arr(np.array([tok])),
                            arr(np.array([pos])), kp, vp, arr(pt))
        tok = argmax(lg[0])
        out.append(tok)
        pos += 1
    return out, logits


@pytest.mark.parametrize("prompt", [[5, 17, 3, 88, 41], list(range(1, 17))])
def test_paged_prefill_and_decode_tokens_match_jax(prompt):
    """Greedy tokens through prefill + decode equal the JAX ones exactly
    in f32.  With the 16-token prompt, decode writes positions 16..23: the
    table's last page, up to its last slot."""
    jcfg, cfg = _configs()
    jp = _jax_params(jcfg)
    page, n = 8, 9
    pt = np.array([[1, 2, 3]], np.int64)
    S = 16

    jk, jv = jgpt.init_paged_cache(jcfg, 8, page)
    want, jlogits = _paged_tokens(
        jgpt.gpt_prefill, jgpt.gpt_decode_step, jp, jcfg, jk, jv, prompt, pt,
        S, n, lambda t: jnp.asarray(t, jnp.int32), jnp.int32,
        lambda x: int(jnp.argmax(x)))

    p = _port_params(jp, cfg)
    kp, vp = init_paged_cache(cfg, 8, page, device=CPU)
    got, logits = _paged_tokens(
        gpt_prefill, gpt_decode_step, p, cfg, kp, vp, prompt, pt, S, n,
        torch.from_numpy, int,
        lambda x: int(torch.argmax(x)))
    assert got == want
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    # The port's own contract: paged greedy equals its dense greedy.
    cur, dense = list(prompt), []
    for _ in range(n):
        lg = gpt_forward(p, torch.tensor([cur]), cfg)
        dense.append(int(torch.argmax(lg[0, -1])))
        cur.append(dense[-1])
    assert got == dense


def test_prefill_rejects_bad_length():
    _, cfg = _configs()
    p = gpt_init(0, cfg, device=CPU)
    kp, vp = init_paged_cache(cfg, 4, 8, device=CPU)
    with pytest.raises(ValueError, match="length"):
        gpt_prefill(p, cfg, torch.zeros((1, 8), dtype=torch.long), 0, kp, vp,
                    torch.tensor([[1, 2]]))

"""The port's LLaMA (ray_tpu_torch.models.llama) against the JAX package's.

Weights come from the JAX init through ``params_from_jax``; tokens are
made with numpy.  Mirrors tests/test_llama.py (forward shape and param
tree, causality, RoPE, GQA against MHA, the grouped dense path against the
repeat path, a falling train-step loss; not the sharded test, which needs
the parallel layer), ``test_llama_paged_decode_matches_dense`` of
tests/test_serve_streaming.py and ``test_blocked_ce_llama_and_ragged_block``
of tests/test_models.py, and holds the port to the JAX package in f32:

- forward logits rtol 1e-4, atol 1e-4, dense and flash attention (the JAX
  flash kernel in interpret mode, the port's plain version);
- loss rtol 1e-5 and grads rtol 2e-4, atol 2e-5 against
  ``jax.grad(llama_loss)``, full and blocked (``"dv"``) head;
- the paged prefill and decode tokens equal JAX's;
- two AdamW steps against ``make_train_step`` with
  ``optax.adamw(3e-4, b2=0.95)``: params atol 1e-6.

The configs have 6 query heads over 2 KV heads (rep 3) or 6 (rep 1), so a
wrong pairing of query and KV heads cannot pass.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import (LlamaConfig, apply_rope,
                                  blocked_ce_loglike_sum, llama_decode_step,
                                  llama_forward, llama_init,
                                  llama_init_paged_cache, llama_loss,
                                  llama_make_train_state,
                                  llama_make_train_step, llama_prefill,
                                  params_from_jax, params_to_numpy,
                                  rope_tables)
from ray_tpu_torch.models.gpt import _dense_causal_attention_bnsh
from ray_tpu_torch.models.llama import (_dense_causal_attention_gqa,
                                        param_shapes)
from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP

CPU = "cpu"
BASE = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=6,
            num_kv_heads=2, embed_dim=48, mlp_dim=64, remat=False)


def _configs(**kw):
    cfg = dict(BASE, **kw)
    return (jllama.LlamaConfig(dtype=jnp.float32, **cfg),
            LlamaConfig(dtype=torch.float32, **cfg))


def _tokens(B=4, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"],
                                                (B, S), dtype=np.int64)


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _jax_params(jcfg, seed=0):
    return jllama.llama_init(jax.random.PRNGKey(seed), jcfg)


def _port_params(jparams, cfg, grad=False):
    params = params_from_jax(_tree(jparams), cfg, device=CPU)
    for leaf in _flat(params).values():
        leaf.requires_grad_(grad)
    return params


def _assert_grads_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("num_kv_heads", [2, 6])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_matches_jax(attention, num_kv_heads):
    jcfg, cfg = _configs(attention=attention, num_kv_heads=num_kv_heads)
    jp = _jax_params(jcfg)
    toks = _tokens()
    want = np.asarray(jllama.llama_forward(
        jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = llama_forward(_port_params(jp, cfg), torch.from_numpy(toks), cfg)
    assert got.shape == (4, 32, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_forward_shape_and_param_tree():
    """The port's tree has the reference's names and shapes, leaf for
    leaf; one seed gives the same weights; a head count that the KV heads
    do not divide is refused."""
    jcfg, cfg = _configs()
    want = {k: v.shape for k, v in _flat(_tree(_jax_params(jcfg))).items()}
    a = llama_init(7, cfg, device=CPU)
    got = {k: tuple(v.shape) for k, v in _flat(a).items()}
    assert got == want == _flat(param_shapes(cfg))
    assert all(v.dtype == torch.float32 for v in _flat(a).values())
    torch.testing.assert_close(llama_init(7, cfg, device=CPU)["lm_head"],
                               a["lm_head"], rtol=0, atol=0)
    logits = llama_forward(a, torch.from_numpy(_tokens()), cfg)
    assert logits.shape == (4, 32, 128)
    with pytest.raises(ValueError, match="divisible"):
        llama_init(0, dataclasses.replace(cfg, num_kv_heads=4), device=CPU)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_llama_causality(attention):
    _, cfg = _configs(attention=attention)
    p = llama_init(0, cfg, device=CPU)
    toks = torch.from_numpy(_tokens())
    toks2 = toks.clone()
    toks2[:, 20:] = 0
    l1, l2 = llama_forward(p, toks, cfg), llama_forward(p, toks2, cfg)
    np.testing.assert_allclose(l1[:, :20].numpy(), l2[:, :20].numpy(),
                               atol=1e-5)


def test_rope_preserves_norm_and_relative_phase():
    cos, sin = rope_tables(8, 4, 10000.0)
    # The tables are the reference's, bit for bit.
    jcos, jsin = jllama.rope_tables(8, 4, 10000.0)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 8, 4)).astype(np.float32))
    y = apply_rope(x, cos, sin)
    np.testing.assert_allclose(np.asarray(jllama.apply_rope(
        jnp.asarray(x.numpy()), jcos, jsin)), y.numpy(), rtol=1e-6,
        atol=1e-6)
    # Rotation preserves per-position norms; position 0 is the identity.
    np.testing.assert_allclose(x.norm(dim=-1).numpy(),
                               y.norm(dim=-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(y[..., 0, :].numpy(), x[..., 0, :].numpy(),
                               rtol=1e-5)
    # q.k after RoPE depends only on the relative distance.
    rng = np.random.default_rng(1)
    qv, kv = (torch.from_numpy(rng.standard_normal(4).astype(np.float32))
              for _ in range(2))
    qr = apply_rope(qv.expand(1, 1, 8, 4), cos, sin)
    kr = apply_rope(kv.expand(1, 1, 8, 4), cos, sin)
    d1 = float((qr[..., 3, :] * kr[..., 1, :]).sum())
    d2 = float((qr[..., 4, :] * kr[..., 2, :]).sum())
    np.testing.assert_allclose(d1, d2, rtol=1e-4)
    # bf16 rotates in f32 and casts back once.
    xb = x.to(torch.bfloat16)
    assert apply_rope(xb, cos, sin).dtype == torch.bfloat16
    torch.testing.assert_close(apply_rope(xb, cos, sin),
                               apply_rope(xb.float(), cos, sin).bfloat16(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_gqa_equals_mha_when_kv_heads_match(attention):
    """Each KV head duplicated for its query heads (kv heads 2 -> 6): the
    MHA model's logits equal the GQA model's."""
    _, cfg = _configs(attention=attention)
    params = llama_init(0, cfg, device=CPU)
    toks = torch.from_numpy(_tokens())
    out_gqa = llama_forward(params, toks, cfg)
    rep = cfg.num_heads // cfg.num_kv_heads
    mha = dict(params, layers=dict(params["layers"], attn=dict(
        params["layers"]["attn"],
        wkv=params["layers"]["attn"]["wkv"].repeat_interleave(rep, dim=3))))
    out_mha = llama_forward(mha, toks, dataclasses.replace(
        cfg, num_kv_heads=cfg.num_heads))
    np.testing.assert_allclose(out_gqa.numpy(), out_mha.numpy(), atol=2e-5)


def test_gqa_grouped_matches_repeat_path():
    """The grouped dense attention equals the materialised repeat (query
    head n with KV head n // rep) and the reference's grouped function."""
    rng = np.random.default_rng(0)
    B, G, rep, S, H = 2, 2, 3, 16, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, G * rep, S, H), (B, G, S, H), (B, G, S, H)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    grouped = _dense_causal_attention_gqa(tq, tk, tv, rep)
    repeated = _dense_causal_attention_bnsh(
        tq, tk.repeat_interleave(rep, dim=1), tv.repeat_interleave(rep, dim=1))
    np.testing.assert_allclose(grouped.numpy(), repeated.numpy(), atol=1e-5)
    want = jllama._dense_causal_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), rep)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------- training


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params(_configs()[0])


def _port_loss_and_grads(params, toks, cfg):
    for leaf in _flat(params).values():
        leaf.grad = None
    loss = llama_loss(params, {"tokens": torch.from_numpy(toks)}, cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy()
                                  for k, v in _flat(params).items()}


@pytest.mark.parametrize("ce_block", [0, 8])
@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_loss_and_grads_match_jax(jax_params, attention, ce_block):
    jcfg, cfg = _configs(attention=attention, ce_block=ce_block)
    toks = _tokens(S=33)
    loss, grads = jax.value_and_grad(jllama.llama_loss)(
        jax_params, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    got_loss, got = _port_loss_and_grads(
        _port_params(jax_params, cfg, grad=True), toks, cfg)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    _assert_grads_close(got, _flat(_tree(grads)), rtol=2e-4, atol=2e-5)
    # the untied head has its own grad, not the embedding's
    assert np.abs(got["lm_head"]).max() > 0


def test_blocked_ce_llama_and_ragged_block(monkeypatch):
    """LlamaConfig.ce_block (the "dv" head layout) equals the full head; a
    block that does not divide S falls back to one chunk and says so."""
    jcfg, cfg = _configs()
    params = _port_params(_jax_params(jcfg), cfg)
    batch = {"tokens": torch.from_numpy(_tokens(B=2, S=33))}
    l0 = float(llama_loss(params, batch, cfg))
    l8 = float(llama_loss(params, batch, dataclasses.replace(cfg,
                                                             ce_block=8)))
    np.testing.assert_allclose(l8, l0, rtol=1e-5)
    ragged = dataclasses.replace(cfg, ce_block=7)
    with pytest.warns(RuntimeWarning, match="memory win is LOST"):
        l7 = float(llama_loss(params, batch, ragged))
    np.testing.assert_allclose(l7, l0, rtol=1e-5)
    monkeypatch.setenv("RT_STRICT_CE_BLOCK", "1")
    with pytest.raises(ValueError, match="ce_block=7"):
        llama_loss(params, batch, ragged)
    with pytest.raises(ValueError, match="head_layout"):
        blocked_ce_loglike_sum(torch.zeros((1, 16, 48)), params["lm_head"],
                               torch.zeros((1, 16), dtype=torch.long), 8,
                               "nope")


class _CountOps(TorchDispatchMode):
    """Counts runs of the flash forward op and of 2-d matmuls (a
    selective-checkpoint policy that saves an op's output serves its
    recompute from the cache, unseen here)."""

    def __init__(self):
        super().__init__()
        self.flash = self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.flash += func == FLASH_FWD_OP
        self.mm += func == torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_remat_policies_match_no_remat(jax_params, attention):
    """Every policy gives the remat=False grads; "dots" recomputes none of
    the projections (each a 2-d matmul it saves), so its forward and
    backward run as many matmuls as remat=False's, and "full" more."""
    _, cfg = _configs(attention=attention, ce_block=8)
    params = _port_params(jax_params, cfg, grad=True)
    toks = _tokens(S=33)
    with _CountOps() as count:
        l0, g0 = _port_loss_and_grads(params, toks, cfg)
    mm = {"none": count.mm}
    L = cfg.num_layers
    for policy, runs in (("full", 2 * L), ("dots", 2 * L), ("attn", L),
                         ("attn_dots", L)):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        said = (pytest.warns(UserWarning, match="dense attention")
                if attention == "dense" and policy.startswith("attn")
                else contextlib.nullcontext())
        with said, _CountOps() as count:
            loss, grads = _port_loss_and_grads(params, toks, rcfg)
        np.testing.assert_allclose(loss, l0, rtol=1e-6)
        _assert_grads_close(grads, g0, rtol=1e-6, atol=1e-7)
        assert count.flash == (runs if attention == "flash" else 0), policy
        mm[policy] = count.mm
    assert mm["dots"] == mm["attn_dots"] == mm["none"] < mm["full"], mm


def test_two_adamw_steps_match_jax(jax_params):
    """bench.py's LLaMA path at tiny width: flash, remat "dots", blocked
    CE, optax.adamw(3e-4, b2=0.95) (weight decay 1e-4, optax's default).

    Params atol 1e-6, except where a grad cancels to within 100 eps of
    zero (|g| < 1e-6 in a step): there Adam divides the grads' f32
    rounding difference by |g| + eps, so each such element is held
    instead to 1e-6 plus lr x sum over steps of |g - g_jax| / eps (Adam's
    update moves at most 1/eps per unit of grad), with the grads measured
    in the same steps and themselves held to rtol 2e-4, atol 2e-5."""
    lr, eps = 3e-4, 1e-8
    jcfg, cfg = _configs(attention="flash", remat=True, remat_policy="dots",
                         ce_block=8)
    tx = optax.adamw(lr, b2=0.95, eps=eps)
    jstep = jllama.make_train_step(jcfg, tx, donate=False)
    jp, jstate = jax_params, tx.init(jax_params)
    params, opt = llama_make_train_state(0, cfg, learning_rate=lr,
                                         weight_decay=1e-4, device=CPU)
    start = _flat(params_from_jax(_tree(jax_params), cfg, device=CPU))
    with torch.no_grad():
        for name, leaf in _flat(params).items():
            leaf.copy_(start[name])
    step = llama_make_train_step(cfg, opt)
    ill = {name: np.zeros(v.shape, bool) for name, v in start.items()}
    spread = {name: np.zeros(v.shape) for name, v in start.items()}
    for seed in (1, 2):
        toks = _tokens(S=33, seed=seed)
        batch = {"tokens": jnp.asarray(toks, jnp.int32)}
        jgrads = _flat(_tree(jax.grad(jllama.llama_loss)(jp, batch, jcfg)))
        jp, jstate, jm = jstep(jp, jstate, batch)
        m = step(params, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        grads = {k: v.grad.numpy() for k, v in _flat(params).items()}
        _assert_grads_close(grads, jgrads, rtol=2e-4, atol=2e-5)
        want = _flat(_tree(jp))
        got = _flat(params_to_numpy(params))
        assert got.keys() == want.keys()
        for name in want:
            ill[name] |= np.abs(jgrads[name]) < 1e-6
            spread[name] += lr * np.abs(grads[name] - jgrads[name]) / eps
            atol = np.where(ill[name], 1e-6 + spread[name], 1e-6)
            err = np.abs(got[name] - want[name])
            assert (err <= atol).all(), (name, float(err.max()),
                                         int((err > 1e-6).sum()))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_llama_train_step_loss_decreases(attention):
    """Single-device twin of test_llama_train_step_loss_decreases (Adam
    1e-2, i.e. AdamW without decay)."""
    _, cfg = _configs(attention=attention)
    params, opt = llama_make_train_state(0, cfg, learning_rate=1e-2,
                                         weight_decay=0.0, device=CPU)
    step = llama_make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(_tokens(B=8, S=33))}
    losses = [float(step(params, batch)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_state_settings():
    _, cfg = _configs()
    params, opt = llama_make_train_state(0, cfg, device=CPU)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.95), 1e-8, 0.1)
    leaves = list(_flat(params).values())
    assert len(group["params"]) == len(leaves)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in leaves)


def test_params_round_trip_and_mismatched_trees(jax_params):
    _, cfg = _configs()
    tree = _tree(jax_params)
    back = _flat(params_to_numpy(params_from_jax(tree, cfg, device=CPU)))
    for name, want in _flat(tree).items():
        np.testing.assert_array_equal(back[name], want)
    with pytest.raises(KeyError, match="wpe"):
        params_from_jax(dict(tree, wpe=np.zeros(3)), cfg, device=CPU)
    with pytest.raises(ValueError, match="wte"):
        params_from_jax(tree, dataclasses.replace(cfg, vocab_size=64),
                        device=CPU)


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


def _greedy_dense(params, cfg, prompt, n):
    cur, out = list(prompt), []
    for _ in range(n):
        lg = llama_forward(params, torch.tensor([cur]), cfg)
        out.append(int(torch.argmax(lg[0, -1])))
        cur.append(out[-1])
    return out


@pytest.mark.parametrize("prompt", [[5, 17, 3, 88, 41], list(range(1, 17))])
def test_paged_prefill_and_decode_tokens_match_jax(prompt):
    """Greedy tokens through prefill + decode equal the JAX ones exactly
    in f32; with the 16-token prompt decode writes the table's last page
    up to its last slot."""
    jcfg, cfg = _configs(attention="dense")
    jp = _jax_params(jcfg)
    page, n = 8, 9
    pt = np.array([[1, 2, 3]], np.int64)
    S = 16
    jk, jv = jllama.llama_init_paged_cache(jcfg, 8, page)
    want, jlogits = _paged_tokens(
        jllama.llama_prefill, jllama.llama_decode_step, jp, jcfg, jk, jv,
        prompt, pt, S, n, lambda t: jnp.asarray(t, jnp.int32), jnp.int32,
        lambda x: int(jnp.argmax(x)))
    p = _port_params(jp, cfg)
    kp, vp = llama_init_paged_cache(cfg, 8, page, device=CPU)
    got, logits = _paged_tokens(
        llama_prefill, llama_decode_step, p, cfg, kp, vp, prompt, pt, S, n,
        torch.from_numpy, int, lambda x: int(torch.argmax(x)))
    assert got == want
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    assert got == _greedy_dense(p, cfg, prompt, n)


def test_llama_paged_decode_matches_dense():
    """Mirror of tests/test_serve_streaming.py's test: the pools are at
    KV-head width, prefill's logits equal the dense forward's last
    position, and ten paged greedy tokens equal the dense greedy ones."""
    cfg = LlamaConfig(vocab_size=97, max_seq_len=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, embed_dim=32, mlp_dim=64,
                      dtype=torch.float32, attention="dense", remat=False)
    params = llama_init(0, cfg, device=CPU)
    kp, vp = llama_init_paged_cache(cfg, 32, 8, device=CPU)
    assert kp.shape[1] == cfg.num_kv_heads
    prompt = [5, 17, 3, 88, 41]
    toks = torch.tensor([prompt + [0] * (8 - len(prompt))])
    pt = torch.tensor([[1, 2, 0, 0]])
    logits, kp, vp = llama_prefill(params, cfg, toks, len(prompt), kp, vp,
                                   pt)
    dense = llama_forward(params, toks[:, :len(prompt)], cfg)
    np.testing.assert_allclose(logits[0].numpy(), dense[0, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    tok, pos, out = int(torch.argmax(logits[0])), len(prompt), []
    out.append(tok)
    for _ in range(9):
        lg, kp, vp = llama_decode_step(params, cfg, torch.tensor([tok]),
                                       torch.tensor([pos]), kp, vp, pt)
        tok = int(torch.argmax(lg[0]))
        out.append(tok)
        pos += 1
    assert out == _greedy_dense(params, cfg, prompt, 10)
    with pytest.raises(ValueError, match="length"):
        llama_prefill(params, cfg, toks, 0, kp, vp, pt)

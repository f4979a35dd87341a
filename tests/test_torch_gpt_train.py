"""The port's GPT training path against the JAX package's.

Weights come from the JAX init through ``params_from_jax``; tokens are
made with numpy.  Held to ``ray_tpu.models.gpt`` on the CPU in f32:
``gpt_loss`` and its grads (flash and dense attention, full and blocked
cross-entropy head; mirrors tests/test_models.py's
``test_blocked_ce_matches_unblocked``), the ragged-block fallback, every
remat policy against ``remat=False``, two AdamW steps against
``make_train_step`` with ``optax.adamw(3e-4, b2=0.95)``, and a loss that
falls over five steps (``test_gpt_train_step_loss_decreases``).

Tolerances (f32 on both sides, sums in another order): loss rtol 1e-5;
grads rtol 2e-4, atol 2e-5 (those of test_blocked_ce_matches_unblocked);
updated params atol 1e-6 (two steps of lr 3e-4 move each param by at most
6e-4).  Remat changes only what is recomputed, so its grads must agree to
f32 rounding (rtol 1e-6, atol 1e-7).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import (GPTConfig, gpt_loss, make_train_state,
                                  make_train_step, params_from_jax,
                                  params_to_numpy)
from ray_tpu_torch.models.gpt import DENSE_ATTENTION_OP
from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP

CPU = "cpu"
BASE = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
            embed_dim=32)


def _configs(**kw):
    cfg = dict(BASE, **kw)
    return (jgpt.GPTConfig(dtype=jnp.float32, **cfg),
            GPTConfig(dtype=torch.float32, **cfg))


def _tokens(B=4, S=33, seed=0):
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


def _port_params(jparams, cfg):
    params = params_from_jax(_tree(jparams), cfg, device=CPU)
    for leaf in _flat(params).values():
        leaf.requires_grad_(True)
    return params


def _port_loss_and_grads(params, toks, cfg):
    for leaf in _flat(params).values():
        leaf.grad = None
    loss = gpt_loss(params, {"tokens": torch.from_numpy(toks)}, cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy()
                                  for k, v in _flat(params).items()}


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.gpt_init(jax.random.PRNGKey(0), _configs()[0])


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params):
    """JAX loss and grads per (attention, ce_block), computed once."""
    toks = jnp.asarray(_tokens(), jnp.int32)
    out = {}
    for attention in ("flash", "dense"):
        for ce_block in (0, 8):
            jcfg, _ = _configs(attention=attention, ce_block=ce_block)
            loss, grads = jax.value_and_grad(jgpt.gpt_loss)(
                jax_params, {"tokens": toks}, jcfg)
            out[attention, ce_block] = (float(loss), _flat(_tree(grads)))
    return out


def _assert_grads_close(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("ce_block", [0, 8])
@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_loss_and_grads_match_jax(jax_params, jax_loss_and_grads, attention,
                                  ce_block):
    _, cfg = _configs(attention=attention, ce_block=ce_block)
    loss, grads = _port_loss_and_grads(_port_params(jax_params, cfg),
                                       _tokens(), cfg)
    want_loss, want_grads = jax_loss_and_grads[attention, ce_block]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads_close(grads, want_grads, rtol=2e-4, atol=2e-5)


def test_blocked_ce_matches_unblocked(jax_params):
    _, cfg = _configs()
    params = _port_params(jax_params, cfg)
    l0, g0 = _port_loss_and_grads(params, _tokens(), cfg)
    l1, g1 = _port_loss_and_grads(
        params, _tokens(), dataclasses.replace(cfg, ce_block=8))
    np.testing.assert_allclose(l0, l1, rtol=1e-5)
    _assert_grads_close(g1, g0, rtol=2e-4, atol=2e-5)


def test_ragged_ce_block_warns_or_raises(jax_params, monkeypatch):
    """7 does not divide S = 32: one full-logits chunk, said loudly, or a
    ValueError under RT_STRICT_CE_BLOCK=1 (as the reference does)."""
    _, cfg = _configs()
    params = _port_params(jax_params, cfg)
    ragged = dataclasses.replace(cfg, ce_block=7)
    batch = {"tokens": torch.from_numpy(_tokens())}
    with pytest.warns(RuntimeWarning, match="memory win is LOST"):
        loss = gpt_loss(params, batch, ragged)
    np.testing.assert_allclose(float(loss), float(gpt_loss(params, batch,
                                                           cfg)), rtol=1e-5)
    monkeypatch.setenv("RT_STRICT_CE_BLOCK", "1")
    with pytest.raises(ValueError, match="ce_block=7"):
        gpt_loss(params, batch, ragged)


class _CountAttention(TorchDispatchMode):
    """Counts the runs of the attention ops, flash and dense (a
    selective-checkpoint policy that saves an op's output serves the
    recompute from its cache)."""

    def __init__(self):
        super().__init__()
        self.runs = {FLASH_FWD_OP: 0, DENSE_ATTENTION_OP: 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.runs:
            self.runs[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_remat_policies_match_no_remat(jax_params, attention):
    """Every policy gives the remat=False grads; "attn" and "attn_dots"
    save the attention op's output on both paths, as the reference saves
    "attn_out", so its forward runs once per layer, where "full" and
    "dots" run it again in the backward."""
    _, cfg = _configs(attention=attention, ce_block=8, remat=False)
    params = _port_params(jax_params, cfg)
    l0, g0 = _port_loss_and_grads(params, _tokens(), cfg)
    L = cfg.num_layers
    op, other = ((FLASH_FWD_OP, DENSE_ATTENTION_OP) if attention == "flash"
                 else (DENSE_ATTENTION_OP, FLASH_FWD_OP))
    for policy, runs in (("full", 2 * L), ("dots", 2 * L), ("attn", L),
                         ("attn_dots", L)):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with _CountAttention() as count:
                loss, grads = _port_loss_and_grads(params, _tokens(), rcfg)
        np.testing.assert_allclose(loss, l0, rtol=1e-6)
        _assert_grads_close(grads, g0, rtol=1e-6, atol=1e-7)
        assert (count.runs[op], count.runs[other]) == (runs, 0), policy
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(params, _tokens(), dataclasses.replace(
            cfg, remat=True, remat_policy="nope"))


def test_two_adamw_steps_match_jax(jax_params):
    """bench.py's path at tiny width: flash, remat "dots", blocked CE,
    optax.adamw(3e-4, b2=0.95) (weight decay 1e-4, optax's default)."""
    jcfg, cfg = _configs(attention="flash", remat_policy="dots", ce_block=8)
    tx = optax.adamw(3e-4, b2=0.95)
    jstep = jgpt.make_train_step(jcfg, tx, donate=False)
    jp, jstate = jax_params, tx.init(jax_params)
    params, opt = make_train_state(0, cfg, learning_rate=3e-4,
                                   weight_decay=1e-4, device=CPU)
    start = _flat(params_from_jax(_tree(jax_params), cfg, device=CPU))
    with torch.no_grad():
        for name, leaf in _flat(params).items():
            leaf.copy_(start[name])
    step = make_train_step(cfg, opt)
    for seed in (1, 2):
        toks = _tokens(seed=seed)
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(toks,
                                                                  jnp.int32)})
        m = step(params, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        want = _flat(_tree(jp))
        got = _flat(params_to_numpy(params))
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-6, err_msg=name)


def test_train_step_loss_decreases():
    """Single-device twin of test_gpt_train_step_loss_decreases (Adam
    1e-2, i.e. AdamW without decay)."""
    _, cfg = _configs()
    params, opt = make_train_state(0, cfg, learning_rate=1e-2,
                                   weight_decay=0.0, device=CPU)
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(_tokens(B=8))}
    losses = [float(step(params, batch)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_state_settings():
    _, cfg = _configs()
    params, opt = make_train_state(0, cfg, device=CPU)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (3e-4, (0.9, 0.95), 1e-8, 0.1)
    leaves = list(_flat(params).values())
    assert len(group["params"]) == len(leaves)
    assert all(p.requires_grad and p.dtype == torch.float32 for p in leaves)


def test_params_round_trip_through_numpy(jax_params):
    _, cfg = _configs()
    tree = _tree(jax_params)
    back = _flat(params_to_numpy(params_from_jax(tree, cfg, device=CPU)))
    for name, want in _flat(tree).items():
        np.testing.assert_array_equal(back[name], want)

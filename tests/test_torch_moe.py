"""The port's MoE (ops/moe.py, MoE GPT) against the JAX package's.

Mirrors tests/test_moe.py: E=1 equals the dense FFN, the ep-sharded
forward equals the unsharded one (dp=2 x ep=4, a gloo gang of 8 ranks with
a 120 s deadline; rank functions in ``_torch_gang.py``), capacity drops
overflow tokens, a uniform router's aux loss is 1 (top-1 ties to expert
0), every expert gets gradient, and (``slow``, as there) training learns.

Adds, on seeded numpy inputs in f32 against ``ray_tpu``:
- ``moe_router``: dispatch equal, combine within atol 1e-6, aux 1e-6;
- ``moe_mlp``: y within atol 1e-5 and aux 1e-6, unsharded, in GSPMD mode
  on the mesh, and in ``ep_axis`` mode under shard_map;
- MoE GPT ``gpt_loss`` within rtol 1e-5 and its grads within 1e-3 x each
  leaf's max |grad| of ``jax.grad(gpt_loss)``, full and blocked heads;
- two AdamW steps against ``make_train_step`` (loss rtol 1e-5, grad norm
  rtol 1e-4, params atol 1e-6: test_torch_gpt_train.py's limits);
- under remat "dots" the MoE einsums (``aten.bmm``: they have batch dims)
  are recomputed and the mms saved, as ``dots_with_no_batch_dims_saveable``
  treats the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_gang as gang
from ray_tpu.models import gpt as jgpt
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.models import (GPTConfig, gpt_forward, gpt_init,
                                  gpt_forward_with_aux, gpt_loss,
                                  make_train_state, make_train_step,
                                  params_from_jax, params_to_numpy)
from ray_tpu_torch.ops.moe import moe_mlp, moe_router

CPU = "cpu"
BASE = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
            embed_dim=32, num_experts=4, expert_top_k=2)


def _configs(**kw):
    cfg = dict(BASE, **kw)
    return (jgpt.GPTConfig(dtype=jnp.float32, **cfg),
            GPTConfig(dtype=torch.float32, **cfg))


def _moe_cfg(**kw):
    return _configs(**kw)[1]


def _tokens(b=8, s=33, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s),
                                                dtype=np.int64)


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _mlp_inputs(seed=0, B=4, S=16, D=8, E=4, M=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "wi": 0.3 * rng.standard_normal((E, D, M)).astype(np.float32),
         "bi": 0.1 * rng.standard_normal((E, M)).astype(np.float32),
         "wo": 0.3 * rng.standard_normal((E, M, D)).astype(np.float32),
         "bo": 0.1 * rng.standard_normal((E, D)).astype(np.float32)}
    return x, p


def _jax_mlp(x, p):
    y, aux = jmoe.moe_mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in p.items()},
                          top_k=2, capacity_factor=1.25)
    return np.asarray(y), float(aux)


@pytest.fixture(scope="module")
def jparams():
    return jgpt.gpt_init(jax.random.PRNGKey(1), _configs()[0])


@pytest.fixture(scope="module")
def world8(jparams):
    x, p = _mlp_inputs()
    return gang.run(gang.moe_world8, 8, (_tree(jparams), _tokens()[:, :-1],
                                         x, p), timeout_s=120)[0]


def test_single_expert_equals_dense():
    """E=1, top_k=1, capacity=S: routing is the identity, so the MoE FFN
    must reproduce the dense MLP (same weights)."""
    dense_cfg = _moe_cfg(num_experts=0)
    moe_cfg = _moe_cfg(num_experts=1, expert_top_k=1, capacity_factor=1.0)
    dense = gpt_init(0, dense_cfg, device=CPU)
    moe = gpt_init(0, moe_cfg, device=CPU)
    for k in ("wi", "bi", "wo", "bo"):
        moe["layers"]["mlp"][k] = dense["layers"]["mlp"][k][:, None]
    for k in ("wte", "wpe", "ln_f"):
        moe[k] = dense[k]
    for k in ("ln1", "attn", "ln2"):
        moe["layers"][k] = dense["layers"][k]
    toks = torch.from_numpy(_tokens()[:, :-1])
    torch.testing.assert_close(gpt_forward(moe, toks, moe_cfg),
                               gpt_forward(dense, toks, dense_cfg),
                               rtol=1e-5, atol=1e-5)


def test_ep_sharded_matches_unsharded(jparams, world8):
    jcfg, cfg = _configs()
    toks = _tokens()[:, :-1]
    ref, aux_ref = jgpt.gpt_forward_with_aux(
        jparams, jnp.asarray(toks, jnp.int32), jcfg)
    np.testing.assert_allclose(world8["logits"], np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    assert abs(world8["aux"] - float(aux_ref)) < 1e-4
    # and the port unsharded, on the same weights
    got, aux = gpt_forward_with_aux(params_from_jax(_tree(jparams), cfg,
                                                    device=CPU),
                                    torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(world8["logits"], got.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert abs(world8["aux"] - float(aux)) < 1e-4


def test_capacity_drops_overflow_tokens():
    """With capacity 1 and all tokens routed to one expert, only one token
    per (batch row, expert) gets dispatched."""
    B, S, D, E = 2, 8, 4, 4
    x = torch.ones((B, S, D))
    dispatch, combine, _ = moe_router(x, torch.zeros((D, E)), top_k=1,
                                      capacity=1)
    assert float(dispatch.sum()) == B * 1
    assert float(combine.sum()) == pytest.approx(B * 1.0)


def test_aux_loss_uniform_router_is_one():
    """Zero router weights -> uniform probs; Switch aux = E * (1 * 1/E) = 1
    (all top-1 ties resolve to expert 0)."""
    B, S, D, E = 2, 16, 4, 4
    x = torch.from_numpy(np.random.RandomState(0).randn(B, S, D)
                         .astype(np.float32))
    dispatch, _, aux = moe_router(x, torch.zeros((D, E)), top_k=2,
                                  capacity=8)
    assert float(aux) == pytest.approx(1.0, abs=1e-5)
    # ties go to the lowest index: experts 0 and 1 take every token
    assert float(dispatch[:, :, 2:].sum()) == 0
    assert float(dispatch[:, :8, :2].sum()) == 2 * 8 * 2


def test_moe_grads_flow_to_all_experts():
    cfg = _moe_cfg(capacity_factor=2.0)
    params, _ = make_train_state(2, cfg, device=CPU)
    gpt_loss(params, {"tokens": torch.from_numpy(_tokens(seed=3))},
             cfg).backward()
    g_wi = params["layers"]["mlp"]["wi"].grad              # [L, E, D, M]
    per_expert = g_wi.abs().sum(dim=(0, 2, 3))
    assert (per_expert > 0).all(), per_expert


@pytest.mark.slow
def test_moe_training_learns():
    cfg = _moe_cfg()
    params, opt = make_train_state(4, cfg, learning_rate=1e-2,
                                   weight_decay=1e-4, device=CPU)
    step = make_train_step(cfg, opt)
    batch = {"tokens": torch.from_numpy(_tokens(seed=5))}
    losses = [float(step(params, batch)["loss"]) for _ in range(5)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("top_k,capacity", [(1, 16), (2, 10), (2, 3)])
def test_router_matches_jax(top_k, capacity):
    x, p = _mlp_inputs(seed=top_k + capacity)
    want = jmoe.moe_router(jnp.asarray(x), jnp.asarray(p["router"]),
                           top_k=top_k, capacity=capacity)
    got = moe_router(torch.from_numpy(x), torch.from_numpy(p["router"]),
                     top_k=top_k, capacity=capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6, rtol=0)
    assert abs(float(got[2]) - float(want[2])) <= 1e-6
    if capacity == 3:      # some tokens dropped
        assert float(got[0].sum()) < x.shape[0] * x.shape[1] * top_k


def test_moe_mlp_matches_jax():
    x, p = _mlp_inputs()
    want_y, want_aux = _jax_mlp(x, p)
    y, aux = moe_mlp(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in p.items()},
                     top_k=2, capacity_factor=1.25)
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5, rtol=0)
    assert abs(float(aux) - want_aux) <= 1e-6


@pytest.mark.parametrize("mode", ["gspmd", "ep"])
def test_moe_mlp_on_the_mesh_matches_jax(world8, mode):
    """GSPMD mode: x batch-split over dp, experts over ep, the constraint
    points redistributing; ep_axis mode: each ep rank runs its experts
    and all_gather reassembles them."""
    want_y, want_aux = _jax_mlp(*_mlp_inputs())
    np.testing.assert_allclose(world8[f"{mode}_y"], want_y, atol=1e-5,
                               rtol=0)
    assert abs(world8[f"{mode}_aux"] - want_aux) <= 1e-6


def _port_loss_and_grads(params, toks, cfg):
    for leaf in _flat(params).values():
        leaf.requires_grad_(True)
        leaf.grad = None
    loss = gpt_loss(params, {"tokens": torch.from_numpy(toks)}, cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy()
                                  for k, v in _flat(params).items()}


@pytest.mark.parametrize("ce_block", [0, 8])
def test_moe_gpt_loss_and_grads_match_jax(jparams, ce_block):
    jcfg, cfg = _configs(ce_block=ce_block, attention="dense")
    toks = _tokens(b=4)
    jl, jg = jax.value_and_grad(jgpt.gpt_loss)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    loss, grads = _port_loss_and_grads(
        params_from_jax(_tree(jparams), cfg, device=CPU), toks, cfg)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    want = _flat(_tree(jg))
    assert grads.keys() == want.keys()
    for name, g in want.items():
        assert np.abs(grads[name] - g).max() <= 1e-3 * np.abs(g).max(), name


def test_two_adamw_steps_match_jax(jparams):
    """bench.py's path at tiny width with experts: flash, remat "dots",
    blocked CE, optax.adamw(3e-4, b2=0.95)."""
    jcfg, cfg = _configs(attention="flash", remat_policy="dots", ce_block=8)
    tx = optax.adamw(3e-4, b2=0.95)
    jstep = jgpt.make_train_step(jcfg, tx, donate=False)
    jp, jstate = jparams, tx.init(jparams)
    params, opt = make_train_state(0, cfg, learning_rate=3e-4,
                                   weight_decay=1e-4, device=CPU)
    start = _flat(params_from_jax(_tree(jparams), cfg, device=CPU))
    with torch.no_grad():
        for name, leaf in _flat(params).items():
            leaf.copy_(start[name])
    step = make_train_step(cfg, opt)
    for seed in (1, 2):
        toks = _tokens(b=4, seed=seed)
        jp, jstate, jm = jstep(jp, jstate,
                               {"tokens": jnp.asarray(toks, jnp.int32)})
        m = step(params, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        want, got = _flat(_tree(jp)), _flat(params_to_numpy(params))
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-6, err_msg=name)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _op_counts(params, toks, cfg):
    with _CountOps() as c:
        _port_loss_and_grads(params, toks, cfg)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    return c.counts.get(mm, 0), c.counts.get(bmm, 0)


def test_remat_dots_recomputes_the_moe_einsums(jparams):
    """Every MoE einsum has a batch dim (b or e): under "dots" the
    reference recomputes them, and so does the port: its bmms re-run as
    under "full" (which saves nothing), while its mms (the projections'
    and the router's) are saved, as with no remat at all."""
    _, cfg = _configs(attention="dense", remat=False)
    params = params_from_jax(_tree(jparams), cfg, device=CPU)
    toks = _tokens(b=2)
    with torch.no_grad(), _CountOps() as fwd:
        gpt_loss(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert fwd.counts[torch.ops.aten.bmm.default] >= cfg.num_layers * 4
    none = _op_counts(params, toks, cfg)
    full, dots = (_op_counts(params, toks, dataclasses.replace(
        cfg, remat=True, remat_policy=policy)) for policy in ("full", "dots"))
    assert dots[0] == none[0] < full[0]          # mm: saved
    assert dots[1] == full[1] > none[1]          # bmm: recomputed

"""The port's pipeline (ray_tpu_torch/parallel/pipeline.py) against the
JAX package's losses and gradients.

Mirrors tests/test_pipeline.py case for case, on its configs, seeds and
meshes: GPT (vocab 128, 4 layers of 2 heads, width 32), params from the
JAX init (``params_from_jax``), tokens from numpy's RandomState.  The
reference holds its pipelined loss to the unpipelined ``gpt_loss``; so
does this file, taking ``gpt_loss`` and ``jax.grad(gpt_loss)`` from the
JAX package on the conftest's virtual devices (flash through the Pallas
kernel in interpret mode), at the reference's tolerances:
- GPipe over pp=2 x dp=4: loss 1e-5, grads rtol 2e-4 atol 2e-5;
- an odd microbatch count (M=3, pp=2 x dp=2): loss 1e-5;
- flash stages (the plain versions here): loss 1e-4;
- MoE stages over pp=2 x ep=2 x dp=2: loss (with its aux) 1e-4, the aux
  nonzero; one training step moves the experts;
- 1F1B: loss 1e-5, each grad leaf within 1e-4 of its max |grad|;
- ring stages over pp=2 x sp=2 x dp=2: the dense loss 1e-4, grads finite;
- 1F1B with the default bf16 compute dtype: loss and grads finite;
- ``slow``, as there: GPipe training learns; 1F1B trains and keeps under
  half of GPipe's activation memory at M=32 (``saved_activations``, the
  port's counter of the tensors kept for the backward, for the
  reference's compiled temp size).
Adds the pipelined forward's logits against ``gpt_forward`` (1e-5),
every rank holding the same whole gradient, 1F1B's MoE aux cotangent and
redundant-axis division against GPipe's grads, and the shape checks.

The torch side runs in gloo gangs (rank functions in ``_torch_gang.py``):
one of 8 ranks and one of 4, each computing its cases once for the
module (120 s deadline each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_gang as gang
from ray_tpu.models import gpt as jgpt

BASE = dict(vocab_size=128, max_seq_len=32, num_layers=4, num_heads=2,
            embed_dim=32)


def _jcfg(**kw):
    return jgpt.GPTConfig(**dict(BASE, dtype=jnp.float32, **kw))


def _tokens(rows, seed, cols=33):
    return np.random.RandomState(seed).randint(0, 128, (rows, cols))


def _case(key, cfg, rows, seed, cols=33):
    """(params as a tree of numpy arrays, tokens) of the reference's
    setup, and the JAX params themselves."""
    params = jgpt.gpt_init(jax.random.PRNGKey(key), cfg)
    return (jax.tree_util.tree_map(np.asarray, params),
            _tokens(rows, seed, cols)), params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _jax_loss(params, tokens, cfg):
    return float(jgpt.gpt_loss(params, {"tokens": jnp.asarray(
        tokens, jnp.int32)}, cfg))


CASES = {
    # test_pipeline.py's _setup: pp=2 x dp=4, 16 rows, M=4
    "setup": (1, _jcfg(), 16, 0, 33),
    "odd": (1, _jcfg(), 12, 0, 33),
    "flash": (2, _jcfg(attention="flash"), 8, 1, 33),
    "moe": (3, _jcfg(num_experts=4, expert_top_k=2), 8, 2, 33),
    "moe_train": (4, _jcfg(num_experts=4, expert_top_k=2), 8, 3, 33),
    "ring": (1, _jcfg(max_seq_len=64), 8, 0, 65),
    "bf16": (1, jgpt.GPTConfig(**BASE), 8, 0, 33),
}


@pytest.fixture(scope="module")
def cases():
    """name -> ((numpy params, tokens), JAX params, JAX config)."""
    out = {}
    for name, (key, cfg, rows, seed, cols) in CASES.items():
        case, params = _case(key, cfg, rows, seed, cols)
        out[name] = (case, params, cfg)
    return out


@pytest.fixture(scope="module")
def world8(cases):
    res = gang.run(gang.pipeline_world8, 8,
                   tuple(cases[n][0] for n in ("setup", "moe", "moe_train",
                                               "ring")), timeout_s=120)
    return res[0], res[1:]


@pytest.fixture(scope="module")
def world4(cases):
    return gang.run(gang.pipeline_world4, 4,
                    tuple(cases[n][0] for n in ("odd", "flash", "bf16")),
                    timeout_s=120)[0]


@pytest.fixture(scope="module")
def setup_ref(cases):
    (_, tokens), params, cfg = cases["setup"]
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    loss = float(jgpt.gpt_loss(params, batch, cfg))
    grads = _flat(jax.tree_util.tree_map(
        np.asarray, jax.grad(jgpt.gpt_loss)(params, batch, cfg)))
    return loss, grads


def test_forward_parity_pp2(world8, setup_ref):
    got, _ = world8[0]["gpipe"]
    assert abs(got - setup_ref[0]) < 1e-5


def test_grad_parity_pp2(world8, setup_ref):
    _, grads = world8[0]["gpipe"]
    want = setup_ref[1]
    assert grads.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(grads[name], want[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_every_rank_holds_the_whole_grad(world8):
    """Each rank's grads are its partials summed over the mesh: all eight
    ranks hold the same loss and the same grads (by their squared norms),
    for GPipe, 1F1B and the ring stages."""
    first, others = world8
    for key in ("gpipe", "1f1b", "ring"):
        loss, grads = first[key]
        norms = {n: float((g.astype(np.float64) ** 2).sum())
                 for n, g in grads.items()}
        for digest in others:
            assert digest[key][0] == loss, key
            for name, norm in norms.items():
                np.testing.assert_allclose(digest[key][1][name], norm,
                                           rtol=1e-6, err_msg=name)


def test_forward_pipelined_matches_gpt_forward(world8, cases):
    (_, tokens), params, cfg = cases["setup"]
    want = np.asarray(jgpt.gpt_forward(params, jnp.asarray(
        tokens[:, :-1], jnp.int32), cfg))
    logits, aux = world8[0]["forward"]
    np.testing.assert_allclose(logits, want, atol=1e-5, rtol=1e-5)
    assert aux == 0.0


def test_odd_microbatch_count(world4, cases):
    """M=3 against pp=2: fill and drain are asymmetric (T = M+pp-1 = 4)."""
    (_, tokens), params, cfg = cases["odd"]
    assert abs(world4["odd"] - _jax_loss(params, tokens, cfg)) < 1e-5


def test_pipeline_with_flash_attention(world4, cases):
    """Flash stages (the plain versions on the CPU) against the JAX loss
    through the Pallas kernel in interpret mode."""
    (_, tokens), params, cfg = cases["flash"]
    assert abs(world4["flash"] - _jax_loss(params, tokens, cfg)) < 1e-4


def test_pipeline_moe_ep_aux_preserved(world8, cases):
    """pp x ep: the experts split over ep inside the stages and the aux
    loss survives the schedule: the pipelined loss (with moe_aux_coef x
    aux) matches the reference loss, and the aux is not zero."""
    (_, tokens), params, cfg = cases["moe"]
    assert abs(world8[0]["moe"] - _jax_loss(params, tokens, cfg)) < 1e-4
    _, aux = jgpt.gpt_forward_with_aux(
        params, jnp.asarray(tokens[:, :-1], jnp.int32), cfg)
    assert float(aux) > 0.0


def test_pipeline_moe_ep_trains(world8):
    """One pp x ep training step runs end to end, the loss is finite and
    the expert weights moved."""
    loss, moved = world8[0]["moe_train"]
    assert np.isfinite(loss)
    assert max(moved.values()) > 0.0, moved


def test_1f1b_loss_and_grad_parity(world8, setup_ref):
    """The written-out 1F1B backward against autodiff, in f32."""
    loss, grads = world8[0]["1f1b"]
    assert abs(loss - setup_ref[0]) < 1e-5
    errs = {n: float(np.abs(g - grads[n]).max()
                     / (np.abs(g).max() + 1e-8))
            for n, g in setup_ref[1].items()}
    assert max(errs.values()) < 1e-4, errs


def test_1f1b_matches_gpipe_with_moe_aux_and_a_replicated_axis(world8):
    """1F1B's written-out aux cotangent (aux coefficient 0.5, MoE stages
    without ep) and its division of the partials by a redundant tp axis
    give GPipe's loss and grads (f32: 1e-6 relative, 1e-5 of each leaf's
    max)."""
    got = world8[0]["moe_1f1b"]
    (l0, g0), (l1, g1) = got["gpipe"], got["1f1b"]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for name, g in g0.items():
        assert np.abs(g1[name] - g).max() <= 1e-5 * np.abs(g).max(), name


def test_ring_attention_through_pipeline_stages(world8, cases):
    """sp through the stage bodies: ring attention inside a pp x sp x dp
    pipeline matches the dense unpipelined loss; grads are finite."""
    (_, tokens), params, cfg = cases["ring"]
    loss, grads = world8[0]["ring"]
    assert abs(loss - _jax_loss(params, tokens, cfg)) < 1e-4
    assert all(np.isfinite(g).all() for g in grads.values())


def test_1f1b_bf16_default_dtype_grads(world4):
    """The default GPTConfig computes in bf16: the x_mbs cotangent comes
    back in the input's dtype, and loss and grads are finite."""
    loss, finite = world4["bf16"]
    assert np.isfinite(loss)
    assert all(finite.values()), finite


def test_pipeline_shape_checks(world4):
    errors = world4["errors"]
    assert "num_layers 3 not divisible by pp=2" in errors["layers"]
    assert "batch 12 not divisible by microbatches 5" in errors["batch"]
    assert ("microbatch size 3 not divisible by data-axis size 2"
            in errors["data"])


@pytest.mark.slow
def test_pipeline_training_learns(cases):
    losses = gang.run(gang.pipeline_learns, 8,
                      (cases["setup"][0], 4, "gpipe", 5, 1e-2),
                      timeout_s=120)[0]
    assert losses[-1] < losses[0], losses


@pytest.mark.slow
def test_1f1b_trains_and_memory_win():
    """1F1B's activation memory is O(pp), not O(M): at M=32 under half
    of GPipe's, and 12 steps still reduce the loss."""
    case, _ = _case(1, _jcfg(), 64, 0)
    mem = gang.run(gang.pipeline_memory, 4, (case, 32), timeout_s=120)[0]
    assert mem["1f1b"] * 2 < mem["gpipe"], mem
    losses = gang.run(gang.pipeline_learns, 4, (case, 32, "1f1b", 12, 3e-3),
                      timeout_s=120)[0]
    assert losses[-1] < losses[0] - 0.15, losses

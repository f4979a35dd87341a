"""The port's GPT and LLaMA under real shardings, against the JAX package.

Mirrors tests/test_models.py (``test_gpt_param_axes_tree_matches``,
``test_gpt_train_step_loss_decreases`` on its four meshes,
``test_gpt_sharded_matches_single_device``,
``test_gpt_ring_attention_mode_trains``) and tests/test_llama.py
(``test_llama_train_step_loss_decreases`` on its two meshes,
``test_llama_sharded_matches_single_device``): sharded and single-device
losses within |dloss| < 1e-4 after two SGD steps from the JAX init, and
the single-device loss within the same of JAX's own ``make_train_step``.
Adds the flash op on a mesh (remat "dots", blocked head), the dryrun twin
of ``__graft_entry__.dryrun_multichip`` at n=8 (its stages main, moe,
multislice, pipeline and rl), and the autotune
dispatcher's ring variant against the dense reference at atol 2e-5
(mirrors tests/test_autotune.py:272).

The torch side runs in six gloo gangs of 8 ranks, one for each part of
``_torch_gang.MODEL_PARTS`` (GPT's two 1-d meshes and its two 3-d ones,
LLaMA's two, the single-device matches, the flash op, ring attention),
each under its own 120 s deadline (rank function ``models_world8``); the
dryrun runs its own four gangs under its own deadline, then its rl stage
in the test's process (PPO's learner over 8 CPU shards).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_gang as gang
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.ops.flash_attention import _dense_reference
from ray_tpu_torch.dryrun import dryrun_multichip
from ray_tpu_torch.models import GPTConfig, LlamaConfig, gpt_init, llama_init
from ray_tpu_torch.models.gpt import gpt_param_axes
from ray_tpu_torch.models.llama import llama_param_axes

TINY = dict(vocab_size=128, max_seq_len=32, num_layers=2)
JGPT = jgpt.GPTConfig(num_heads=2, embed_dim=16, dtype=jnp.float32, **TINY)
JLLAMA = jllama.LlamaConfig(num_heads=4, num_kv_heads=2, embed_dim=16,
                            mlp_dim=48, dtype=jnp.float32, **TINY)


def _tokens(B, seed):
    return np.random.default_rng(seed).integers(0, 128, (B, 33),
                                                dtype=np.int64)


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


BATCH8, BATCH8_7, BATCH4 = _tokens(8, 0), _tokens(8, 7), _tokens(4, 1)
RING_QKV = tuple(np.random.default_rng(2).standard_normal((2, 32, 2, 8))
                 .astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def jax_params():
    return (jgpt.gpt_init(jax.random.PRNGKey(0), JGPT),
            jllama.llama_init(jax.random.PRNGKey(0), JLLAMA))


def _world8(part):
    """A module fixture: ``part``'s results from its own gang (pytest keeps
    a gang's failure for the part's other cases, so it runs once)."""
    @pytest.fixture(scope="module")
    def results(jax_params):
        gp, lp = jax_params
        return gang.run(gang.models_world8, 8,
                        (part, _tree(gp), _tree(lp), BATCH8, BATCH8_7,
                         BATCH4, RING_QKV), timeout_s=120)[0]
    return results


gpt8_1d = _world8("gpt_decreases_1d")
gpt8_3d = _world8("gpt_decreases_3d")
llama8 = _world8("llama_decreases")
match8 = _world8("match")
flash8 = _world8("flash")
ring8 = _world8("ring")


def _structure(tree):
    return jax.tree_util.tree_structure(
        tree, is_leaf=lambda x: not isinstance(x, dict))


@pytest.mark.parametrize("experts", [0, 4])
def test_gpt_param_axes_tree_matches(experts):
    import torch
    cfg = GPTConfig(num_heads=2, embed_dim=16, dtype=torch.float32,
                    num_experts=experts, **TINY)
    jcfg = jgpt.GPTConfig(num_heads=2, embed_dim=16, dtype=jnp.float32,
                          num_experts=experts, **TINY)
    params = {k: v for k, v in gpt_init(0, cfg, device="cpu").items()}
    axes = gpt_param_axes(cfg)
    assert _structure(params) == _structure(axes)
    assert axes == jgpt.gpt_param_axes(jcfg)        # the same annotations
    lcfg = LlamaConfig(num_heads=4, num_kv_heads=2, embed_dim=16,
                       mlp_dim=48, dtype=torch.float32, **TINY)
    assert _structure(llama_init(0, lcfg, device="cpu")) == _structure(
        llama_param_axes(lcfg))
    assert llama_param_axes(lcfg) == jllama.llama_param_axes(JLLAMA)


@pytest.mark.parametrize("spec", ["dp8", "fsdp8", "dp2_fsdp2_tp2",
                                  "fsdp2_sp2_tp2"])
def test_gpt_train_step_loss_decreases(request, spec):
    part = "gpt8_1d" if spec in ("dp8", "fsdp8") else "gpt8_3d"
    losses = request.getfixturevalue(part)["gpt_decreases"][spec]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]


def _jax_two_sgd_steps(make_step, cfg, params):
    tx = optax.sgd(1e-2)
    step = make_step(cfg, tx, None, donate=False)
    state = tx.init(params)
    batch = {"tokens": jnp.asarray(BATCH8_7, jnp.int32)}
    for _ in range(2):
        params, state, m = step(params, state, batch)
    return float(m["loss"])


def test_gpt_sharded_matches_single_device(match8, jax_params):
    """Same weights, same batch: dp=8 and tp=2 x fsdp=4 == one device."""
    got = match8["gpt_match"]
    assert abs(got["single"] - got["dp8"]) < 1e-4
    assert abs(got["single"] - got["tp2_fsdp4"]) < 1e-4
    want = _jax_two_sgd_steps(jgpt.make_train_step, JGPT, jax_params[0])
    assert abs(got["single"] - want) < 1e-4


def test_gpt_ring_attention_mode_trains(ring8):
    losses = ring8["ring_trains"]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("spec", ["dp8", "dp2_fsdp2_tp2"])
def test_llama_train_step_loss_decreases(llama8, spec):
    losses = llama8["llama_decreases"][spec]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]


def test_llama_sharded_matches_single_device(match8, jax_params):
    got = match8["llama_match"]
    assert abs(got["single"] - got["dp8"]) < 1e-4
    assert abs(got["single"] - got["tp2_fsdp4"]) < 1e-4
    want = _jax_two_sgd_steps(jllama.make_train_step, JLLAMA, jax_params[1])
    assert abs(got["single"] - want) < 1e-4


def test_flash_on_a_mesh_matches_single_device(flash8, match8):
    """The flash op runs per rank on its batch and heads (no DTensor rule
    needed), under remat "dots" and the blocked head."""
    got = flash8["flash_match"]
    assert abs(got["single"] - got["dp2_fsdp2_tp2"]) < 1e-4
    # flash equals dense on one device, so this is the GPT match's loss
    assert abs(got["single"] - match8["gpt_match"]["single"]) < 1e-4


def test_dispatched_ring_variant_matches_dense_reference(ring8):
    want = np.asarray(_dense_reference(*map(jnp.asarray, RING_QKV), True,
                                       None))
    ring = ring8
    np.testing.assert_allclose(ring["dispatch_ring"], want, atol=2e-5)
    assert ring["ring_applicable"][-1] == "ring"
    assert ring["ring_tuned"] == ["dense", "ring"]


def test_dryrun_multichip_twin(capsys):
    with gang.one_gang_at_a_time():
        lines = dryrun_multichip(8, "cpu")
    assert set(lines) == {"main", "moe", "multislice", "pipeline", "rl"}
    for name, text in lines.items():
        for line in text.splitlines():
            loss = float(re.search(r"loss=(-?[0-9.]+)", line).group(1))
            assert math.isfinite(loss), line
    assert "'sp': 2" in lines["main"] and "'tp': 2" in lines["main"]
    # the pipeline stage: its four loss lines, each matching the
    # unpipelined loss (the stage raises otherwise), 1F1B's with both
    # schedules' activation memory
    pipe = lines["pipeline"].splitlines()
    assert [line.split("]")[0].split("[")[1] for line in pipe] == [
        "dense pp x dp", "flash pp x dp", "moe pp x ep", "1f1b pp x dp"]
    assert all("matches reference" in line for line in pipe)
    assert "M=16" in pipe[-1] and "activation memory" in pipe[-1]
    assert "PPO learner dp=8" in lines["rl"]
    out = capsys.readouterr().out
    assert "[rl] rl dryrun: PPO learner dp=8 loss=" in out
    assert "not run" not in out

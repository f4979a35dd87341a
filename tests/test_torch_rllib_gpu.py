"""RLlib on the card.

* A ``PPOPolicy`` on the card and one on the CPU, from the same weights
  and the same batch, agree on the first minibatch's loss within 1e-5
  relative and on each grad leaf within 1e-4 of the leaf's max |g|; the
  same for one ``ImpalaPolicy`` update.
* DQN's, SAC's and QMIX's first update on the card matches the same
  update on the CPU from the same weights, batch and noise: the loss
  within 1e-5 relative (SAC's actor loss, alpha and entropy, means of
  terms of size ~1, within 1e-5 of max(|x|, 1)) and each grad leaf
  within 1e-4 of the leaf's max |g|, with TF32 off.
* ``num_learner_devices`` above the card count raises ``ValueError``.
* chip_smoke.py's runtime_rllib step: PPO, IMPALA, Ape-X DQN, SAC and
  QMIX with the learner on the card and card-less rollout workers and
  replay shards (see chip_smoke.py).

The tests need a CUDA card and skip without one.  This module imports
nothing of JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_rllib_gpu.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (DQNPolicy, ImpalaPolicy, PPOPolicy,
                                 QMIXConfig, SACPolicy, SampleBatch)
from ray_tpu_torch.rllib.env import Space
from ray_tpu_torch.rllib.policy import tree_leaves

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_rllib_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False


def _agree(card_out, cpu_out):
    (sc, gc), (sp, gp) = card_out, cpu_out
    assert abs(sc["total_loss"] - sp["total_loss"]) <= \
        LOSS_RTOL * abs(sp["total_loss"]), (sc, sp)
    for a, b in zip(tree_leaves(gc), tree_leaves(gp)):
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(b).max()


def _pair(cls, cfg):
    card = cls(4, Space("discrete", n=2), dict(cfg), seed=3)
    cpu = cls(4, Space("discrete", n=2), dict(cfg, device="cpu"), seed=3)
    cpu.set_weights(card.get_weights())
    assert card.device.type == "cuda"
    return card, cpu


def test_ppo_first_minibatch_matches_the_cpu():
    rng = np.random.default_rng(0)
    n = 1024
    batch = SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "action_logp": np.full(n, -0.69, np.float32),
        "vf_preds": rng.normal(size=n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32)})
    card, cpu = _pair(PPOPolicy, {"sgd_minibatch_size": 256,
                                  "num_sgd_iter": 6})
    _agree(card.first_minibatch(batch), cpu.first_minibatch(batch))
    assert np.isfinite(card.learn_on_batch(batch)["total_loss"])


def test_impala_update_matches_the_cpu():
    rng = np.random.default_rng(1)
    B, T = 4, 16
    batch = SampleBatch({
        "obs": rng.normal(size=(B, T, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (B, T)).astype(np.int32),
        "action_logp": np.full((B, T), -0.69, np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "dones": rng.random((B, T)) < 0.1,
        "bootstrap_obs": rng.normal(size=(B, 4)).astype(np.float32)})
    card, cpu = _pair(ImpalaPolicy, {})
    _agree(card.loss_and_grads(batch), cpu.loss_and_grads(batch))


def _grads_agree(gc, gp):
    for a, b in zip(tree_leaves(gc), tree_leaves(gp)):
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(b).max()


def test_dqn_update_matches_the_cpu():
    rng = np.random.default_rng(2)
    n = 64
    batch = SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.1,
        "weights": rng.random(n).astype(np.float32)})
    card, cpu = _pair(DQNPolicy, {})
    (lc, gc), (lp, gp) = card.loss_and_grads(batch), cpu.loss_and_grads(batch)
    assert abs(lc - lp) <= LOSS_RTOL * abs(lp), (lc, lp)
    _grads_agree(gc, gp)
    assert np.isfinite(card.learn_on_batch(batch)["td_errors"]).all()


def test_sac_update_matches_the_cpu():
    rng = np.random.default_rng(3)
    n = 256
    batch = SampleBatch({
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.1})
    box = Space("box", shape=(1,), low=-2.0, high=2.0)
    card = SACPolicy(3, box, {}, seed=3)
    cpu = SACPolicy(3, box, {"device": "cpu"}, seed=3)
    cpu.set_weights(card.get_weights())
    noise = cpu.draw_noise(n)
    (sc, gc), (sp, gp) = (card.learn_with_grads(batch, noise),
                          cpu.learn_with_grads(batch, noise))
    for k in sp:
        ref = abs(sp[k]) if k == "critic_loss" else max(abs(sp[k]), 1.0)
        assert abs(sc[k] - sp[k]) <= LOSS_RTOL * ref, (k, sc, sp)
    _grads_agree(gc, gp)


def test_qmix_update_matches_the_cpu():
    cfg = (QMIXConfig().environment("TwoStepGame-v0")
           .training(learning_starts=16, train_batch_size=32)
           .debugging(seed=0))
    card = cfg.build()
    cpu = cfg.resources(device="cpu").build()
    assert card.device.type == "cuda"
    cpu.load_checkpoint(card.save_checkpoint())
    for _ in range(3):
        cpu._run_episode()
    batch = cpu._buffer.sample(32)
    card.t_q, card.t_m = card.q_params, card.m_params
    (lc, gc), (lp, gp) = (card.loss_and_grads(card.device_batch(batch)),
                          cpu.loss_and_grads(cpu.device_batch(batch)))
    assert abs(lc - lp) <= LOSS_RTOL * abs(lp), (lc, lp)
    _grads_agree(gc, gp)


def test_learner_devices_above_the_card_count_raise():
    with pytest.raises(ValueError, match="num_learner_devices"):
        PPOPolicy(4, Space("discrete", n=2), {
            "num_learner_devices": torch.cuda.device_count() + 1})


def test_runtime_rllib_step():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)       # chip_smoke.py; workers inherit it
    import chip_smoke
    ray_tpu_torch.init(num_cpus=4)
    try:
        out = chip_smoke.runtime_rllib(torch.device("cuda", 0))
    finally:
        ray_tpu_torch.shutdown()
    assert out["ppo"]["reward_last"] > out["ppo"]["reward_first"] + 10
    assert out["impala"]["batch_device"] == ["cuda:0"]
    assert out["apex"]["num_updates"][-1] == 160
    assert out["qmix"]["updates"] == 28

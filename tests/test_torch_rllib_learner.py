"""Multi-device (dp) RL learner tests, the port's mirror of
tests/test_rllib_learner.py.

Reference shape: ``rllib/execution/multi_gpu_learner_thread.py`` /
``rl_trainer/trainer_runner.py`` distribute the learner over N GPUs with
allreduced grads; here the learner is one process over n shards
(ray_tpu_torch/rllib/learner.py: n virtual shards on the CPU, as the
reference's tests use 8 virtual CPU devices) and the property under test
is exact parity with the single-device update plus end-to-end learning.
"""

import numpy as np
import pytest

from ray_tpu_torch.rllib import PPOConfig, PPOPolicy
from ray_tpu_torch.rllib.env import Space
from ray_tpu_torch.rllib.policy import tree_leaves
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _ppo_batch(n, rng):
    return SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "action_logp": np.full(n, -0.69, np.float32),
        "vf_preds": np.zeros(n, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    })


def test_ppo_dp_learner_matches_single_device():
    """With one full-batch SGD step (no shard-local shuffling in play),
    the mean of the shards' grads must equal the global-mean gradient:
    params after learn_on_batch agree across dp=1 and dp=4 to float
    tolerance."""
    cfg = {"lr": 1e-3, "num_sgd_iter": 1, "sgd_minibatch_size": 1 << 16,
           "device": "cpu"}
    batch = _ppo_batch(64, np.random.default_rng(1))
    pol1 = PPOPolicy(4, Space("discrete", n=2), dict(cfg), seed=0)
    pol4 = PPOPolicy(4, Space("discrete", n=2),
                     {**cfg, "num_learner_devices": 4}, seed=0)
    s1 = pol1.learn_on_batch(batch)
    s4 = pol4.learn_on_batch(batch)
    assert np.isfinite(s4["total_loss"])
    np.testing.assert_allclose(s1["total_loss"], s4["total_loss"],
                               rtol=1e-5)
    for a, b in zip(tree_leaves(pol1.get_weights()),
                    tree_leaves(pol4.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_ppo_dp_learner_trims_ragged_batch():
    """69 rows over 4 shards: trailing rows drop, update still runs."""
    pol = PPOPolicy(4, Space("discrete", n=2),
                    {"num_learner_devices": 4, "num_sgd_iter": 2,
                     "sgd_minibatch_size": 8, "device": "cpu"}, seed=0)
    stats = pol.learn_on_batch(_ppo_batch(69, np.random.default_rng(2)))
    assert np.isfinite(stats["total_loss"])


def test_impala_dp_learner_matches_single_device():
    """IMPALA's V-trace update is deterministic — dp=4 must reproduce the
    dp=1 params exactly (mean loss = mean of equal-shard means)."""
    from ray_tpu_torch.rllib.impala import ImpalaPolicy, _to_device
    rng = np.random.default_rng(3)
    B, T = 8, 16
    batch = SampleBatch({
        "obs": rng.normal(size=(B, T, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (B, T)),
        "action_logp": np.full((B, T), -0.69, np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "dones": np.zeros((B, T), bool),
        "bootstrap_obs": rng.normal(size=(B, 4)).astype(np.float32),
    })
    cfg = {"lr": 1e-3, "device": "cpu"}
    pol1 = ImpalaPolicy(4, Space("discrete", n=2), dict(cfg), seed=0)
    pol4 = ImpalaPolicy(4, Space("discrete", n=2),
                        {**cfg, "num_learner_devices": 4}, seed=0)
    s1 = pol1.learn_on_batch(_to_device(batch, "cpu"))
    s4 = pol4.learn_on_batch(_to_device(batch, "cpu"))
    np.testing.assert_allclose(s1["total_loss"], s4["total_loss"],
                               rtol=1e-5)
    for a, b in zip(tree_leaves(pol1.get_weights()),
                    tree_leaves(pol4.get_weights())):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_ppo_dp_learner_learns_cartpole():
    """End-to-end: PPO with the learner over 4 CPU shards clears the
    CartPole learning bar (same bar as the single-device test)."""
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=128)
            .training(lr=5e-4, num_sgd_iter=6, sgd_minibatch_size=128,
                      entropy_coeff=0.005)
            .resources(num_learner_devices=4, device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for _ in range(150):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 195:
            break
    algo.stop()
    assert best >= 195, f"dp-learner PPO failed CartPole: best={best}"

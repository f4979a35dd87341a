"""Replay buffers, DQN, SAC and IMPALA (async learner + V-trace), the
port's mirror of tests/test_rllib_dqn_impala.py.

Reference shape: rllib/utils/replay_buffers tests + per-algorithm
learning tests (reward thresholds on CartPole and Pendulum,
slow-marked).  The JAX package runs its DQN and SAC learning cases in a
hermetic CPU subprocess; here they run in the test's process.  The
learner runs on the CPU (``device="cpu"``); the rollout workers are
card-less actors.  This module imports no JAX:
the cluster's workers import it.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (DQNConfig, ImpalaConfig,
                                 PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _batch(n, base=0):
    return SampleBatch({"obs": np.arange(base, base + n, dtype=np.float32),
                        "rewards": np.ones(n, np.float32)})


def test_replay_buffer_ring_semantics():
    buf = ReplayBuffer(capacity=8, seed=0)
    buf.add(_batch(6))
    assert len(buf) == 6
    buf.add(_batch(6, base=100))   # wraps: capacity 8
    assert len(buf) == 8
    s = buf.sample(32)
    assert s["obs"].shape == (32,)
    # Old rows 0..3 were overwritten by the wrap.
    assert set(np.unique(s["obs"])) <= {4., 5., 100., 101., 102.,
                                        103., 104., 105.}


def test_prioritized_buffer_prefers_high_priority():
    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, seed=0)
    idx = buf.add(_batch(64))
    prios = np.full(64, 1e-6)
    prios[7] = 1000.0
    buf.update_priorities(idx, prios)
    s = buf.sample(256, beta=0.4)
    frac = float((s["obs"] == 7.0).mean())
    assert frac > 0.9, f"high-priority row sampled only {frac:.0%}"
    assert "weights" in s and s["weights"].max() == pytest.approx(1.0)


def test_dqn_smoke_trains_and_checkpoints():
    algo = (DQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4)
            .training(learning_starts=64, train_batch_size=32,
                      num_train_iters=2, rollout_fragment_length=8)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        for _ in range(4):
            result = algo.step()
        assert result["buffer_size"] > 0
        assert 0.0 < result["epsilon"] <= 1.0
        ckpt = algo.save_checkpoint()
        algo.load_checkpoint(ckpt)
    finally:
        algo.cleanup()


def test_impala_vtrace_matches_mc_on_policy():
    """With target==behavior policy (rho=c=1) and no terminations, V-trace
    targets equal the n-step discounted return to the bootstrap value."""
    from ray_tpu_torch.rllib.impala import vtrace
    B, T, gamma = 2, 5, 0.9
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(B, T)).astype(np.float32)
    values = rng.normal(size=(B, T)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    logp = np.zeros((B, T), np.float32)
    vs, _ = vtrace(torch.as_tensor(logp), torch.as_tensor(logp),
                   torch.as_tensor(rewards), torch.zeros((B, T)),
                   torch.as_tensor(values), torch.as_tensor(boot), gamma)
    # On-policy, undone: vs_t = sum_k gamma^k r_{t+k} + gamma^(T-t) * boot.
    expect = np.zeros((B, T))
    acc = boot.copy()
    for t in reversed(range(T)):
        acc = rewards[:, t] + gamma * acc
        expect[:, t] = acc
    np.testing.assert_allclose(vs.numpy(), expect, rtol=1e-4, atol=1e-4)


def test_impala_smoke_async_learner(ray_start):
    algo = (ImpalaConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .training(num_batches_per_step=2)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        r1 = algo.step()
        r2 = algo.step()
        assert r2["num_updates"] > r1["num_updates"] >= 2
        assert "learner_total_loss" in r2
    finally:
        algo.cleanup()


@pytest.mark.slow
def test_dqn_learns_cartpole():
    """DQN must reach >= 150 mean episode reward on CartPole (reference
    learning-test pattern)."""
    algo = (DQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=4)
            .training(learning_starts=500, train_batch_size=64,
                      num_train_iters=8, target_network_update_freq=250,
                      epsilon_timesteps=5000, lr=1e-3)
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for i in range(1500):
        r = algo.step()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 150:
            break
    algo.cleanup()
    assert best >= 150, f"best={best}"


@pytest.mark.slow
def test_impala_learns_cartpole():
    """IMPALA with async remote actors improves substantially on CartPole
    (V-trace correcting the stale-policy drift)."""
    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = (ImpalaConfig().environment("CartPole-v1")
                .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                          rollout_fragment_length=32)
                .training(num_batches_per_step=4, lr=6e-4)
                .resources(device="cpu")
                .debugging(seed=0).build())
        best = 0.0
        for i in range(600):
            r = algo.step()
            best = max(best, r.get("episode_reward_mean", 0.0))
            if best >= 140:
                break
        algo.cleanup()
    finally:
        ray_tpu_torch.shutdown()
    assert best >= 140, f"best={best}"


def test_sac_smoke_trains_and_checkpoints():
    from ray_tpu_torch.rllib import SACConfig
    algo = (SACConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4)
            .training(learning_starts=64, train_batch_size=32,
                      num_train_iters=2, rollout_fragment_length=8)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        for _ in range(4):
            r = algo.step()
        assert "critic_loss" in r
        ckpt = algo.save_checkpoint()
        algo.load_checkpoint(ckpt)
    finally:
        algo.cleanup()


@pytest.mark.slow
def test_sac_learns_pendulum():
    """SAC must reach >= -500 mean episode reward on Pendulum (random play
    is ~-1200; reference learning-test pattern for continuous control)."""
    from ray_tpu_torch.rllib import SACConfig
    algo = (SACConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=8)
            .training(learning_starts=1000, train_batch_size=256,
                      num_train_iters=8)
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = -1e9
    for i in range(1200):
        r = algo.step()
        rm = r.get("episode_reward_mean")
        if rm is not None:
            best = max(best, rm)
        if best >= -500:
            break
    algo.cleanup()
    assert best >= -500, f"best={best}"

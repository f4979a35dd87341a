"""IMPALA (async learner + V-trace), the port's mirror of the IMPALA cases
of tests/test_rllib_dqn_impala.py (its replay-buffer, DQN and SAC cases
wait for RLlib part 2).

Reference shape: per-algorithm learning tests (reward thresholds on
CartPole, slow-marked).  The learner runs on the CPU (``device="cpu"``);
the rollout workers are card-less actors.  This module imports no JAX:
the cluster's workers import it.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import ImpalaConfig


@pytest.fixture(scope="module")
def ray_start():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


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

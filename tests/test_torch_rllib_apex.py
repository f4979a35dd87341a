"""Ape-X DQN: distributed prioritized replay, the port's mirror of
tests/test_rllib_apex.py (reference: rllib/algorithms/apex_dqn/
apex_dqn.py).  The learner runs on the CPU (``device="cpu"``); the
rollout workers and the replay shards are card-less actors.  This module
imports no JAX: the cluster's workers import it.
"""

import pytest

import ray_tpu_torch
from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch.rllib.apex_dqn import ApexDQNConfig


@pytest.mark.slow
def test_apex_dqn_learns_cartpole(ray_start):  # noqa: F811
    """3 rollout workers on the Ape-X epsilon ladder feeding 2 replay
    shard actors; the async learner clears the CartPole bar."""
    algo = (ApexDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=3, num_envs_per_worker=4,
                      rollout_fragment_length=4)
            .training(lr=1e-3, learning_starts=500, num_train_iters=16,
                      target_network_update_freq=60, broadcast_interval=2)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        # epsilon ladder: worker 0 explores broadly, the last near-greedy
        eps = algo._worker_eps
        assert len(eps) == 3
        assert eps[0] == pytest.approx(0.4)
        assert eps[-1] < 0.01
        assert all(a > b for a, b in zip(eps, eps[1:]))

        best = 0.0
        for _ in range(600):
            r = algo.train()
            best = max(best, r.get("episode_reward_mean", 0.0))
            if best >= 150.0:
                break
        assert best >= 150.0, f"ApexDQN best={best}"
        # replay shards hold experience and priorities were updated
        sizes = ray_tpu_torch.get([s.size.remote()
                                   for s in algo.replay_shards], timeout=60)
        assert all(s > 0 for s in sizes)
    finally:
        algo.stop()

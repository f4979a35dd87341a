"""MinAtar-class pixel-env mechanics + PPO and DQN learning bars, the
port's mirror of tests/test_rllib_pixel.py.

Reference shape: rllib's Atari learning tests (tuned_examples/ppo/) assert
reward thresholds on pixel observations; these do the same on the
in-tree 10x10 multi-channel games (rllib/pixel_env.py), with the JAX
package's bars (random play scores 0.19 on breakout, 0.0 on freeway).
"""

import numpy as np
import pytest

from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.env import make_vector_env


def test_breakout_mini_mechanics():
    env = make_vector_env("BreakoutMini-v0", 8, seed=0)
    obs = env.vector_reset(seed=0)
    assert obs.shape == (8, 10, 10, 4)
    assert env.action_space.n == 3
    rng = np.random.default_rng(0)
    total, dones = np.zeros(8), 0
    for _ in range(300):
        obs, r, d, info = env.vector_step(rng.integers(0, 3, 8))
        assert obs.shape == (8, 10, 10, 4)
        assert float(obs.max()) <= 1.0 and float(obs.min()) >= 0.0
        assert info["terminal_obs"].shape == obs.shape
        total += r
        dones += int(d.sum())
    assert dones > 0, "random play must lose the ball"
    assert total.sum() > 0, "random play should hit at least one brick"
    # each channel plane stays binary and the paddle is width 2
    assert set(np.unique(obs)) <= {0.0, 1.0}
    assert int(obs[..., 0].sum()) == 2 * 8


def test_freeway_mini_mechanics():
    env = make_vector_env("FreewayMini-v0", 4, seed=1)
    obs = env.vector_reset(seed=1)
    assert obs.shape == (4, 10, 10, 3)
    # always-up scores at least once in an episode (cars permitting)
    total = np.zeros(4)
    for _ in range(250):
        obs, r, d, _ = env.vector_step(np.ones(4, np.int64))
        total += r
    assert (total > 0).any()
    # fixed-length episodes: all done exactly at max_episode_steps
    assert d.all()


@pytest.mark.slow
def test_ppo_learns_breakout_mini_from_pixels():
    algo = (PPOConfig().environment("BreakoutMini-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=64,
                      rollout_fragment_length=64)
            .training(lr=7e-4, num_sgd_iter=4, sgd_minibatch_size=512,
                      entropy_coeff=0.005, hiddens=(256, 128))
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for _ in range(300):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 2.0:
            break
    algo.stop()
    assert best >= 2.0, f"PPO pixels best={best} (random ~0.19)"


@pytest.mark.slow
def test_dqn_learns_breakout_mini_from_pixels():
    from ray_tpu_torch.rllib.dqn import DQNConfig
    algo = (DQNConfig().environment("BreakoutMini-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=8)
            .training(lr=3e-4, hiddens=(256, 128), train_batch_size=128,
                      num_train_iters=16, epsilon_timesteps=60_000,
                      target_network_update_freq=1000,
                      buffer_size=100_000)
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for _ in range(400):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 1.2:
            break
    algo.stop()
    assert best >= 1.2, f"DQN pixels best={best} (random ~0.19)"


@pytest.mark.slow
def test_ppo_learns_freeway_mini_from_pixels():
    algo = (PPOConfig().environment("FreewayMini-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=32,
                      rollout_fragment_length=128)
            .training(lr=7e-4, num_sgd_iter=4, sgd_minibatch_size=512,
                      entropy_coeff=0.01, hiddens=(256, 128))
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for _ in range(100):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 10.0:
            break
    algo.stop()
    assert best >= 10.0, f"PPO freeway best={best} (random scores 0)"

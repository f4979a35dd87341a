"""Exploration modules: parameter noise + RND curiosity, the port's mirror
of tests/test_rllib_exploration.py (reference:
rllib/utils/exploration/parameter_noise.py, random_encoder/curiosity).
Everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.dqn import DQNConfig
from ray_tpu_torch.rllib.exploration import ParameterNoise, RNDCuriosity
from ray_tpu_torch.rllib.policy import tree_leaves


def test_parameter_noise_sigma_adapts_both_ways():
    pn = ParameterNoise(seed=0, initial_sigma=0.1, target_divergence=0.2)
    s0 = pn.sigma
    pn.adapt_sigma(np.zeros(10), np.zeros(10))        # no divergence
    assert pn.sigma > s0                               # explore harder
    s1 = pn.sigma
    pn.adapt_sigma(np.zeros(10), np.ones(10))          # total divergence
    assert pn.sigma < s1                               # back off
    # perturbation actually changes the params
    params = {"w": torch.ones((4, 3)), "b": torch.zeros((3,))}
    noisy = pn.perturb(params)
    assert not np.allclose(noisy["w"].numpy(), 1.0)
    assert sorted(noisy) == sorted(params)
    assert [t.shape for t in tree_leaves(noisy)] == [
        t.shape for t in tree_leaves(params)]


def test_rnd_novelty_falls_with_training_and_flags_new_states():
    rnd = RNDCuriosity(obs_dim=8, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    seen = rng.normal(size=(256, 8)).astype(np.float32)
    for _ in range(200):
        rnd.train(seen)
    novel = 10.0 + rng.normal(size=(256, 8)).astype(np.float32)
    err_seen = float(np.mean(rnd.intrinsic(seen)))
    err_novel = float(np.mean(rnd.intrinsic(novel)))
    assert err_novel > 3 * err_seen, (err_seen, err_novel)


def _chain_run(extra, iters=300, seed=0):
    algo = (DQNConfig()
            .environment("SparseChain-v0",
                         env_config={"length": 20,
                                     "max_episode_steps": 40})
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=8)
            .training(lr=1e-3, learning_starts=300, train_batch_size=64,
                      num_train_iters=8, target_network_update_freq=300,
                      epsilon_timesteps=2000, **extra)
            .resources(device="cpu")
            .debugging(seed=seed).build())
    best = 0.0
    for _ in range(iters):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
    algo.stop()
    return best


@pytest.mark.slow
def test_rnd_curiosity_beats_epsilon_on_sparse_chain():
    """Length-20 chain, reward only at the end plus a distractor at the
    start: epsilon-greedy gets trapped (measured 0.40 in the JAX package);
    the RND novelty bonus drives the agent to the goal (0.93 there)."""
    plain = _chain_run({})
    rnd = _chain_run({"rnd_coeff": 2.0})
    assert rnd >= 0.75, f"RND best={rnd}"
    assert plain <= 0.55, f"epsilon best={plain} (chain too easy?)"
    assert rnd > plain


@pytest.mark.slow
def test_parameter_noise_learns_cartpole():
    """Parameter-space exploration replaces epsilon entirely and still
    clears a CartPole bar (temporally consistent exploration)."""
    algo = (DQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=4)
            .training(learning_starts=500, train_batch_size=64,
                      num_train_iters=8, target_network_update_freq=250,
                      lr=1e-3, exploration="parameter_noise")
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for _ in range(900):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 140.0:
            break
    algo.stop()
    assert best >= 140.0, f"param-noise best={best}"

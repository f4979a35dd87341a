"""A2C, TD3, DDPG, MARWIL, ES and APPO algorithm tests, the port's mirror
of tests/test_rllib_new_algos.py.

Reference shape: rllib learning tests (rllib/BUILD py_test targets per
algorithm asserting reward thresholds on CartPole and Pendulum) for
``rllib/algorithms/{a2c,td3,ddpg,marwil,es,appo}``.  The JAX package runs its
learning cases in a hermetic CPU subprocess; here they run in the test's
process on the CPU (``device="cpu"``), the APPO one on its own cluster.
This module imports no JAX: the cluster's workers import it.
"""

import numpy as np
import pytest

from _torch_runtime import ray_start  # noqa: F401


# -- fast shape/contract tests --------------------------------------------

def test_td3_policy_update_and_delay():
    from ray_tpu_torch.rllib.env import make_vector_env
    from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS,
                                                  OBS, REWARDS, SampleBatch)
    from ray_tpu_torch.rllib.td3 import TD3Policy
    env = make_vector_env("Pendulum-v1", 2, seed=0)
    obs_dim = int(np.prod(env.observation_space.shape))
    pol = TD3Policy(obs_dim, env.action_space,
                    {"hiddens": (16, 16), "policy_delay": 2,
                     "device": "cpu"}, seed=0)
    obs = env.vector_reset(seed=0)
    out = pol.compute_actions(np.asarray(obs, np.float32))
    assert out[ACTIONS].shape == (2, 1)
    assert (np.abs(out[ACTIONS]) <= pol.act_scale + 1e-6).all()
    rng = np.random.default_rng(0)
    batch = SampleBatch({
        OBS: rng.standard_normal((32, obs_dim)).astype(np.float32),
        NEXT_OBS: rng.standard_normal((32, obs_dim)).astype(np.float32),
        ACTIONS: rng.uniform(-2, 2, (32, 1)).astype(np.float32),
        REWARDS: rng.standard_normal(32).astype(np.float32),
        DONES: np.zeros(32, bool),
    })
    w0 = pol.get_weights()
    s1 = pol.learn_on_batch(batch)       # step 0: actor updates (0 % 2 == 0)
    assert s1["actor_loss"] != 0.0
    s2 = pol.learn_on_batch(batch)       # step 1: actor delayed
    assert s2["actor_loss"] == 0.0
    w1 = pol.get_weights()
    assert not np.allclose(w0["q1"][0]["w"], w1["q1"][0]["w"])


def test_es_centered_ranks_and_mlp_shapes():
    from ray_tpu_torch.rllib.es import (_centered_ranks, _mlp_shapes,
                                        _policy_act, _unflatten)
    r = _centered_ranks(np.array([3.0, 1.0, 2.0]))
    assert r.max() == 0.5 and r.min() == -0.5 and r[2] == 0.0
    shapes = _mlp_shapes(4, (8,), 2)
    n = sum(int(np.prod(s)) for s in shapes)
    layers = _unflatten(np.arange(n, dtype=np.float32), shapes)
    assert [l.shape for l in layers] == [(4, 8), (8,), (8, 2), (2,)]
    acts = _policy_act(layers, np.zeros((3, 4), np.float32))
    assert acts.shape == (3,)


def test_marwil_mc_returns():
    from ray_tpu_torch.rllib.offline import compute_mc_returns
    rewards = np.array([1.0, 1.0, 1.0, 2.0, 2.0], np.float64)
    dones = np.array([False, False, True, False, True])
    ret = compute_mc_returns(rewards, dones, gamma=0.5)
    np.testing.assert_allclose(ret, [1 + 0.5 + 0.25, 1.5, 1.0, 3.0, 2.0])


def test_a2c_smoke_and_checkpoint():
    from ray_tpu_torch.rllib import A2CConfig
    algo = (A2CConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        r = algo.step()
        assert "learner_policy_loss" in r
        ckpt = algo.save_checkpoint()
        algo.load_checkpoint(ckpt)
    finally:
        algo.cleanup()


# -- learning tests (slow) ------------------------------------------------

@pytest.mark.slow
def test_a2c_learns_cartpole():
    """A2C must reach >= 150 on CartPole (the reference's a2c learning
    test bar is lower than PPO's: no clipping, single gradient step)."""
    from ray_tpu_torch.rllib import A2CConfig
    algo = (A2CConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=32)
            .training(lr=3e-3, entropy_coeff=0.01, **{"lambda": 0.97})
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for i in range(700):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 150:
            break
    algo.cleanup()
    assert best >= 150, f"best={best}"


def _pendulum_best(config_cls, bar):
    algo = (config_cls().environment("Pendulum-v1")
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
        if best >= bar:
            break
    algo.cleanup()
    return best


@pytest.mark.slow
def test_td3_learns_pendulum():
    """TD3 must reach >= -500 mean episode reward on Pendulum (same bar
    as SAC; random play is ~-1200)."""
    from ray_tpu_torch.rllib import TD3Config
    best = _pendulum_best(TD3Config, -500)
    assert best >= -500, f"best={best}"


@pytest.mark.slow
def test_marwil_learns_cartpole_from_mixed_dataset(tmp_path):
    """MARWIL from MIXED-quality data (every batch a learning PPO sampled,
    most of it mediocre) must beat plain cloning of that data: >= 120 on
    CartPole.  The exp(beta * adv) weight is what filters the mediocre
    majority out."""
    from ray_tpu_torch.rllib import MARWILConfig, PPOConfig
    ds = str(tmp_path / "mixed")
    # 1. A PPO run logs EVERYTHING it samples while learning.
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=128)
            .training(lr=5e-4, num_sgd_iter=6, sgd_minibatch_size=256,
                      entropy_coeff=0.005, output=ds)
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for i in range(80):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 185:
            break
    algo.cleanup()

    # 2. MARWIL from the logged mixture only.
    m = (MARWILConfig().environment("CartPole-v1")
         .offline_data(input=ds)
         .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                   rollout_fragment_length=64)
         .training(beta=1.0, sgd_iters_per_step=32, lr=1e-3)
         .resources(device="cpu")
         .debugging(seed=1).build())
    best = 0.0
    for i in range(60):
        r = m.step()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 120:
            break
    m.cleanup()
    assert best >= 120, f"MARWIL best={best}"


@pytest.mark.slow
def test_es_learns_cartpole(ray_start):  # noqa: F811
    """ES (gradient-free, antithetic perturbations on remote workers)
    must reach >= 150 mean perturbed-policy reward on CartPole."""
    from ray_tpu_torch.rllib import ESConfig
    algo = (ESConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2)
            .training(episodes_per_worker=10, sigma=0.1, lr=0.1)
            .debugging(seed=0).build())
    best = 0.0
    try:
        for i in range(150):
            r = algo.step()
            best = max(best, r.get("episode_reward_mean", 0.0))
            if best >= 150:
                break
    finally:
        algo.cleanup()
    assert best >= 150, f"ES best={best}"


def test_appo_smoke_and_clip_behavior():
    """APPO policy: one update runs, clipping differs from IMPALA's
    unclipped PG on the same batch when ratios are extreme."""
    import torch

    from ray_tpu_torch.rllib.appo import APPOPolicy
    from ray_tpu_torch.rllib.env import make_vector_env
    from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP,
                                                  DONES, OBS, REWARDS)
    env = make_vector_env("CartPole-v1", 2, seed=0)
    pol = APPOPolicy(4, env.action_space,
                     {"hiddens": (16, 16), "device": "cpu"}, seed=0)
    rng = np.random.default_rng(0)
    B, T = 2, 8
    batch = {
        OBS: torch.as_tensor(rng.standard_normal((B, T, 4)),
                             dtype=torch.float32),
        ACTIONS: torch.as_tensor(rng.integers(0, 2, (B, T))),
        # Extreme behavior logp: ratios far outside [0.8, 1.2].
        ACTION_LOGP: torch.full((B, T), -8.0),
        REWARDS: torch.as_tensor(rng.standard_normal((B, T)),
                                 dtype=torch.float32),
        DONES: torch.zeros((B, T), dtype=torch.bool),
        "bootstrap_obs": torch.as_tensor(rng.standard_normal((B, 4)),
                                         dtype=torch.float32),
    }
    stats = pol.learn_on_batch(batch)
    assert np.isfinite(stats["total_loss"])


@pytest.mark.slow
def test_appo_learns_cartpole():
    """APPO (async actors + clipped surrogate over V-trace) must improve
    substantially on CartPole — same bar as the IMPALA learning test."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import APPOConfig
    ray_tpu_torch.init(num_cpus=4)
    try:
        algo = (APPOConfig().environment("CartPole-v1")
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


@pytest.mark.slow
def test_ddpg_learns_pendulum():
    """DDPG (TD3 minus twin-min exploitation fixes) still clears a looser
    Pendulum bar (random ~-1200)."""
    from ray_tpu_torch.rllib import DDPGConfig
    best = _pendulum_best(DDPGConfig, -600)
    assert best >= -600, f"best={best}"

"""RL library tests, the port's mirror of tests/test_rllib.py.

Reference shape: rllib's learning tests assert a reward threshold on
CartPole (rllib/BUILD py_test targets); unit tests cover SampleBatch,
GAE postprocessing, and WorkerSet fault tolerance
(rllib/evaluation/tests/, rllib/policy/tests/).  Every policy and
algorithm runs on the CPU (``device="cpu"``); remote rollout workers are
card-less whatever the learner's device.  This module imports no JAX: the
cluster's workers import it.
"""

import numpy as np
import pytest

from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch.rllib import (CartPoleVectorEnv, PPOConfig, PPOPolicy,
                                 RolloutWorker, SampleBatch, WorkerSet,
                                 compute_gae)
from ray_tpu_torch.rllib.policy import tree_leaves
from ray_tpu_torch.rllib.sample_batch import DONES, OBS


# -- envs -----------------------------------------------------------------

def test_cartpole_dynamics_and_autoreset():
    env = CartPoleVectorEnv(num_envs=4, seed=0)
    obs = env.vector_reset()
    assert obs.shape == (4, 4)
    total_done = 0
    for _ in range(300):
        obs, rew, done, info = env.vector_step(
            np.random.default_rng(0).integers(0, 2, 4))
        assert obs.shape == (4, 4)
        assert (rew == 1.0).all()
        total_done += int(done.sum())
        # auto-reset: live state stays in bounds
        assert (np.abs(obs[:, 0]) <= 2.4 + 1e-6).all()
    # random policy can't balance 300 steps: episodes must have ended
    assert total_done > 0


def test_cartpole_balanced_episode_survives():
    env = CartPoleVectorEnv(num_envs=1, seed=0)
    env.vector_reset()
    # PD controller on (theta, theta_dot) balances the pole for a while
    done_seen = False
    for t in range(100):
        theta, theta_dot = env._state[0, 2], env._state[0, 3]
        obs, rew, done, info = env.vector_step(
            np.array([1 if theta + 0.5 * theta_dot > 0 else 0]))
        done_seen = done_seen or bool(done[0])
    assert not done_seen


# -- sample batch ---------------------------------------------------------

def test_sample_batch_concat_and_minibatches():
    b1 = SampleBatch({OBS: np.ones((4, 3)), DONES: np.zeros(4, bool)})
    b2 = SampleBatch({OBS: np.zeros((2, 3)), DONES: np.ones(2, bool)})
    cat = SampleBatch.concat_samples([b1, b2])
    assert cat.count == 6
    mbs = list(cat.minibatches(2, np.random.default_rng(0)))
    assert len(mbs) == 3 and all(mb.count == 2 for mb in mbs)
    eps = cat.split_by_episode()
    assert sum(e.count for e in eps) == 6


def test_gae_matches_hand_computation():
    # 3 steps, 1 env, no dones: delta_t = r + g*V_{t+1} - V_t
    r = np.array([[1.0], [1.0], [1.0]])
    v = np.array([[0.5], [0.4], [0.3]])
    d = np.zeros((3, 1), bool)
    last_v = np.array([0.2])
    g, lam = 0.9, 0.8
    adv, tgt = compute_gae(r, v, d, last_v, g, lam)
    d2 = 1 + g * 0.2 - 0.3
    d1 = 1 + g * 0.3 - 0.4
    d0 = 1 + g * 0.4 - 0.5
    e2 = d2
    e1 = d1 + g * lam * e2
    e0 = d0 + g * lam * e1
    np.testing.assert_allclose(adv[:, 0], [e0, e1, e2], rtol=1e-6)
    np.testing.assert_allclose(tgt, adv + v, rtol=1e-6)


def test_gae_stops_at_episode_boundary():
    r = np.array([[1.0], [1.0]])
    v = np.array([[0.5], [0.4]])
    d = np.array([[True], [False]])
    adv, _ = compute_gae(r, v, d, np.array([9.9]), 0.9, 0.8)
    # step 0 terminal: no bootstrap through step 1
    np.testing.assert_allclose(adv[0, 0], 1.0 - 0.5, rtol=1e-6)


# -- policy ---------------------------------------------------------------

def test_ppo_policy_shapes_and_update():
    from ray_tpu_torch.rllib.env import Space
    pol = PPOPolicy(4, Space("discrete", n=2),
                    {"lr": 1e-3, "num_sgd_iter": 2,
                     "sgd_minibatch_size": 32, "device": "cpu"}, seed=0)
    obs = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    out = pol.compute_actions(obs)
    assert out["actions"].shape == (8,)
    assert set(np.unique(out["actions"])) <= {0, 1}
    assert out["action_logp"].shape == (8,)
    assert out["vf_preds"].shape == (8,)

    n = 64
    rng = np.random.default_rng(1)
    batch = SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "action_logp": np.full(n, -0.69, np.float32),
        "vf_preds": np.zeros(n, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    })
    before = pol.get_weights()
    stats = pol.learn_on_batch(batch)
    after = pol.get_weights()
    assert "total_loss" in stats
    changed = any(
        not np.allclose(b, a)
        for b, a in zip(np.concatenate([np.ravel(x) for x in
                                        tree_leaves(before)]),
                        np.concatenate([np.ravel(x) for x in
                                        tree_leaves(after)])))
    assert changed


def test_rollout_worker_produces_postprocessed_batch():
    w = RolloutWorker({"env": "CartPole-v1", "num_envs_per_worker": 4,
                       "rollout_fragment_length": 16, "lr": 1e-3,
                       "num_sgd_iter": 1, "sgd_minibatch_size": 16,
                       "device": "cpu"},
                      worker_index=0)
    batch = w.sample()
    assert batch.count == 64
    for key in ("obs", "actions", "advantages", "value_targets",
                "action_logp", "vf_preds"):
        assert key in batch, key
    m = w.get_metrics()
    assert isinstance(m["episode_rewards"], list)


# -- worker set (needs cluster) ------------------------------------------

def _worker_set_config():
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                      rollout_fragment_length=8)
            .resources(device="cpu")
            .to_dict())


def test_worker_set_parallel_sample_and_sync(ray_start):  # noqa: F811
    ws = WorkerSet(_worker_set_config())
    try:
        batch = ws.synchronous_sample()
        assert batch.count == 2 * 2 * 8

        # perturb local weights, broadcast, verify remotes match
        weights = ws.local_worker.get_weights()
        weights["pi"]["b"] = weights["pi"]["b"] + 1.0
        ws.local_worker.set_weights(weights)
        ws.sync_weights()
        remote_w = ws.foreach_worker(lambda w: w.get_weights())[1]
        np.testing.assert_allclose(remote_w["pi"]["b"],
                                   weights["pi"]["b"], rtol=1e-6)
        assert ws.probe_unhealthy_workers() == []
    finally:
        ws.stop()


def test_worker_set_restores_dead_worker(ray_start):  # noqa: F811
    import ray_tpu_torch
    ws = WorkerSet(_worker_set_config())
    try:
        ws.ready(timeout=120.0)
        ray_tpu_torch.kill(ws.remote_workers[0])
        import time
        time.sleep(0.5)
        bad = ws.probe_unhealthy_workers(timeout=5.0)
        assert bad == [0]
        ws.restore_unhealthy_workers(bad)
        ws.ready(timeout=120.0)  # the replacement imports torch first
        assert ws.probe_unhealthy_workers() == []
        batch = ws.synchronous_sample()
        assert batch.count == 2 * 2 * 8
    finally:
        ws.stop()


# -- learning (the reference-style reward-threshold test) -----------------

@pytest.mark.slow
def test_ppo_learns_cartpole():
    """PPO must reach >= 195 mean episode reward on CartPole (the
    reference's learning-test bar for CartPole-v1, rllib/BUILD)."""
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=128)
            .training(lr=5e-4, num_sgd_iter=6, sgd_minibatch_size=256,
                      entropy_coeff=0.005)
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for i in range(150):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 195:
            break
    algo.stop()
    assert best >= 195, f"PPO failed to learn CartPole: best={best}"


@pytest.mark.slow
def test_ppo_distributed_rollouts_learn(ray_start):  # noqa: F811
    """PPO with 2 remote rollout-worker actors improves reward (weight
    broadcast + parallel sampling path end-to-end)."""
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                      rollout_fragment_length=64)
            .training(lr=5e-4, num_sgd_iter=6, sgd_minibatch_size=256,
                      entropy_coeff=0.005)
            .resources(device="cpu")
            .debugging(seed=0).build())
    first, last = None, 0.0
    for i in range(25):
        r = algo.train()
        rew = r.get("episode_reward_mean")
        if rew is not None:
            if first is None:
                first = rew
            last = rew
    algo.stop()
    assert first is not None
    assert last > first + 10, (first, last)


def _small_ppo(seed):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                      rollout_fragment_length=8)
            .resources(device="cpu")
            .debugging(seed=seed).build())


def test_algorithm_checkpoint_roundtrip():
    algo = _small_ppo(0)
    algo.train()
    ckpt = algo.save()
    w0 = algo.get_policy().get_weights()
    algo.stop()

    algo2 = _small_ppo(1)
    algo2.restore(ckpt)
    w1 = algo2.get_policy().get_weights()
    np.testing.assert_allclose(w0["pi"]["w"], w1["pi"]["w"], rtol=1e-6)
    algo2.stop()


def test_algorithm_evaluate():
    """Algorithm.evaluate runs isolated evaluation episodes (reference:
    Algorithm.evaluate) without touching training metrics or env state."""
    algo = _small_ppo(0)
    try:
        algo.train()
        before = algo.workers.local_worker.get_metrics()
        ev = algo.evaluate(num_episodes=3)["evaluation"]
        assert ev["num_episodes"] == 3
        assert ev["episode_reward_min"] <= ev["episode_reward_mean"] \
            <= ev["episode_reward_max"]
        assert ev["episode_len_mean"] >= 1
        after = algo.workers.local_worker.get_metrics()
        assert before == after, "evaluate polluted training metrics"
    finally:
        algo.stop()

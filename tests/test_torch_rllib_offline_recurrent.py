"""Offline RL (dataset IO, BC, OPE) + recurrent (LSTM) and attention
policies, the port's mirror of tests/test_rllib_offline_recurrent.py.

Reference shape: rllib/offline/tests (JsonReader/Writer roundtrip, OPE
estimators), rllib/algorithms/bc learning tests, and the RepeatAfterMe
recurrent-policy learning test (rllib/BUILD).  The CQL learning case
reads a dataset a DQN writes.  The JAX package runs its learning cases
in a hermetic CPU subprocess; here they run in the test's process, on
the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import (DatasetReader, DatasetWriter,
                                 ImportanceSamplingEstimator, SampleBatch)
from ray_tpu_torch.rllib.env import RepeatPreviousVectorEnv
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP, DONES,
                                              OBS, REWARDS)


# -- dataset IO -----------------------------------------------------------

def test_dataset_writer_reader_roundtrip(tmp_path):
    w = DatasetWriter(str(tmp_path / "ds"))
    rng = np.random.default_rng(0)
    for i in range(3):
        w.write(SampleBatch({
            OBS: rng.standard_normal((16, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 2, 16),
            REWARDS: np.full(16, float(i), np.float32)}))
    r = DatasetReader(str(tmp_path / "ds"), shuffle=False)
    all_ = r.read_all()
    assert all_.count == 48
    assert set(np.unique(all_[REWARDS])) == {0.0, 1.0, 2.0}
    mbs = r.iter_batches(12)
    mb = next(mbs)
    assert mb.count == 12 and mb[OBS].shape == (12, 4)


def test_dataset_reader_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        DatasetReader(str(tmp_path / "empty"))


# -- memory env -----------------------------------------------------------

def test_repeat_previous_env_reward_semantics():
    env = RepeatPreviousVectorEnv(num_envs=2, n_tokens=3, episode_len=5,
                                  seed=0)
    obs = env.vector_reset()
    assert obs.shape == (2, 3) and (obs.sum(axis=1) == 1.0).all()
    first_tok = obs.argmax(axis=1)
    # First step: no previous token, reward must be 0 regardless.
    obs, rew, done, _ = env.vector_step(first_tok)
    assert (rew == 0.0).all()
    # Second step: echoing the first token earns 1.0.
    obs, rew, done, _ = env.vector_step(first_tok)
    assert (rew == 1.0).all()
    # Wrong answer earns 0.
    prev = obs.argmax(axis=1)
    obs, rew, done, _ = env.vector_step((prev + 1) % 3)
    # note: correct action was the token from the PREVIOUS step, which we
    # deliberately did not echo
    assert (rew <= 1.0).all()


# -- off-policy estimation ------------------------------------------------

def test_importance_sampling_estimator_on_behavior_policy():
    """IS of the behavior policy itself must reproduce the empirical
    return (all ratios == 1)."""
    rng = np.random.default_rng(0)
    T = 30
    batch = SampleBatch({
        OBS: rng.standard_normal((T, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, T),
        ACTION_LOGP: np.full(T, -0.5, np.float32),
        REWARDS: np.ones(T, np.float32),
        DONES: np.array([False] * 9 + [True] + [False] * 9 + [True]
                        + [False] * 9 + [True]),
    })

    class SamePolicy:
        def logp_for(self, obs, actions):
            return np.full(len(obs), -0.5, np.float32)

    est = ImportanceSamplingEstimator(gamma=1.0)
    out = est.estimate(batch, SamePolicy())
    assert out["num_episodes"] == 3
    np.testing.assert_allclose(out["v_is"], 10.0, rtol=1e-6)
    np.testing.assert_allclose(out["v_wis"], 10.0, rtol=1e-6)


# -- learning tests (slow) ------------------------------------------------

@pytest.mark.slow
def test_bc_learns_cartpole_from_ppo_dataset(tmp_path):
    """BC must reach >= 150 on CartPole from a dataset written by a
    trained PPO policy (expert shards only)."""
    from ray_tpu_torch.rllib import BCConfig, PPOConfig
    ds = str(tmp_path / "expert")
    # 1. Train the behavior policy.
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
        if best >= 185:
            break
    assert best >= 185, f"behavior PPO failed: {best}"

    # 2. Write EXPERT shards (post-training rollouts only).
    w = DatasetWriter(ds)
    for _ in range(6):
        w.write(algo.workers.local_worker.sample())
    algo.cleanup()

    # 3. Clone from the dataset; evaluate by rolling the env greedily.
    bc = (BCConfig().environment("CartPole-v1")
          .offline_data(input=ds)
          .rollouts(num_envs_per_worker=8, rollout_fragment_length=256)
          .training(lr=1e-3, train_batch_size=512, sgd_iters_per_step=32)
          .resources(device="cpu")
          .debugging(seed=1).build())
    bc_best = 0.0
    for i in range(30):
        r = bc.train()
        bc_best = max(bc_best, r.get("episode_reward_mean", 0.0))
        if bc_best >= 150:
            break
    bc.cleanup()
    assert bc_best >= 150, f"BC failed to clone: {bc_best}"


@pytest.mark.slow
def test_cql_learns_cartpole_from_dqn_dataset(tmp_path):
    """CQL trains a Q-function purely from logged DQN transitions
    (mixed-quality data) to a usable CartPole policy."""
    from ray_tpu_torch.rllib import CQLConfig, DQNConfig
    ds = str(tmp_path / "dqn_data")
    # 1. A DQN run logs every sampled transition batch as it learns.
    algo = (DQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=4)
            .training(learning_starts=500, train_batch_size=64,
                      num_train_iters=8, target_network_update_freq=250,
                      epsilon_timesteps=5000, lr=1e-3, output=ds)
            .resources(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for i in range(1500):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 150:
            break
    assert best >= 150, f"behavior DQN failed: {best}"
    algo.cleanup()

    # 2. CQL from the logged data only.
    cql = (CQLConfig().environment("CartPole-v1")
           .offline_data(input=ds)
           .rollouts(num_envs_per_worker=8, rollout_fragment_length=128)
           .training(train_batch_size=512, sgd_iters_per_step=32,
                     cql_alpha=0.5, lr=5e-4)
           .resources(device="cpu")
           .debugging(seed=1).build())
    cql_best = 0.0
    for i in range(40):
        r = cql.train()
        cql_best = max(cql_best, r.get("episode_reward_mean", 0.0))
        if cql_best >= 120:
            break
    assert cql_best >= 120, f"CQL failed: {cql_best}"


@pytest.mark.slow
def test_recurrent_ppo_solves_memory_env():
    """An LSTM policy must beat the memoryless ceiling on a memory task.
    RepeatPrevious(3 tokens, len 32): uniform/memoryless policies peak at
    ~31/3 = 10.3 mean reward; the LSTM must exceed 22."""
    from ray_tpu_torch.rllib import RecurrentPPOConfig
    algo = (RecurrentPPOConfig().environment("RepeatPrevious-v0")
            .rollouts(num_envs_per_worker=16, rollout_fragment_length=64)
            .training(gamma=0.5, lr=1e-3, num_sgd_iter=8,
                      entropy_coeff=0.01)
            .resources(device="cpu")
            .debugging(seed=1).build())
    best = 0.0
    for i in range(80):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 24:
            break
    algo.cleanup()
    assert best >= 22, f"LSTM failed the memory task: {best}"


def _replay_diff(cfg, seq_forward):
    """Max |logp| difference between the learner's sequence forward over
    a fragment (state_in + reset masks) and the rollout's logp."""
    from ray_tpu_torch.rllib.recurrent import RESETS, STATE_IN
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
    w = RolloutWorker(cfg)
    w.sample()                      # fragment 1: leaves mid-episode state
    b = w.sample()                  # fragment 2: nonzero state_in
    assert np.abs(b[STATE_IN]).sum() > 0, "state_in should be mid-episode"
    p = w.policy
    with torch.no_grad():
        pi, v = seq_forward(p.params, torch.as_tensor(b[STATE_IN]),
                            torch.as_tensor(b[OBS]),
                            torch.as_tensor(b[RESETS]))
        T, n = v.shape
        logp = p.dist.logp(pi.reshape((T * n, -1)),
                           torch.as_tensor(b[ACTIONS]).reshape((T * n,))
                           ).reshape(T, n)
    return float(np.abs(logp.numpy() - b[ACTION_LOGP]).max())


@pytest.mark.slow
def test_recurrent_state_replay_matches_rollout():
    """The learner's sequence forward (state_in + reset masks) must
    reproduce the rollout's action logp exactly — the invariant that
    makes the PPO ratio meaningful for recurrent policies."""
    from ray_tpu_torch.rllib.ppo import RecurrentPPOConfig
    from ray_tpu_torch.rllib.recurrent import lstm_seq_forward
    cfg = RecurrentPPOConfig().environment("RepeatPrevious-v0").to_dict()
    cfg.update(rollout_fragment_length=48, num_envs_per_worker=4,
               device="cpu")
    diff = _replay_diff(cfg, lstm_seq_forward)
    assert diff < 1e-4, f"state replay diverged: {diff}"


# --------------------------------------------- model catalog + attention

def test_model_catalog_routing():
    from ray_tpu_torch.rllib import ModelCatalog
    assert ModelCatalog.policy_for({}) == "ppo"
    assert ModelCatalog.policy_for({"policy": "dqn"}) == "dqn"
    assert ModelCatalog.policy_for(
        {"model": {"use_lstm": True}}) == "recurrent_ppo"
    assert ModelCatalog.policy_for(
        {"model": {"use_attention": True}}) == "attention_ppo"
    # attention wins over lstm when both are set (most specific memory)
    assert ModelCatalog.policy_for(
        {"model": {"use_attention": True, "use_lstm": True}}) \
        == "attention_ppo"


@pytest.mark.slow
def test_attention_policy_solves_memory_env():
    """The GTrXL-style windowed-attention core must beat the memoryless
    ceiling on RepeatPrevious, routed via model={'use_attention': True}
    on a plain PPOConfig (reference: attention_net.py GTrXLNet)."""
    from ray_tpu_torch.rllib import PPOConfig
    algo = (PPOConfig().environment("RepeatPrevious-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=64)
            .training(gamma=0.5, lr=1e-3, num_sgd_iter=8,
                      entropy_coeff=0.01,
                      model={"use_attention": True, "attention_memory": 4})
            .resources(device="cpu")
            .debugging(seed=1).build())
    best = 0.0
    for i in range(100):
        r = algo.train()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 24:
            break
    algo.cleanup()
    assert best >= 22, f"attention policy failed the memory task: {best}"


@pytest.mark.slow
def test_attention_state_replay_matches_rollout():
    """Learner-side attn_seq_forward must reproduce rollout logp exactly
    (same invariant as the LSTM test)."""
    from ray_tpu_torch.rllib.catalog import attn_seq_forward
    from ray_tpu_torch.rllib.ppo import PPOConfig
    cfg = PPOConfig().environment("RepeatPrevious-v0").to_dict()
    cfg.update(rollout_fragment_length=48, num_envs_per_worker=4,
               model={"use_attention": True, "attention_memory": 4},
               device="cpu")
    diff = _replay_diff(cfg, attn_seq_forward)
    assert diff < 1e-4, f"attention state replay diverged: {diff}"

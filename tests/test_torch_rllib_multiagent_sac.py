"""Multi-agent PPO (policy mapping, shared-param self-play), the port's
mirror of tests/test_rllib_multiagent_sac.py.

Reference analogs: rllib/env/multi_agent_env.py contract tests,
rllib/policy/sample_batch.py MultiAgentBatch, and the two-step-game /
self-play learning examples.  The trainer's policies run on the CPU
(``device="cpu"``).
"""

import numpy as np
import pytest

from ray_tpu_torch.rllib import (CoordinationGameEnv, MultiAgentBatch,
                                 MultiAgentPPOConfig)


def _shared_cfg(**training):
    return (MultiAgentPPOConfig().environment("CoordinationGame-v0")
            .rollouts(num_envs_per_worker=8, rollout_fragment_length=64)
            .training(lr=1e-3, **training)
            .multi_agent(policies={"shared": {}},
                         policy_mapping_fn=lambda aid: "shared")
            .resources(device="cpu"))


def test_multi_agent_env_contract():
    env = CoordinationGameEnv(episode_len=4, seed=0)
    obs = env.reset(seed=1)
    assert set(obs) == {"agent_0", "agent_1"}
    # agent-identity feature differs, target feature matches
    assert not np.array_equal(obs["agent_0"], obs["agent_1"])
    assert np.array_equal(obs["agent_0"][:4], obs["agent_1"][:4])
    target = int(np.argmax(obs["agent_0"][:4]))
    obs, rew, dones, _ = env.step({"agent_0": target, "agent_1": target})
    assert rew == {"agent_0": 1.0, "agent_1": 1.0}
    assert dones["__all__"] is False
    for _ in range(3):
        obs, rew, dones, _ = env.step({"agent_0": 0, "agent_1": 1})
    assert dones["__all__"] is True
    assert rew["agent_0"] == 0.0   # mismatched actions never score


def test_multi_agent_smoke_and_checkpoint():
    algo = _shared_cfg().build()
    r = algo.step()
    assert isinstance(r["num_env_steps_sampled"], int)
    assert "shared" in r["info"]["learner"]
    ckpt = algo.save_checkpoint()
    assert "shared" in ckpt
    algo.load_checkpoint(ckpt)
    algo.cleanup()


def test_multi_agent_batch_shapes():
    from ray_tpu_torch.rllib.multi_agent import MultiAgentRolloutSampler
    cfg = (MultiAgentPPOConfig().environment("CoordinationGame-v0")
           .rollouts(num_envs_per_worker=2, rollout_fragment_length=8)
           .multi_agent(
               policies={"a": {}, "b": {}},
               policy_mapping_fn=lambda aid: "a" if aid == "agent_0"
               else "b")
           .resources(device="cpu"))
    sampler = MultiAgentRolloutSampler(cfg._config)
    batch = sampler.sample()
    assert isinstance(batch, MultiAgentBatch)
    assert batch.count == 16                  # 8 steps x 2 envs
    # each policy saw its agent in both envs: 8 * 2 rows
    assert batch["a"]["obs"].shape[0] == 16
    assert batch["b"]["obs"].shape[0] == 16


@pytest.mark.slow
def test_multi_agent_shared_selfplay_learns():
    """Shared-parameter self-play must coordinate: >= 24/32 mean episode
    reward (random play scores ~2)."""
    algo = _shared_cfg().build()
    best = 0.0
    for _ in range(200):
        r = algo.step()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 24:
            break
    assert best >= 24, f"best={best}"


@pytest.mark.slow
def test_multi_agent_independent_policies_learn():
    """Distinct policies (different architectures!) per agent must still
    coordinate — exercises the policy-mapping path end to end."""
    cfg = (MultiAgentPPOConfig().environment("CoordinationGame-v0")
           .rollouts(num_envs_per_worker=8, rollout_fragment_length=64)
           .training(lr=1e-3)
           .multi_agent(
               policies={"a": {}, "b": {"hiddens": (32, 32)}},
               policy_mapping_fn=lambda aid: "a" if aid == "agent_0"
               else "b")
           .resources(device="cpu"))
    algo = cfg.build()
    best = 0.0
    for _ in range(250):
        r = algo.step()
        best = max(best, r.get("episode_reward_mean", 0.0))
        if best >= 24:
            break
    assert best >= 24, f"best={best}"

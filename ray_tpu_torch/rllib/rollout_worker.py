"""RolloutWorker: owns a vector env + policy copy, produces SampleBatches.

Port of ``ray_tpu/rllib/rollout_worker.py``.  Design analog: reference ``rllib/evaluation/rollout_worker.py:165`` (env
loop, ``sample():875``) with postprocessing (GAE) applied worker-side as in
``rllib/evaluation/postprocessing.py``.  Rollout workers are host-CPU
actors feeding a device learner (Podracer/Anakin split): the env batch
steps vectorized in numpy, action selection is one policy call per step,
on the CPU in a remote worker (``WorkerSet`` builds them with
``device="cpu"``) and on the learner's device in the local worker.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.policy import PPOPolicy, compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ACTION_LOGP, ADVANTAGES, DONES, NEXT_OBS, OBS, REWARDS,
    SampleBatch, VALUE_TARGETS, VF_PREDS)


def _resolve_policy_class(name: str):
    """Policy registry keyed by config['policy'] — resolved lazily so
    remote workers (fresh processes) don't need the algo module imported
    up front (reference: ModelCatalog/policy mapping by name)."""
    if name == "ppo":
        return PPOPolicy
    if name == "dqn":
        from ray_tpu_torch.rllib.dqn import DQNPolicy
        return DQNPolicy
    if name == "impala":
        from ray_tpu_torch.rllib.impala import ImpalaPolicy
        return ImpalaPolicy
    if name == "appo":
        from ray_tpu_torch.rllib.appo import APPOPolicy
        return APPOPolicy
    if name == "sac":
        from ray_tpu_torch.rllib.sac import SACPolicy
        return SACPolicy
    if name == "recurrent_ppo":
        from ray_tpu_torch.rllib.recurrent import RecurrentPPOPolicy
        return RecurrentPPOPolicy
    if name == "attention_ppo":
        from ray_tpu_torch.rllib.catalog import AttentionPPOPolicy
        return AttentionPPOPolicy
    if name == "bc":
        from ray_tpu_torch.rllib.offline import BCPolicy
        return BCPolicy
    if name == "marwil":
        from ray_tpu_torch.rllib.offline import MARWILPolicy
        return MARWILPolicy
    if name == "a2c":
        from ray_tpu_torch.rllib.a2c import A2CPolicy
        return A2CPolicy
    if name == "td3":
        from ray_tpu_torch.rllib.td3 import TD3Policy
        return TD3Policy
    if name == "ddpg":
        from ray_tpu_torch.rllib.ddpg import DDPGPolicy
        return DDPGPolicy
    raise ValueError(f"unknown policy {name!r}")


class RolloutWorker:
    """One sampling unit: ``sample()`` returns a postprocessed SampleBatch
    of ``rollout_fragment_length * num_envs`` steps."""

    def __init__(self, config: Dict[str, Any], worker_index: int = 0):
        self.config = config
        self.worker_index = worker_index
        seed = config.get("seed", 0) * 1000 + worker_index
        self.env = make_vector_env(
            config["env"], config.get("num_envs_per_worker", 1), seed=seed,
            **config.get("env_config", {}))
        obs_dim = int(np.prod(self.env.observation_space.shape))
        # model={"use_lstm"/"use_attention": True} routes through the
        # catalog, like the reference's ModelCatalog wrapper selection.
        from ray_tpu_torch.rllib.catalog import ModelCatalog
        self.policy = _resolve_policy_class(ModelCatalog.policy_for(config))(
            obs_dim, self.env.action_space, config, seed=seed)
        self._obs = self.env.vector_reset(seed=seed)
        n = self.env.num_envs
        self._episode_rewards = np.zeros((n,), np.float64)
        self._episode_lens = np.zeros((n,), np.int64)
        self._completed_rewards: List[float] = []
        self._completed_lens: List[int] = []

    def _record_step_metrics(self, reward: np.ndarray, done: np.ndarray):
        """Per-step episode bookkeeping shared by all sampling modes."""
        self._episode_rewards += reward
        self._episode_lens += 1
        if done.any():
            idx = np.nonzero(done)[0]
            self._completed_rewards.extend(
                self._episode_rewards[idx].tolist())
            self._completed_lens.extend(self._episode_lens[idx].tolist())
            self._episode_rewards[idx] = 0.0
            self._episode_lens[idx] = 0

    # -- sampling ---------------------------------------------------------
    def sample(self) -> SampleBatch:
        if getattr(self.policy, "replay_style", False):
            return self._sample_transitions()
        if getattr(self.policy, "sequence_style", False):
            return self._sample_sequences()
        if getattr(self.policy, "recurrent", False):
            return self._sample_recurrent()
        return self._sample_onpolicy()

    def _sample_recurrent(self) -> SampleBatch:
        """Time-major [T, n] fragments for LSTM policies: snapshots the
        fragment-start hidden state and records per-step reset masks so
        the learner replays episode boundaries inside its scan
        (reference: sequence handling in rllib sample collectors)."""
        from ray_tpu_torch.rllib.recurrent import RESETS, STATE_IN
        T = self.config.get("rollout_fragment_length", 128)
        n = self.env.num_envs
        gamma = self.config.get("gamma", 0.99)
        lam = self.config.get("lambda", 0.95)
        self.policy._ensure_state(n)
        state_in = self.policy.state_snapshot()

        obs_buf = np.empty((T, n) + self._obs.shape[1:], np.float32)
        act_buf: Optional[np.ndarray] = None
        logp_buf = np.empty((T, n), np.float32)
        vf_buf = np.empty((T, n), np.float32)
        rew_buf = np.empty((T, n), np.float32)
        done_buf = np.empty((T, n), bool)
        resets = np.zeros((T, n), np.float32)
        prev_done = np.zeros((n,), bool)

        for t in range(T):
            resets[t] = prev_done     # env finished at t-1 -> zero state
            out = self.policy.compute_actions(self._obs)
            actions = out[ACTIONS]
            if act_buf is None:
                act_buf = np.empty((T,) + actions.shape, actions.dtype)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = out[ACTION_LOGP]
            vf_buf[t] = out[VF_PREDS]
            next_obs, reward, done, info = self.env.vector_step(actions)
            rew_buf[t] = reward
            done_buf[t] = done
            self.policy.notify_dones(done)
            prev_done = done
            self._record_step_metrics(reward, done)
            self._obs = next_obs

        last_values = self.policy.compute_values(self._obs)
        adv, targets = compute_gae(rew_buf, vf_buf, done_buf, last_values,
                                   gamma, lam)
        return SampleBatch({
            OBS: obs_buf, ACTIONS: act_buf, ACTION_LOGP: logp_buf,
            VF_PREDS: vf_buf, REWARDS: rew_buf, DONES: done_buf,
            ADVANTAGES: adv, VALUE_TARGETS: targets,
            STATE_IN: state_in, RESETS: resets})

    def _sample_sequences(self) -> SampleBatch:
        """Batch-major [n, T, ...] trajectory fragments with behavior logp
        and a bootstrap obs — the learner applies its own off-policy
        correction (V-trace for IMPALA; no worker-side GAE)."""
        T = self.config.get("rollout_fragment_length", 128)
        n = self.env.num_envs
        obs_buf = np.empty((T, n) + self._obs.shape[1:], np.float32)
        act_buf = None
        logp_buf = np.empty((T, n), np.float32)
        rew_buf = np.empty((T, n), np.float32)
        done_buf = np.empty((T, n), bool)
        for t in range(T):
            out = self.policy.compute_actions(self._obs)
            actions = out[ACTIONS]
            if act_buf is None:
                act_buf = np.empty((T,) + actions.shape, actions.dtype)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = out[ACTION_LOGP]
            next_obs, reward, done, info = self.env.vector_step(actions)
            rew_buf[t] = reward
            # Truncations count as done for V-trace: the post-reset obs at
            # t+1 belongs to a NEW episode, so bootstrapping through it
            # would leak value across the boundary (standard IMPALA treats
            # every episode end as terminal; the small bias at time-limit
            # cuts beats cross-episode leakage).
            done_buf[t] = done
            self._record_step_metrics(reward, done)
            self._obs = next_obs

        def bt(a):  # time-major -> batch-major
            return np.swapaxes(a, 0, 1)
        return SampleBatch({
            OBS: bt(obs_buf), ACTIONS: bt(act_buf),
            ACTION_LOGP: bt(logp_buf), REWARDS: bt(rew_buf),
            DONES: bt(done_buf),
            "bootstrap_obs": self._obs.astype(np.float32)})

    def _sample_transitions(self) -> SampleBatch:
        """Raw (s, a, r, s', done) fragments for replay-based algorithms
        (DQN family); no GAE postprocessing."""
        T = self.config.get("rollout_fragment_length", 128)
        n = self.env.num_envs
        obs_buf = np.empty((T, n) + self._obs.shape[1:], np.float32)
        next_buf = np.empty_like(obs_buf)
        act_buf = None
        rew_buf = np.empty((T, n), np.float32)
        done_buf = np.empty((T, n), bool)
        for t in range(T):
            out = self.policy.compute_actions(self._obs)
            actions = out[ACTIONS]
            if act_buf is None:
                act_buf = np.empty((T,) + actions.shape, actions.dtype)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            next_obs, reward, done, info = self.env.vector_step(actions)
            # Terminal next-obs: envs auto-reset, so `next_obs` is the new
            # episode's first obs; the true terminal obs rides in info.
            step_next = next_obs
            term = info.get("terminal_obs")
            if term is not None and done.any():
                mask = done.reshape((n,) + (1,) * (next_obs.ndim - 1))
                step_next = np.where(mask, term, next_obs)
            next_buf[t] = step_next
            # Truncations bootstrap: treat truncated as NOT done for the
            # Bellman target (value continues past the horizon).
            truncated = info.get("truncated")
            eff_done = done if truncated is None else (done & ~truncated)
            rew_buf[t] = reward
            done_buf[t] = eff_done
            self._record_step_metrics(reward, done)
            self._obs = next_obs

        def flat(a):
            return a.reshape((T * n,) + a.shape[2:])
        return SampleBatch({
            OBS: flat(obs_buf), ACTIONS: flat(act_buf),
            REWARDS: flat(rew_buf), DONES: flat(done_buf),
            NEXT_OBS: flat(next_buf)})

    def _sample_onpolicy(self) -> SampleBatch:
        T = self.config.get("rollout_fragment_length", 128)
        n = self.env.num_envs
        gamma = self.config.get("gamma", 0.99)
        lam = self.config.get("lambda", 0.95)

        obs_buf = np.empty((T, n) + self._obs.shape[1:], np.float32)
        act_buf: Optional[np.ndarray] = None
        logp_buf = np.empty((T, n), np.float32)
        vf_buf = np.empty((T, n), np.float32)
        rew_buf = np.empty((T, n), np.float32)
        done_buf = np.empty((T, n), bool)
        # value bootstrap for envs truncated (not terminated) at step t
        trunc_bootstrap = np.zeros((T, n), np.float32)

        for t in range(T):
            out = self.policy.compute_actions(self._obs)
            actions = out[ACTIONS]
            if act_buf is None:
                act_buf = np.empty((T,) + actions.shape, actions.dtype)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = out[ACTION_LOGP]
            vf_buf[t] = out[VF_PREDS]
            next_obs, reward, done, info = self.env.vector_step(actions)
            rew_buf[t] = reward
            done_buf[t] = done
            # Truncated episodes still have value beyond the horizon:
            # bootstrap their reward with V(terminal_obs)
            # (reference postprocessing.py does the same for TimeLimit).
            truncated = info.get("truncated")
            if truncated is not None and truncated.any():
                term_v = self.policy.compute_values(info["terminal_obs"])
                trunc_bootstrap[t] = np.where(truncated, term_v, 0.0)
            self._record_step_metrics(reward, done)
            self._obs = next_obs

        rew_buf = rew_buf + gamma * trunc_bootstrap
        last_values = self.policy.compute_values(self._obs)
        adv, targets = compute_gae(rew_buf, vf_buf, done_buf, last_values,
                                   gamma, lam)

        def flat(a):
            return a.reshape((T * n,) + a.shape[2:])
        return SampleBatch({
            OBS: flat(obs_buf), ACTIONS: flat(act_buf),
            ACTION_LOGP: flat(logp_buf), VF_PREDS: flat(vf_buf),
            REWARDS: flat(rew_buf), DONES: flat(done_buf),
            ADVANTAGES: flat(adv), VALUE_TARGETS: flat(targets)})

    # -- weights / metrics / health --------------------------------------
    def get_weights(self):
        return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def get_metrics(self) -> Dict[str, Any]:
        """Drain completed-episode stats since the last call."""
        out = {"episode_rewards": self._completed_rewards,
               "episode_lens": self._completed_lens}
        self._completed_rewards = []
        self._completed_lens = []
        return out

    def ping(self) -> str:
        return "ok"

    def apply(self, fn, *args):
        """Run an arbitrary function on this worker (reference
        rollout_worker.apply) — used by tests and custom algorithms."""
        return fn(self, *args)

"""Algorithm: the RL training loop as a Tune Trainable.

Port of ``ray_tpu/rllib/algorithm.py`` on the port's ``tune.trainable``.
Design analog: reference ``rllib/algorithms/algorithm.py:143`` (Algorithm
is a Trainable whose ``step`` runs ``training_step`` then collects
metrics) and ``algorithm_config.py:152`` (fluent config builder).

The learner (the local worker's policy) runs on ``config["device"]``,
which ``AlgorithmConfig.resources(device=...)`` sets: None, the default,
is the first card (raising without one), ``"cpu"`` the CPU.  Remote
rollout workers hold no card whatever the learner's device.  So a trial
of an algorithm whose learner is on a card asks for
``num_learner_devices`` cards (``default_resource_request``), as the
JAX package's asked for TPU chips.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.rllib.worker_set import WorkerSet
from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    """Fluent builder: ``PPOConfig().environment("CartPole-v1")
    .rollouts(num_rollout_workers=2).training(lr=1e-3).build()``."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self._config: Dict[str, Any] = {
            "env": None,
            "env_config": {},
            "num_rollout_workers": 0,
            "num_envs_per_worker": 1,
            "rollout_fragment_length": 128,
            "num_cpus_per_worker": 1,
            "gamma": 0.99,
            "lr": 3e-4,
            "seed": 0,
            "device": None,
            "restore_unhealthy_workers": True,
            "metrics_num_episodes_for_smoothing": 100,
        }

    def environment(self, env: str, env_config: Optional[Dict] = None
                    ) -> "AlgorithmConfig":
        self._config["env"] = env
        if env_config is not None:
            self._config["env_config"] = env_config
        return self

    def rollouts(self, **kwargs) -> "AlgorithmConfig":
        self._config.update(kwargs)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        self._config.update(kwargs)
        return self

    def debugging(self, *, seed: int = 0) -> "AlgorithmConfig":
        self._config["seed"] = seed
        return self

    def resources(self, **kwargs) -> "AlgorithmConfig":
        self._config.update(kwargs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._config)

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class bound")
        return self.algo_class(config=self.to_dict())


class Algorithm(Trainable):
    """Subclasses implement ``training_step() -> result dict``."""

    # False where the learner runs no device work (ES): its trials ask
    # for no card.
    learner_on_device = True

    def setup(self, config: Dict[str, Any]) -> None:
        self.workers = WorkerSet(config)
        self._episode_rewards: collections.deque = collections.deque(
            maxlen=config.get("metrics_num_episodes_for_smoothing", 100))
        self._episode_lens: collections.deque = collections.deque(
            maxlen=config.get("metrics_num_episodes_for_smoothing", 100))
        self._timesteps_total = 0

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def step(self) -> Dict[str, Any]:
        if self.config.get("restore_unhealthy_workers", True):
            bad = self.workers.probe_unhealthy_workers()
            if bad:
                self.workers.restore_unhealthy_workers(bad)
        result = self.training_step()
        m = self.workers.collect_metrics()
        self._episode_rewards.extend(m["episode_rewards"])
        self._episode_lens.extend(m["episode_lens"])
        if self._episode_rewards:
            result["episode_reward_mean"] = float(
                np.mean(self._episode_rewards))
            result["episode_reward_max"] = float(
                np.max(self._episode_rewards))
            result["episode_len_mean"] = float(np.mean(self._episode_lens))
        result["num_env_steps_sampled"] = self._timesteps_total
        return result

    def evaluate(self, num_episodes: int = 10,
                 timeout_s: float = 300.0) -> Dict[str, Any]:
        """Run evaluation episodes with the CURRENT policy on a fresh env
        (reference: ``Algorithm.evaluate`` / evaluation workers).  Uses
        its own env instance so training-side episode metrics and env
        state are untouched."""
        import time as _time

        import numpy as _np

        from ray_tpu_torch.rllib.env import make_vector_env
        cfg = self.config
        env = make_vector_env(cfg["env"], 1,
                              seed=cfg.get("seed", 0) + 977,
                              **cfg.get("env_config", {}))
        policy = self.workers.local_worker.policy
        rewards, lens = [], []
        deadline = _time.monotonic() + timeout_s
        # Recurrent policies carry rollout state on the policy object;
        # with local sampling that state is mid-episode training state —
        # snapshot it and restore after evaluation so eval never perturbs
        # training (ADVICE r4).
        saved_state = getattr(policy, "_state", None)
        try:
            for _ in range(num_episodes):
                if _time.monotonic() > deadline:
                    break
                if hasattr(policy, "_ensure_state"):
                    policy._state = None
                    policy._ensure_state(1)
                obs = env.vector_reset()
                total, steps = 0.0, 0
                for _ in range(cfg.get("evaluation_max_steps", 1000)):
                    out = policy.compute_actions(
                        _np.asarray(obs, _np.float32))
                    obs, rew, done, _info = env.vector_step(out["actions"])
                    total += float(rew[0])
                    steps += 1
                    if hasattr(policy, "notify_dones"):
                        policy.notify_dones(done)
                    if bool(done[0]):
                        break
                rewards.append(total)
                lens.append(steps)
        finally:
            if hasattr(policy, "_ensure_state"):
                policy._state = saved_state
        return {
            "evaluation": {
                "episode_reward_mean": float(_np.mean(rewards))
                if rewards else float("nan"),
                "episode_reward_min": float(_np.min(rewards))
                if rewards else float("nan"),
                "episode_reward_max": float(_np.max(rewards))
                if rewards else float("nan"),
                "episode_len_mean": float(_np.mean(lens))
                if lens else float("nan"),
                "num_episodes": len(rewards),
            }
        }

    # -- checkpointing (Trainable contract) -------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {"weights": self.workers.local_worker.get_weights(),
                "timesteps": self._timesteps_total}

    def load_checkpoint(self, checkpoint: Optional[Dict[str, Any]]) -> None:
        if not checkpoint:
            return
        self.workers.local_worker.set_weights(checkpoint["weights"])
        self._timesteps_total = checkpoint.get("timesteps", 0)
        self.workers.sync_weights()

    def get_policy(self):
        return self.workers.local_worker.policy

    def cleanup(self) -> None:
        self.workers.stop()

    @classmethod
    def default_resource_request(cls, config: Dict[str, Any]
                                 ) -> Dict[str, float]:
        """The trial's CPUs (its own and its rollout workers'), and its
        learner's cards unless the config puts the learner on the CPU.
        The trial runner calls it with ``{}``: the default device, a
        card."""
        out = {"CPU": 1.0 + config.get("num_rollout_workers", 0)
               * config.get("num_cpus_per_worker", 1)}
        if cls.learner_on_device:
            out.update(learner_cards(config))
        return out


def learner_cards(config: Dict[str, Any]) -> Dict[str, float]:
    """``{"GPU": num_learner_devices}`` for a trial whose learner runs on
    ``config["device"]``, or ``{}`` when that is the CPU.  The trial
    runner calls ``default_resource_request`` with ``{}``: the default
    device, a card.  Trainables outside ``Algorithm`` (MultiAgentPPO,
    QMIX) add it to their own requests."""
    device = config.get("device")
    if device is not None and str(device).startswith("cpu"):
        return {}
    return {"GPU": float(config.get("num_learner_devices", 1) or 1)}

"""A2C: synchronous advantage actor-critic.

Port of ``ray_tpu/rllib/a2c.py``.  Design analog: reference
``rllib/algorithms/a2c/a2c.py`` (synchronous parallel sampling -> ONE
gradient step on the whole batch -> broadcast; the non-clipped, non-epoch
little sibling of PPO).  Rollout workers are host-CPU actors sharing
PPO's GAE postprocessing (policy.py compute_gae).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (ActorCriticPolicy, ac_forward,
                                        host_batch, normalized_advantages,
                                        stats_to_floats, to_tensors,
                                        tree_leaves, tree_unflatten,
                                        value_and_grad)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, OBS,
                                              SampleBatch, VALUE_TARGETS)


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(A2C)
        self._config.update({
            "policy": "a2c",
            "lambda": 1.0,                  # plain returns by default
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "grad_clip": 0.5,
            "lr": 1e-3,
            "hiddens": (64, 64),
            "num_envs_per_worker": 8,
            "rollout_fragment_length": 32,
        })


class A2CPolicy(ActorCriticPolicy):
    """Vanilla policy-gradient + value loss, one gradient step per train
    batch (no ratio clipping, no minibatch epochs — that's PPO)."""

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        self._init_actor_critic(obs_dim, action_space, config, seed, 1e-3)
        self._vf_coeff = config.get("vf_loss_coeff", 0.5)
        self._ent_coeff = config.get("entropy_coeff", 0.01)

    def _loss(self, params, batch):
        dist = self.dist
        pi, v = ac_forward(params, batch[OBS])
        logp = dist.logp(pi, batch[ACTIONS])
        pg = -torch.mean(logp * batch[ADVANTAGES])
        vf = torch.mean((v - batch[VALUE_TARGETS]) ** 2)
        ent = torch.mean(dist.entropy(pi))
        total = pg + self._vf_coeff * vf - self._ent_coeff * ent
        return total, {"policy_loss": pg, "vf_loss": vf,
                       "entropy": ent, "total_loss": total}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        tensors = to_tensors(host_batch(normalized_advantages(batch)),
                             self.device)
        stats, grads = value_and_grad(lambda p: self._loss(p, tensors),
                                      self.params)
        self.params = tree_unflatten(self.params, self._opt.step(
            tree_leaves(self.params), grads))
        return stats_to_floats(stats)


class A2C(Algorithm):
    def __init__(self, config=None, **kwargs):
        config = dict(config or {})
        config.setdefault("policy", "a2c")
        super().__init__(config=config, **kwargs)

    def training_step(self) -> Dict[str, Any]:
        train_batch = self.workers.synchronous_sample()
        self._timesteps_total += train_batch.count
        stats = self.workers.local_worker.policy.learn_on_batch(train_batch)
        self.workers.sync_weights()
        return {"info": {"learner": stats},
                "train_batch_size": train_batch.count,
                **{f"learner_{k}": v for k, v in stats.items()}}

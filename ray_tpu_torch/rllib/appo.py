"""APPO: asynchronous PPO (IMPALA machinery + clipped surrogate).

Port of ``ray_tpu/rllib/appo.py``.  Design analog: reference
``rllib/algorithms/appo/appo.py`` — IMPALA's async actor/learner
pipeline, but the learner applies PPO's clipped surrogate over
V-trace-corrected advantages instead of the plain policy-gradient loss
(clipping bounds the update against the stale behavior policy; V-trace
corrects the value targets).  All the machinery — async fragment
harvesting, host->device loader thread, broadcast interval — is inherited
from ``rllib/impala.py``; only the loss differs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, ImpalaPolicy
from ray_tpu_torch.rllib.sample_batch import ACTION_LOGP


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self._config.update({
            "policy": "appo",
            "clip_param": 0.2,
            "lr": 5e-4,
        })
        self.algo_class = APPO


class APPOPolicy(ImpalaPolicy):
    """IMPALA policy with the loss swapped for a clipped surrogate."""

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        super().__init__(obs_dim, action_space, config, seed=seed)
        self._clip = config.get("clip_param", 0.2)

    def _loss(self, p, batch):
        logp_bt, entropy, v, vs, pg_adv = self._forward(p, batch)
        # PPO clip against the BEHAVIOR policy's logp: the async gap is
        # exactly the ratio being clipped (reference
        # appo_torch_policy.py surrogate over vtrace advantages).
        clip = self._clip
        ratio = torch.exp(logp_bt - batch[ACTION_LOGP])
        surr = torch.minimum(ratio * pg_adv,
                             torch.clamp(ratio, 1 - clip, 1 + clip) * pg_adv)
        return self._total(-torch.mean(surr), v, vs, entropy)


class APPO(Impala):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "appo")
        super().setup(config)

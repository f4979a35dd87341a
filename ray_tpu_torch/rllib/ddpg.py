"""DDPG: deterministic policy gradient (the pre-TD3 baseline).

Port of ``ray_tpu/rllib/ddpg.py``, copied.  Design analog: reference
``rllib/algorithms/ddpg/ddpg.py``.  TD3 is DDPG plus twin critics, target
smoothing, and delayed actor updates — so this implementation IS the TD3
machinery with those three switched off (policy_delay=1, target_noise=0;
the twin critic's min() degenerates gracefully but we keep q2 training —
harmless and shares the update).  Kept as its own algorithm/config for
API parity with the reference's separate DDPG entry point.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.td3 import TD3, TD3Config, TD3Policy


class DDPGConfig(TD3Config):
    def __init__(self):
        super().__init__()
        self._config.update({
            "policy": "ddpg",
            "policy_delay": 1,          # actor updates every step
            "target_noise": 0.0,        # no target policy smoothing
            "target_noise_clip": 0.0,
            "exploration_noise": 0.1,
        })
        self.algo_class = DDPG


class DDPGPolicy(TD3Policy):
    pass


class DDPG(TD3):
    def setup(self, config) -> None:
        config = dict(config)
        config.setdefault("policy", "ddpg")
        config.setdefault("policy_delay", 1)
        config.setdefault("target_noise", 0.0)
        super().setup(config)

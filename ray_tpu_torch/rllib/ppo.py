"""PPO: clipped-surrogate policy optimization.

Port of ``ray_tpu/rllib/ppo.py``.  Design analog: reference
``rllib/algorithms/ppo/ppo.py:333`` (``training_step``: synchronous
parallel sampling -> minibatch SGD -> weight broadcast).  The SGD phase
(epochs x minibatches, ``PPOPolicy._update``) runs on the learner's
device; rollout workers are card-less host-CPU actors.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PPO)
        self._config.update({
            "lambda": 0.95,
            "clip_param": 0.2,
            "vf_clip_param": 10.0,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "num_sgd_iter": 4,
            "sgd_minibatch_size": 128,
            "grad_clip": 0.5,
            "lr": 3e-4,
            "hiddens": (64, 64),
            "num_envs_per_worker": 8,
            "rollout_fragment_length": 128,
        })


class PPO(Algorithm):
    def training_step(self) -> Dict[str, Any]:
        train_batch = self.workers.synchronous_sample()
        self._timesteps_total += train_batch.count
        stats = self.workers.local_worker.policy.learn_on_batch(train_batch)
        self.workers.sync_weights()
        return {"info": {"learner": stats},
                "train_batch_size": train_batch.count,
                **{f"learner_{k}": v for k, v in stats.items()}}


class RecurrentPPOConfig(PPOConfig):
    """PPO with an LSTM core (see rllib/recurrent.py) for POMDP/memory
    tasks.  Reference analog: PPOConfig().training(model={"use_lstm":
    True}) routing through rllib/models/torch/recurrent_net.py.
    Fragments are time-major per worker; sample with the local worker
    (num_rollout_workers=0) — cross-worker fragment concat is not wired.
    """

    def __init__(self):
        super().__init__()
        self._config.update({
            "policy": "recurrent_ppo",
            "lstm_cell_size": 64,
            "lstm_embed": 64,
            "num_rollout_workers": 0,
        })
        self.algo_class = RecurrentPPO


class RecurrentPPO(PPO):
    def __init__(self, config=None, **kwargs):
        config = dict(config or {})
        config.setdefault("policy", "recurrent_ppo")
        super().__init__(config=config, **kwargs)

"""TD3: twin-delayed deep deterministic policy gradient.

Port of ``ray_tpu/rllib/td3.py``.  Design analog: reference
``rllib/algorithms/td3/td3.py`` (DDPG + the three TD3 fixes: twin
critics, delayed policy updates, target policy smoothing).  Both critics
step every update; the actor and every target (the actor's included)
move every ``policy_delay`` updates, decided by a host ``if`` on the
policy's update counter (the reference's ``lax.cond``): on a skipped
update the actor, its Adam state and the targets stay as they were and
``actor_loss`` is exactly 0.  The target smoothing noise is one explicit
standard normal ``[B, act_dim]`` input, drawn from the policy's CPU
generator, as SAC's.  Shares the replay-driven Algorithm shape with
SAC/DQN.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (OptaxAdam, TorchPolicy,
                                        stats_to_floats, tree_leaves,
                                        tree_unflatten, value_and_grad)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sac import (_mlp, _mlp_init, _q_forward,
                                     continuous_device_batch, polyak)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS, SampleBatch)


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(TD3)
        self._config.update({
            "policy": "td3",
            "hiddens": (64, 64),
            "actor_lr": 1e-3,
            "critic_lr": 1e-3,
            "tau": 0.005,
            "policy_delay": 2,
            "exploration_noise": 0.1,       # of action scale, rollout side
            "target_noise": 0.2,            # smoothing noise on targets
            "target_noise_clip": 0.5,
            "train_batch_size": 256,
            "buffer_size": 100_000,
            "learning_starts": 1500,
            "num_train_iters": 8,
            "rollout_fragment_length": 8,
            "num_envs_per_worker": 8,
            "gamma": 0.99,
        })


class TD3Policy(TorchPolicy):
    replay_style = True

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        if action_space.kind != "box":
            raise ValueError("TD3 requires a continuous (box) action space")
        self._setup(action_space, config, seed)
        act_dim = int(np.prod(action_space.shape)) or 1
        self.act_dim = act_dim
        self.act_scale = float(action_space.high)
        hid = tuple(config.get("hiddens", (64, 64)))
        gen, dev = self._init_gen, self.device
        actor = _mlp_init(gen, (obs_dim,) + hid + (act_dim,), dev)
        q1 = _mlp_init(gen, (obs_dim + act_dim,) + hid + (1,), dev)
        q2 = _mlp_init(gen, (obs_dim + act_dim,) + hid + (1,), dev)
        self.params = {"actor": actor, "q1": q1, "q2": q2}
        # Params are replaced, never changed in place.
        self.target = dict(self.params)
        self._opt = {
            "actor": OptaxAdam(tree_leaves(actor),
                               config.get("actor_lr", 1e-3)),
            "critic": OptaxAdam(tree_leaves({"q1": q1, "q2": q2}),
                                config.get("critic_lr", 1e-3)),
        }
        self._noise_gen = torch.Generator().manual_seed(seed + 7)
        self._updates = 0
        self._gamma = config.get("gamma", 0.99)
        self._tau = config.get("tau", 0.005)
        self._delay = config.get("policy_delay", 2)
        scale = self.act_scale
        self._expl = config.get("exploration_noise", 0.1) * scale
        self._tnoise = config.get("target_noise", 0.2) * scale
        self._tclip = config.get("target_noise_clip", 0.5) * scale

    def _pi(self, actor, obs):
        return torch.tanh(_mlp(actor, obs)) * self.act_scale

    # -- rollout side -----------------------------------------------------

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        a = self._pi(self.params["actor"], self._obs(obs))
        noise = self._expl * torch.randn(a.shape, generator=self._act_gen,
                                         device=self.device)
        a = torch.clamp(a + noise, -self.act_scale, self.act_scale)
        return {ACTIONS: a.cpu().numpy().astype(np.float32)}

    # -- learner side -----------------------------------------------------

    def draw_noise(self, n: int) -> torch.Tensor:
        """The target smoothing draw: a standard normal ``[n, act_dim]``
        from the policy's CPU generator."""
        return torch.randn((n, self.act_dim), generator=self._noise_gen)

    def _update(self, b, eps):
        p, tgt, scale = self.params, self.target, self.act_scale
        # -- twin-critic update with target policy smoothing
        with torch.no_grad():
            noise = torch.clamp(self._tnoise * eps, -self._tclip,
                                self._tclip)
            a_next = torch.clamp(self._pi(tgt["actor"], b[NEXT_OBS]) + noise,
                                 -scale, scale)
            qn = torch.minimum(_q_forward(tgt["q1"], b[NEXT_OBS], a_next),
                               _q_forward(tgt["q2"], b[NEXT_OBS], a_next))
            backup = b[REWARDS] + self._gamma * (
                1.0 - b[DONES].to(torch.float32)) * qn

        def critic_loss(qs):
            l1 = torch.mean((_q_forward(qs["q1"], b[OBS], b[ACTIONS])
                             - backup) ** 2)
            l2 = torch.mean((_q_forward(qs["q2"], b[OBS], b[ACTIONS])
                             - backup) ** 2)
            total = l1 + l2
            return total, {"critic_loss": total}

        qs = {"q1": p["q1"], "q2": p["q2"]}
        stats, cgrads = value_and_grad(critic_loss, qs)
        qs = tree_unflatten(qs, self._opt["critic"].step(tree_leaves(qs),
                                                         cgrads))

        # -- delayed actor + target updates
        actor = p["actor"]
        if self._updates % self._delay == 0:
            def actor_loss(a):
                loss = -torch.mean(_q_forward(qs["q1"], b[OBS],
                                              self._pi(a, b[OBS])))
                return loss, {"actor_loss": loss}

            astats, agrads = value_and_grad(actor_loss, actor)
            actor = tree_unflatten(actor, self._opt["actor"].step(
                tree_leaves(actor), agrads))
            self.target = polyak(tgt, {"actor": actor, **qs}, self._tau)
            stats.update(astats)
        else:
            stats["actor_loss"] = torch.zeros((), device=self.device)
        stats["mean_q"] = torch.mean(backup)
        self.params = {"actor": actor, "q1": qs["q1"], "q2": qs["q2"]}
        self._updates += 1
        return stats

    def learn_on_batch(self, batch: SampleBatch,
                       noise: Optional[torch.Tensor] = None
                       ) -> Dict[str, float]:
        """One update; ``noise`` (the standard normal of the target
        smoothing) overrides the policy's own draw."""
        b = continuous_device_batch(batch, self.act_dim, self.device)
        if noise is None:
            noise = self.draw_noise(len(batch[OBS]))
        return stats_to_floats(self._update(b, noise.to(self.device)))

    def update_target(self):
        pass  # polyak-averaged inside the delayed update


class TD3(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "td3")
        super().setup(config)
        self.replay = ReplayBuffer(config.get("buffer_size", 100_000),
                                   seed=config.get("seed", 0))

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        batch = self.workers.synchronous_sample()
        self._timesteps_total += batch.count
        self.replay.add(batch)
        stats: Dict[str, Any] = {}
        policy = self.workers.local_worker.policy
        if len(self.replay) >= c.get("learning_starts", 1500):
            for _ in range(c.get("num_train_iters", 8)):
                train = self.replay.sample(c.get("train_batch_size", 256))
                stats = policy.learn_on_batch(train)
            self.workers.sync_weights()
        return {"info": {"learner": stats}, **stats}

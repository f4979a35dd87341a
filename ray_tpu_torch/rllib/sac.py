"""SAC: soft actor-critic for continuous control.

Port of ``ray_tpu/rllib/sac.py``.  Design analog: reference
``rllib/algorithms/sac/sac.py`` + ``sac_torch_policy.py`` (squashed-Gaussian
actor, twin soft Q critics, auto-tuned entropy temperature,
polyak-averaged targets).

The update is a function of the batch and two standard-normal draws,
``eps_next`` (the backup's next actions) and ``eps_cur`` (the actor
loss's actions), each ``[B, act_dim]``: ``learn_on_batch`` draws them from
the policy's CPU generator and moves them to the device, so the same
update on the CPU and on the card uses the same noise (and a test can
feed the JAX package's own draws).  Its steps run in the reference's
order: the critics step first with the temperature from before any step,
the actor loss reads the stepped critics, the temperature loss reads the
actor pass's (pre-step) logp, and the targets move toward the stepped
critics.  Three Adams keep their own states.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (OptaxAdam, TorchPolicy,
                                        stats_to_floats, to_tensors,
                                        tree_leaves, tree_to_numpy,
                                        tree_unflatten, value_and_grad)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS, SampleBatch)

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(SAC)
        self._config.update({
            "policy": "sac",
            "hiddens": (64, 64),
            "actor_lr": 3e-4,
            "critic_lr": 3e-4,
            "alpha_lr": 3e-4,
            "initial_alpha": 0.1,
            "tau": 0.005,                    # polyak rate
            "train_batch_size": 256,
            "buffer_size": 100_000,
            "learning_starts": 1500,
            "num_train_iters": 8,
            "rollout_fragment_length": 8,
            "num_envs_per_worker": 8,
            "gamma": 0.99,
        })


def _mlp_init(gen: torch.Generator, sizes, device="cpu"):
    """Layers uniform in +-1/sqrt(fan_in), zero biases; drawn on the CPU
    from ``gen``."""
    params = []
    for i in range(len(sizes) - 1):
        lim = 1.0 / math.sqrt(sizes[i])
        w = (torch.rand((sizes[i], sizes[i + 1]), generator=gen) * 2.0
             - 1.0) * lim
        params.append({"w": w.to(device),
                       "b": torch.zeros((sizes[i + 1],), device=device)})
    return params


def _mlp(params, x):
    for i, layer in enumerate(params):
        x = torch.addmm(layer["b"], x, layer["w"])
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def _actor_out(actor, obs, act_dim):
    out = _mlp(actor, obs)
    mu, log_std = out[:, :act_dim], out[:, act_dim:]
    return mu, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)


def _sample_action(actor, obs, eps, act_dim, scale):
    """Squashed-Gaussian action for the standard normal ``eps`` + its log
    prob (with tanh correction)."""
    mu, log_std = _actor_out(actor, obs, act_dim)
    pre = mu + torch.exp(log_std) * eps
    a = torch.tanh(pre)
    # log N(pre; mu, std) - sum log(1 - tanh^2) (change of variables);
    # the numerically-stable tanh-correction form from the SAC paper.
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
        - 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre)),
        dim=-1)
    return a * scale, logp


def _q_forward(critic, obs, act):
    return _mlp(critic, torch.cat([obs, act], dim=-1))[:, 0]


def continuous_device_batch(batch, act_dim: int, device
                            ) -> Dict[str, torch.Tensor]:
    """The columns SAC's and TD3's updates read, on ``device``: f32, the
    actions as ``[B, act_dim]``, the dones bool."""
    n = len(batch[OBS])
    return to_tensors({
        OBS: np.asarray(batch[OBS], np.float32),
        NEXT_OBS: np.asarray(batch[NEXT_OBS], np.float32),
        ACTIONS: np.asarray(batch[ACTIONS], np.float32).reshape(n, act_dim),
        REWARDS: np.asarray(batch[REWARDS], np.float32),
        DONES: np.asarray(batch[DONES], bool)}, device)


def polyak(target, online, tau: float):
    """``(1 - tau) * target + tau * online``, leaf by leaf."""
    return tree_unflatten(target, [(1 - tau) * t + tau * o for t, o in zip(
        tree_leaves(target), tree_leaves(online))])


class SACPolicy(TorchPolicy):
    replay_style = True

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        if action_space.kind != "box":
            raise ValueError("SAC requires a continuous (box) action space")
        self._setup(action_space, config, seed)
        act_dim = int(np.prod(action_space.shape)) or 1
        self.act_dim = act_dim
        self.act_scale = float(action_space.high)
        hid = tuple(config.get("hiddens", (64, 64)))
        gen, dev = self._init_gen, self.device
        actor = _mlp_init(gen, (obs_dim,) + hid + (2 * act_dim,), dev)
        q1 = _mlp_init(gen, (obs_dim + act_dim,) + hid + (1,), dev)
        q2 = _mlp_init(gen, (obs_dim + act_dim,) + hid + (1,), dev)
        log_alpha = torch.log(torch.tensor(
            config.get("initial_alpha", 0.1), dtype=torch.float32)).to(dev)
        self.params = {"actor": actor, "q1": q1, "q2": q2,
                       "log_alpha": log_alpha}
        # Params are replaced, never changed in place: the targets start
        # as the critics' tensors of their time.
        self.target = {"q1": q1, "q2": q2}
        self._opt = {
            "actor": OptaxAdam(tree_leaves(actor),
                               config.get("actor_lr", 3e-4)),
            "critic": OptaxAdam(tree_leaves({"q1": q1, "q2": q2}),
                                config.get("critic_lr", 3e-4)),
            "alpha": OptaxAdam([log_alpha], config.get("alpha_lr", 3e-4)),
        }
        self._noise_gen = torch.Generator().manual_seed(seed + 7)
        self._gamma = config.get("gamma", 0.99)
        self._tau = config.get("tau", 0.005)
        self._target_entropy = -float(act_dim)

    # -- rollout side -----------------------------------------------------

    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        x = self._obs(obs)
        eps = torch.randn((x.shape[0], self.act_dim),
                          generator=self._act_gen, device=self.device)
        a, _ = _sample_action(self.params["actor"], x, eps, self.act_dim,
                              self.act_scale)
        return {ACTIONS: a.cpu().numpy().astype(np.float32)}

    # -- learner side -----------------------------------------------------

    def draw_noise(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(eps_next, eps_cur), standard normals ``[n, act_dim]`` from the
        policy's CPU generator."""
        return tuple(torch.randn((n, self.act_dim), generator=self._noise_gen)
                     for _ in range(2))

    def _update(self, b, eps_next, eps_cur):
        """One SAC step on device batch ``b``; publishes the new params
        and targets, returns (stats, grads shaped like the params)."""
        p, gamma = self.params, self._gamma
        act_dim, scale = self.act_dim, self.act_scale
        alpha = torch.exp(p["log_alpha"])
        # -- critic update (soft Bellman backup on twin mins)
        with torch.no_grad():
            a_next, logp_next = _sample_action(p["actor"], b[NEXT_OBS],
                                               eps_next, act_dim, scale)
            qn = torch.minimum(
                _q_forward(self.target["q1"], b[NEXT_OBS], a_next),
                _q_forward(self.target["q2"], b[NEXT_OBS], a_next))
            backup = b[REWARDS] + gamma * (
                1.0 - b[DONES].to(torch.float32)) * (qn - alpha * logp_next)

        def critic_loss(qs):
            l1 = torch.mean((_q_forward(qs["q1"], b[OBS], b[ACTIONS])
                             - backup) ** 2)
            l2 = torch.mean((_q_forward(qs["q2"], b[OBS], b[ACTIONS])
                             - backup) ** 2)
            total = l1 + l2
            return total, {"critic_loss": total}

        qs = {"q1": p["q1"], "q2": p["q2"]}
        cstats, cgrads = value_and_grad(critic_loss, qs)
        qs = tree_unflatten(qs, self._opt["critic"].step(tree_leaves(qs),
                                                         cgrads))

        # -- actor update (against the UPDATED critics)
        def actor_loss(actor):
            a, logp = _sample_action(actor, b[OBS], eps_cur, act_dim, scale)
            q = torch.minimum(_q_forward(qs["q1"], b[OBS], a),
                              _q_forward(qs["q2"], b[OBS], a))
            loss = torch.mean(alpha * logp - q)
            return loss, {"actor_loss": loss, "logp": logp}

        astats, agrads = value_and_grad(actor_loss, p["actor"])
        actor = tree_unflatten(p["actor"], self._opt["actor"].step(
            tree_leaves(p["actor"]), agrads))

        # -- temperature update (match target entropy)
        logp = astats.pop("logp")

        def alpha_loss(log_alpha):
            loss = -torch.mean(torch.exp(log_alpha)
                               * (logp + self._target_entropy))
            return loss, {}

        _, lgrads = value_and_grad(alpha_loss, p["log_alpha"])
        log_alpha = self._opt["alpha"].step([p["log_alpha"]], lgrads)[0]

        # -- polyak target move
        self.target = polyak(self.target, qs, self._tau)
        self.params = {"actor": actor, "q1": qs["q1"], "q2": qs["q2"],
                       "log_alpha": log_alpha}
        stats = {**cstats, **astats, "alpha": torch.exp(log_alpha),
                 "entropy": -torch.mean(logp)}
        grads = {"actor": tree_unflatten(p["actor"], agrads),
                 **tree_unflatten({"q1": p["q1"], "q2": p["q2"]}, cgrads),
                 "log_alpha": lgrads[0]}
        return stats, grads

    def _learn(self, batch, noise):
        b = continuous_device_batch(batch, self.act_dim, self.device)
        if noise is None:
            noise = self.draw_noise(len(batch[OBS]))
        return self._update(b, *(n.to(self.device) for n in noise))

    def learn_on_batch(self, batch: SampleBatch,
                       noise: Optional[Tuple[Any, Any]] = None
                       ) -> Dict[str, float]:
        """One update; ``noise`` = (eps_next, eps_cur) overrides the
        policy's own draws."""
        stats, _ = self._learn(batch, noise)
        return stats_to_floats(stats)

    def learn_with_grads(self, batch: SampleBatch, noise
                         ) -> Tuple[Dict[str, float], Dict]:
        """``learn_on_batch(batch, noise)`` that also returns the step's
        grads (numpy, shaped like the params), for holding one device's
        update against another's."""
        stats, grads = self._learn(batch, noise)
        return stats_to_floats(stats), tree_to_numpy(grads)

    def update_target(self):
        pass  # polyak-averaged inside every update


class SAC(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "sac")
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
        # Same result schema as DQN/IMPALA/MultiAgentPPO: learner stats
        # nest under info.learner (flat copies kept for convenience).
        return {"info": {"learner": stats}, **stats}

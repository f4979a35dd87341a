"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing.

Port of ``ray_tpu/rllib/qmix.py``.  Design analog: reference
``rllib/algorithms/qmix/qmix.py`` + ``qmix_policy.py`` (per-agent Q
networks whose chosen-action values feed a monotonic mixing network
conditioned on the global state; TD targets through a target mixer;
episode replay).  The update (per-agent Q forward, hypernetwork mixer,
double-Q targets, huber loss, one Adam over the leaves of ``(q_params,
m_params)``) runs on the trainer's device (``config["device"]``: None is
the first card, raising without one); the mixer enforces monotonicity
with ``abs()`` on hypernetwork weights so ``argmax_a Q_i`` = argmax of
``Q_tot`` per agent (the factorization QMIX is built on).  Exploration
and the replay buffer stay on numpy generators, as the JAX package's do.

``mixer=`` selects the ablation family the reference exposes as separate
algorithms: "qmix" (state-conditioned hypernetwork), "vdn" (plain sum,
reference VDN), "none" (independent Q-learning — each agent treats the
team reward as its own).  One implementation, three credit-assignment
semantics, which is what the two-step-game learning test discriminates.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, learner_cards
from ray_tpu_torch.rllib.multi_agent import MA_ENV_REGISTRY
from ray_tpu_torch.rllib.policy import (OptaxAdam, to_tensors, tree_leaves,
                                        tree_to_numpy, tree_unflatten,
                                        value_and_grad, weights_from_jax)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.tune.trainable import Trainable

_COLUMNS = ("obs", "actions", "rewards", "dones", "state", "next_obs",
            "next_state")


class QMIXConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(QMIX)
        self._config.update({
            "mixer": "qmix",             # "qmix" | "vdn" | "none"
            "hiddens": (64,),
            "mixing_embed_dim": 32,
            "lr": 5e-4,
            "gamma": 0.99,
            "train_batch_size": 64,
            "buffer_size": 5000,
            "learning_starts": 64,
            "target_network_update_freq": 100,   # updates
            "epsilon_initial": 1.0,
            "epsilon_final": 0.05,
            "epsilon_timesteps": 4000,
            "num_train_iters": 4,
            "double_q": True,
        })


def _mlp_init(gen: torch.Generator, sizes, device="cpu"):
    """He-normal layers, drawn on the CPU from ``gen``."""
    return [{"w": (torch.randn((sizes[i], sizes[i + 1]), generator=gen)
                   * float(np.sqrt(2.0 / sizes[i]))).to(device),
             "b": torch.zeros((sizes[i + 1],), device=device)}
            for i in range(len(sizes) - 1)]


def _mlp(params, x, final_linear=True):
    for i, p in enumerate(params):
        x = torch.addmm(p["b"], x, p["w"])
        if i < len(params) - 1 or not final_linear:
            x = torch.relu(x)
    return x


def mixer_init(gen: torch.Generator, n_agents: int, state_dim: int,
               embed: int, device="cpu") -> Dict:
    """Hypernetworks mapping global state -> mixing weights/biases
    (reference qmix_policy.QMixer)."""
    return {
        "hyper_w1": _mlp_init(gen, (state_dim, 64, n_agents * embed), device),
        "hyper_b1": _mlp_init(gen, (state_dim, embed), device),
        "hyper_w2": _mlp_init(gen, (state_dim, 64, embed), device),
        "hyper_v": _mlp_init(gen, (state_dim, 64, 1), device),
    }


def mix(mparams: Dict, agent_qs: torch.Tensor,
        state: torch.Tensor) -> torch.Tensor:
    """agent_qs [B, n] + state [B, S] -> Q_tot [B].  abs() on the
    hypernetwork outputs keeps dQ_tot/dQ_i >= 0 (monotonicity)."""
    B, n = agent_qs.shape
    embed = mparams["hyper_b1"][-1]["b"].shape[0]
    w1 = torch.abs(_mlp(mparams["hyper_w1"], state)).reshape(B, n, embed)
    b1 = _mlp(mparams["hyper_b1"], state)
    h = F.elu(torch.einsum("bn,bne->be", agent_qs, w1) + b1)
    w2 = torch.abs(_mlp(mparams["hyper_w2"], state))
    v = _mlp(mparams["hyper_v"], state)[:, 0]
    return torch.sum(h * w2, dim=-1) + v


def _huber(td: torch.Tensor) -> torch.Tensor:
    abs_td = torch.abs(td)
    return torch.mean(torch.where(abs_td < 1.0, 0.5 * td * td,
                                  abs_td - 0.5))


class QMIX(Trainable):
    """Episode-driving trainer for the mixing family (qmix/vdn/none)."""

    def setup(self, config: Dict[str, Any]) -> None:
        self.config = c = config
        self.device = resolve_device(c.get("device"))
        env_name = c["env"]
        self.env = MA_ENV_REGISTRY[env_name](**c.get("env_config", {}))
        self.agents = list(self.env.agents)
        n = len(self.agents)
        obs_dim = int(np.prod(self.env.observation_space.shape))
        self.n_actions = self.env.action_space.n
        state_fn = getattr(self.env, "state", None)
        self._state_dim = (len(state_fn()) if state_fn is not None
                           else obs_dim * n)
        gen = torch.Generator().manual_seed(c.get("seed", 0))
        hid = tuple(c.get("hiddens", (64,)))
        self.q_params = _mlp_init(
            gen, (obs_dim,) + hid + (self.n_actions,), self.device)
        self.mixer_kind = c.get("mixer", "qmix")
        self.m_params = mixer_init(
            gen, n, self._state_dim, c.get("mixing_embed_dim", 32),
            self.device) if self.mixer_kind == "qmix" else {}
        # Params are replaced, never changed in place: a target holds
        # the tensors of its time.
        self.t_q, self.t_m = self.q_params, self.m_params
        self._opt = OptaxAdam(tree_leaves((self.q_params, self.m_params)),
                              c.get("lr", 5e-4))
        self._gamma = c.get("gamma", 0.99)
        self._double_q = c.get("double_q", True)
        self._buffer = ReplayBuffer(capacity=c.get("buffer_size", 5000),
                                    seed=c.get("seed", 0))
        self._steps = 0
        self._updates = 0
        self._episode_rewards: List[float] = []
        self._np_rng = np.random.default_rng(c.get("seed", 0))

    # -- networks ---------------------------------------------------------

    def _q_all(self, qp, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, n, O] -> [B, n, A]."""
        B, n = obs.shape[:2]
        return _mlp(qp, obs.reshape(B * n, -1)).reshape(B, n, self.n_actions)

    def _total(self, mp, qs, state):
        if self.mixer_kind == "qmix":
            return mix(mp, qs, state)
        return torch.sum(qs, dim=-1)   # vdn; "none" never calls this

    def _loss(self, params, batch):
        qp, mp = params
        qs = self._q_all(qp, batch["obs"])
        chosen = torch.gather(qs, -1, batch["actions"][..., None])[..., 0]
        with torch.no_grad():
            tq = self._q_all(self.t_q, batch["next_obs"])
            if self._double_q:
                sel = torch.argmax(self._q_all(qp, batch["next_obs"]),
                                   dim=-1)
            else:
                sel = torch.argmax(tq, dim=-1)
            tgt_q = torch.gather(tq, -1, sel[..., None])[..., 0]
            notdone = 1.0 - batch["dones"].to(torch.float32)
            if self.mixer_kind == "none":
                # independent Q-learning: per-agent TD on team reward
                y = batch["rewards"][:, None] \
                    + self._gamma * notdone[:, None] * tgt_q
            else:
                y = batch["rewards"] + self._gamma * notdone * self._total(
                    self.t_m, tgt_q, batch["next_state"])
        if self.mixer_kind == "none":
            td = chosen - y
        else:
            td = self._total(mp, chosen, batch["state"]) - y
        loss = _huber(td)
        return loss, {"loss": loss}

    def loss_and_grads(self, batch) -> tuple:
        """The loss and grads (numpy ``(q, m)`` tree) of the update
        ``_update(batch)`` would make; changes nothing."""
        stats, grads = value_and_grad(
            lambda p: self._loss(p, batch), (self.q_params, self.m_params))
        return float(stats["loss"]), tree_to_numpy(
            tree_unflatten((self.q_params, self.m_params), grads))

    def _update(self, batch) -> torch.Tensor:
        """One Adam step on a device batch; returns the loss (on the
        device)."""
        params = (self.q_params, self.m_params)
        stats, grads = value_and_grad(lambda p: self._loss(p, batch), params)
        self.q_params, self.m_params = tree_unflatten(
            params, self._opt.step(tree_leaves(params), grads))
        return stats["loss"]

    @torch.no_grad()
    def _greedy(self, qp, obs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        return torch.argmax(self._q_all(qp, x[None])[0], dim=-1).cpu().numpy()

    # -- rollout ----------------------------------------------------------

    def _global_state(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        fn = getattr(self.env, "state", None)
        if fn is not None:
            return np.asarray(fn(), np.float32)
        return np.concatenate([obs[a].ravel() for a in self.agents])

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._steps / max(1, c.get("epsilon_timesteps",
                                                   4000)))
        return c.get("epsilon_initial", 1.0) + frac * (
            c.get("epsilon_final", 0.05)
            - c.get("epsilon_initial", 1.0))

    def _run_episode(self) -> float:
        obs = self.env.reset()
        state = self._global_state(obs)
        total = 0.0
        done = False
        while not done:
            eps = self._epsilon()
            stacked = np.stack([obs[a] for a in self.agents])
            greedy = self._greedy(self.q_params, stacked)
            acts = {}
            for i, a in enumerate(self.agents):
                if self._np_rng.random() < eps:
                    acts[a] = int(self._np_rng.integers(self.n_actions))
                else:
                    acts[a] = int(greedy[i])
            nobs, rewards, dones, _ = self.env.step(acts)
            nstate = self._global_state(nobs)
            done = dones["__all__"]
            r = float(rewards[self.agents[0]])   # shared team reward
            self._buffer.add(SampleBatch({
                "obs": stacked[None],
                "actions": np.asarray([acts[a] for a in self.agents],
                                      np.int32)[None],
                "rewards": np.asarray([r], np.float32),
                "dones": np.asarray([done]),
                "state": state[None],
                "next_obs": np.stack([nobs[a]
                                      for a in self.agents])[None],
                "next_state": nstate[None],
            }))
            total += r
            obs, state = nobs, nstate
            self._steps += 1
        return total

    # -- training ---------------------------------------------------------

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A buffer sample's columns on the device; actions as int64
        indices."""
        cols = {k: np.asarray(batch[k]) for k in _COLUMNS}
        cols["actions"] = cols["actions"].astype(np.int64)
        return to_tensors(cols, self.device)

    def _sample_batch(self) -> Dict[str, torch.Tensor]:
        return self.device_batch(self._buffer.sample(
            self.config.get("train_batch_size", 64)))

    def step(self) -> Dict[str, Any]:
        c = self.config
        for _ in range(8):
            self._episode_rewards.append(self._run_episode())
        self._episode_rewards = self._episode_rewards[-100:]
        loss = float("nan")
        if len(self._buffer) >= c.get("learning_starts", 64):
            for _ in range(c.get("num_train_iters", 4)):
                loss = float(self._update(self._sample_batch()))
                self._updates += 1
                if self._updates % c.get("target_network_update_freq",
                                         100) == 0:
                    self.t_q, self.t_m = self.q_params, self.m_params
        return {
            "episode_reward_mean": float(np.mean(self._episode_rewards)),
            "loss": loss,
            "num_env_steps_sampled": self._steps,
        }

    def greedy_episode_reward(self) -> float:
        """One epsilon-0 episode (evaluation)."""
        obs = self.env.reset()
        total, done = 0.0, False
        while not done:
            stacked = np.stack([obs[a] for a in self.agents])
            greedy = self._greedy(self.q_params, stacked)
            acts = {a: int(greedy[i])
                    for i, a in enumerate(self.agents)}
            obs, rewards, dones, _ = self.env.step(acts)
            total += float(rewards[self.agents[0]])
            done = dones["__all__"]
        return total

    def save_checkpoint(self) -> Dict[str, Any]:
        return {"q": tree_to_numpy(self.q_params),
                "m": tree_to_numpy(self.m_params),
                "steps": self._steps}

    def load_checkpoint(self, ckpt) -> None:
        self.q_params = weights_from_jax(ckpt["q"], self.device,
                                         like=self.q_params)
        self.m_params = weights_from_jax(ckpt["m"], self.device,
                                         like=self.m_params)
        self.t_q, self.t_m = self.q_params, self.m_params
        self._steps = ckpt.get("steps", 0)

    @classmethod
    def default_resource_request(cls, config: Dict[str, Any]
                                 ) -> Dict[str, float]:
        """One CPU, and the card the networks run on unless the config
        puts them on the CPU."""
        return {"CPU": 1.0, **learner_cards(config)}

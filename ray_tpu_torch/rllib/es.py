"""ES: OpenAI-style evolution strategies.

Port of ``ray_tpu/rllib/es.py``, copied (numpy on host actors; the port's
runtime carries the broadcast).

Design analog: reference ``rllib/algorithms/es/es.py`` (shared noise
table, antithetic perturbation rollouts on remote workers, centered-rank
fitness shaping).  The distributed shape is distinct from every
gradient-based algorithm here: workers never see gradients — the learner
broadcasts flat parameters, each worker evaluates theta +/- sigma*eps for
noise it reconstructs from integer seeds, and only (seed, return) pairs
travel back, so the wire cost per rollout is a few floats regardless of
model size.  The perturbed-parameter evaluation batch is pure numpy on
host CPU actors (tiny MLPs; launch overhead would dominate), while
the framework's object store / actor plumbing carries the broadcast.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_vector_env


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(ES)
        self._config.update({
            "num_rollout_workers": 2,
            "episodes_per_worker": 8,    # antithetic PAIRS per worker/step
            "sigma": 0.05,               # perturbation stddev
            "lr": 0.03,
            "l2_coeff": 0.005,
            "hiddens": (32, 32),
            "episode_horizon": 500,
        })


def _mlp_shapes(obs_dim: int, hiddens, num_actions: int) -> List[tuple]:
    sizes = (obs_dim,) + tuple(hiddens) + (num_actions,)
    shapes = []
    for i in range(len(sizes) - 1):
        shapes.append((sizes[i], sizes[i + 1]))
        shapes.append((sizes[i + 1],))
    return shapes


def _unflatten(theta: np.ndarray, shapes: List[tuple]) -> List[np.ndarray]:
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(theta[off:off + n].reshape(s))
        off += n
    return out


def _policy_act(layers: List[np.ndarray], obs: np.ndarray) -> np.ndarray:
    """Deterministic greedy MLP forward over a [N, obs_dim] batch."""
    x = obs
    for i in range(0, len(layers) - 2, 2):
        x = np.tanh(x @ layers[i] + layers[i + 1])
    logits = x @ layers[-2] + layers[-1]
    return np.argmax(logits, axis=-1)


class ESEvalWorker:
    """Evaluates antithetic perturbations of a flat parameter vector.

    Noise is reconstructed locally from integer seeds (the shared-noise-
    table idea without the table: default_rng(seed) IS the shared source),
    so the result message is (seeds, returns+, returns-, steps) only.
    """

    def __init__(self, config: Dict[str, Any], worker_index: int):
        self.config = config
        self.env = make_vector_env(config["env"], 1,
                                   seed=1000 * worker_index,
                                   **config.get("env_config", {}))
        obs_dim = int(np.prod(self.env.observation_space.shape))
        self.shapes = _mlp_shapes(obs_dim,
                                  tuple(config.get("hiddens", (32, 32))),
                                  self.env.action_space.n)
        self.horizon = config.get("episode_horizon", 500)
        self._episode_seed = worker_index * 7919

    def ping(self) -> bool:
        return True

    def _episode_return(self, theta: np.ndarray) -> tuple:
        layers = _unflatten(theta, self.shapes)
        self._episode_seed += 1
        obs = self.env.vector_reset(seed=self._episode_seed)
        total, steps = 0.0, 0
        for _ in range(self.horizon):
            a = _policy_act(layers, np.asarray(obs, np.float32))
            obs, rew, done, _ = self.env.vector_step(a)
            total += float(rew[0])
            steps += 1
            if bool(done[0]):
                break
        return total, steps

    def evaluate(self, theta_ref, seeds: List[int], sigma: float) -> Dict:
        theta = np.asarray(theta_ref, np.float32)
        pos, neg, steps = [], [], 0
        for seed in seeds:
            eps = np.random.default_rng(seed).standard_normal(
                theta.shape[0]).astype(np.float32)
            r_pos, s1 = self._episode_return(theta + sigma * eps)
            r_neg, s2 = self._episode_return(theta - sigma * eps)
            pos.append(r_pos)
            neg.append(r_neg)
            steps += s1 + s2
        return {"seeds": list(seeds), "pos": pos, "neg": neg,
                "steps": steps}


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: map returns to [-0.5, 0.5] by rank (reference
    es.py compute_centered_ranks) — scale-free, outlier-immune."""
    ranks = np.empty(x.size, dtype=np.float32)
    ranks[x.ravel().argsort()] = np.arange(x.size, dtype=np.float32)
    return (ranks / (x.size - 1) - 0.5).reshape(x.shape)


class ES(Algorithm):
    """Gradient-free learner: broadcast theta, collect ranked antithetic
    returns, ascend sum_i rank_i * eps_i."""

    # The learner is numpy on the host: a trial asks for no card.
    learner_on_device = False

    def setup(self, config: Dict[str, Any]) -> None:
        # No WorkerSet/policy machinery: ES has its own worker protocol.
        env = make_vector_env(config["env"], 1,
                              **config.get("env_config", {}))
        obs_dim = int(np.prod(env.observation_space.shape))
        self.shapes = _mlp_shapes(obs_dim,
                                  tuple(config.get("hiddens", (32, 32))),
                                  env.action_space.n)
        n = sum(int(np.prod(s)) for s in self.shapes)
        rng = np.random.default_rng(config.get("seed", 0))
        # Small init; the search distribution provides exploration.
        self.theta = (0.1 * rng.standard_normal(n)).astype(np.float32)
        self._rng = rng
        self._velocity = np.zeros_like(self.theta)   # momentum-SGD
        cls = ray_tpu_torch.remote(num_cpus=1)(ESEvalWorker)
        self.workers_es = [
            cls.remote(config, i + 1)
            for i in range(config.get("num_rollout_workers", 2))]
        ray_tpu_torch.get([w.ping.remote() for w in self.workers_es],
                          timeout=120.0)
        self._timesteps_total = 0
        self._reward_history: List[float] = []

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        sigma = c.get("sigma", 0.05)
        pairs = c.get("episodes_per_worker", 8)
        theta_ref = ray_tpu_torch.put(self.theta)
        seed_base = int(self._rng.integers(0, 2 ** 31 - 1))
        refs, all_seeds = [], []
        for i, w in enumerate(self.workers_es):
            seeds = [seed_base + i * pairs + j for j in range(pairs)]
            all_seeds.extend(seeds)
            refs.append(w.evaluate.remote(theta_ref, seeds, sigma))
        results = ray_tpu_torch.get(refs, timeout=600.0)

        seeds, pos, neg = [], [], []
        for r in results:
            seeds.extend(r["seeds"])
            pos.extend(r["pos"])
            neg.extend(r["neg"])
            self._timesteps_total += r["steps"]
        pos, neg = np.asarray(pos, np.float32), np.asarray(neg, np.float32)
        ranks = _centered_ranks(np.stack([pos, neg], axis=1))
        weights = ranks[:, 0] - ranks[:, 1]   # antithetic pairing

        grad = np.zeros_like(self.theta)
        for w_i, seed in zip(weights, seeds):
            eps = np.random.default_rng(seed).standard_normal(
                self.theta.shape[0]).astype(np.float32)
            grad += w_i * eps
        grad /= (len(seeds) * sigma)
        grad -= c.get("l2_coeff", 0.005) * self.theta
        self._velocity = (0.9 * self._velocity
                          + c.get("lr", 0.03) * grad)
        self.theta = self.theta + self._velocity

        mean_reward = float(np.mean(np.concatenate([pos, neg])))
        self._reward_history.append(mean_reward)
        return {
            "episode_reward_mean": mean_reward,
            "episode_reward_max": float(np.max(np.concatenate([pos, neg]))),
            "num_env_steps_sampled": self._timesteps_total,
            "info": {"learner": {"grad_norm": float(np.linalg.norm(grad)),
                                 "theta_norm": float(
                                     np.linalg.norm(self.theta))}},
        }

    def step(self) -> Dict[str, Any]:
        return self.training_step()

    # -- Trainable contract ----------------------------------------------
    def save_checkpoint(self) -> Dict[str, Any]:
        return {"theta": self.theta, "velocity": self._velocity,
                "timesteps": self._timesteps_total}

    def load_checkpoint(self, checkpoint) -> None:
        if not checkpoint:
            return
        self.theta = np.asarray(checkpoint["theta"], np.float32)
        self._velocity = np.asarray(checkpoint["velocity"], np.float32)
        self._timesteps_total = checkpoint.get("timesteps", 0)

    def cleanup(self) -> None:
        for w in self.workers_es:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass

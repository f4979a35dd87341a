"""Exploration modules: parameter-space noise and RND curiosity.

Port of ``ray_tpu/rllib/exploration.py``.  Design analog: reference
``rllib/utils/exploration/`` — ``parameter_noise.py`` (Plappert et al.
2018: perturb the policy's weights instead of its actions, with the noise
scale adapted so the induced action divergence matches an
epsilon-equivalent target) and ``random_encoder.py``/``curiosity.py``
(intrinsic novelty bonuses; RND, Burda et al. 2018: a fixed random target
network and a trained predictor — prediction error is high exactly on
states never visited).

Each of the JAX package's jitted programs is a pure function of explicit
inputs here plus a wrapper that draws them: ``_perturb(params, noises,
sigma)`` takes one standard normal a leaf (``tree_leaves`` order, which is
``jax.tree.flatten``'s), and ``ParameterNoise.perturb`` draws them from its
own CPU generator, so the same perturbation lands on the CPU and on the
card.  Plugged into the DQN family via config:

    DQNConfig().training(exploration="parameter_noise")
    DQNConfig().training(rnd_coeff=0.5)     # intrinsic reward weight
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.policy import (OptaxAdam, tree_leaves,
                                        tree_unflatten, value_and_grad)


def _perturb(params, noises: Sequence[torch.Tensor], sigma: float):
    """``params`` with ``sigma * noise`` added to each leaf (one standard
    normal tensor a leaf, in ``tree_leaves`` order)."""
    return tree_unflatten(params, [p + sigma * n for p, n in
                                   zip(tree_leaves(params), noises)])


class ParameterNoise:
    """Adaptive parameter-space noise for a Q-network.

    Keeps a perturbed copy of the policy params for acting; after each
    re-perturbation the noise scale adapts toward ``target_divergence``
    (the fraction of states whose greedy action changed — the
    epsilon-equivalent distance of the DQN parameter-noise paper).
    """

    def __init__(self, seed: int = 0, initial_sigma: float = 0.05,
                 target_divergence: float = 0.1,
                 adapt_factor: float = 1.01):
        self.sigma = float(initial_sigma)
        self.target = float(target_divergence)
        self.adapt = float(adapt_factor)
        self._gen = torch.Generator().manual_seed(seed ^ 0x5eed)

    def perturb(self, params):
        """Fresh perturbed copy of ``params`` at the current sigma: one
        standard normal a leaf, drawn on the CPU, moved to the leaf's
        device."""
        noises = [torch.randn(tuple(p.shape), generator=self._gen).to(
            p.device) for p in tree_leaves(params)]
        return _perturb(params, noises, self.sigma)

    def adapt_sigma(self, clean_actions: np.ndarray,
                    noisy_actions: np.ndarray) -> float:
        """Grow sigma while the perturbed policy acts like the clean one,
        shrink it when the action divergence overshoots the target."""
        div = float(np.mean(np.asarray(clean_actions)
                            != np.asarray(noisy_actions)))
        if div < self.target:
            self.sigma *= self.adapt
        else:
            self.sigma /= self.adapt
        return self.sigma


def _mlp_init(gen: torch.Generator, sizes, device="cpu"):
    """He-normal layers, drawn on the CPU from ``gen``."""
    return [{"w": (torch.randn((sizes[i], sizes[i + 1]), generator=gen)
                   * float(np.sqrt(2.0 / sizes[i]))).to(device),
             "b": torch.zeros((sizes[i + 1],), device=device)}
            for i in range(len(sizes) - 1)]


def _mlp(params, x):
    for i, p in enumerate(params):
        x = torch.addmm(p["b"], x, p["w"])
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def _errors(pred, target, obs: torch.Tensor) -> torch.Tensor:
    """Per-row mean squared distance of the predictor's embedding from
    the target's (image obs flatten)."""
    obs = obs.reshape(obs.shape[0], -1)
    e = _mlp(pred, obs) - _mlp(target, obs)
    return torch.mean(e * e, dim=-1)


class RNDCuriosity:
    """Random Network Distillation intrinsic reward.

    A FIXED random target embedding f(s) and a trained predictor g(s);
    intrinsic reward is ||g(s) - f(s)||^2, normalized by a running std so
    the bonus scale is stationary as the predictor catches up.  The
    networks live on ``device`` (None: the first card, raising without
    one; the DQN policy passes its own).
    """

    def __init__(self, obs_dim: int, seed: int = 0, embed: int = 32,
                 lr: float = 1e-3, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed ^ 0xc0de)
        self.target = _mlp_init(gen, (obs_dim, 64, embed), self.device)
        self.predictor = _mlp_init(gen, (obs_dim, 64, embed), self.device)
        self._opt = OptaxAdam(tree_leaves(self.predictor), lr)
        # running SECOND MOMENT of raw errors — per-batch variance would
        # collapse to ~0 on homogeneous batches (all next-obs identical
        # early in a sparse env) and blow the bonus up by 1/sqrt(eps)
        self._running_sq = 1.0
        self._count = 1e-4

    def _obs(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    def _normalize(self, err: np.ndarray) -> np.ndarray:
        # RMS normalization: typical bonus is O(1), novel states larger.
        # (A running moment over BATCH MEANS stays well-conditioned even
        # when individual batches are homogeneous.)
        self._count += 1
        self._running_sq += (float(np.mean(err * err)) + 1e-12
                             - self._running_sq) / min(self._count, 100.0)
        return err / (self._running_sq ** 0.5 + 1e-8)

    def intrinsic(self, obs: np.ndarray) -> np.ndarray:
        """Normalized novelty bonus (read-only; see intrinsic_and_train
        for the learner-path variant)."""
        with torch.no_grad():
            err = _errors(self.predictor, self.target, self._obs(obs))
        return self._normalize(err.cpu().numpy())

    def intrinsic_and_train(self, obs: np.ndarray) -> np.ndarray:
        """Errors from the CURRENT predictor + its Adam step, one pass
        (the hot learner path: one copy in, one copy of the errors out)."""
        x = self._obs(obs)

        def loss_fn(pred):
            per_row = _errors(pred, self.target, x)
            return torch.mean(per_row), {"per_row": per_row}

        stats, grads = value_and_grad(loss_fn, self.predictor)
        self.predictor = tree_unflatten(self.predictor, self._opt.step(
            tree_leaves(self.predictor), grads))
        return self._normalize(stats["per_row"].cpu().numpy())

    def train(self, obs: np.ndarray) -> float:
        return float(np.mean(self.intrinsic_and_train(obs)))

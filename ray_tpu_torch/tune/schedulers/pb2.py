"""PB2: Population Based Bandits — PBT with a GP-bandit explore step.

Port of ``ray_tpu/tune/schedulers/pb2.py``. Design analog: reference
``python/ray/tune/schedulers/pb2.py`` (wraps GPy): instead of PBT's random
1.2x/0.8x perturbation, fit a GP to (hyperparameters -> reward improvement)
observations from the whole population and pick the exploring trial's new
config by maximizing a UCB acquisition. Implemented numpy-only (same GP core
idea as search/bayesopt.py). Falls back to PBT-style perturbation until
enough observations exist.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining
from ray_tpu_torch.tune.search.sample import Domain, Float, Integer


class PB2(PopulationBasedTraining):
    def __init__(self, *args, ucb_kappa: float = 1.5,
                 min_observations: int = 4, n_candidates: int = 128,
                 length_scale: float = 0.3, **kwargs):
        super().__init__(*args, **kwargs)
        self._kappa = ucb_kappa
        self._min_obs = min_observations
        self._n_cand = n_candidates
        self._ls = length_scale
        self._np_rng = np.random.RandomState(kwargs.get("seed"))
        # (normalized hyperparam vector, reward delta) observations.
        self._obs: List[Tuple[np.ndarray, float]] = []
        self._last_score: Dict[str, float] = {}

    # Continuous mutation dims in a fixed order.
    def _dims(self):
        return sorted(
            (k, spec) for k, spec in self.mutations.items()
            if isinstance(spec, (Float, Integer)))

    def _encode(self, config: Dict[str, Any]) -> Optional[np.ndarray]:
        dims = self._dims()
        if not dims:
            return None
        out = []
        for k, dom in dims:
            v = config.get(k)
            if not isinstance(v, (int, float)):
                return None
            lo, hi = float(dom.lower), float(dom.upper)
            if getattr(dom, "log", False):
                u = (math.log(max(v, lo)) - math.log(lo)) / \
                    (math.log(hi) - math.log(lo))
            else:
                u = (v - lo) / (hi - lo)
            out.append(min(1.0, max(0.0, u)))
        return np.array(out)

    def _decode(self, u: np.ndarray) -> Dict[str, Any]:
        cfg = {}
        for (k, dom), x in zip(self._dims(), u):
            lo, hi = float(dom.lower), float(dom.upper)
            if getattr(dom, "log", False):
                v = math.exp(math.log(lo) + float(x) *
                             (math.log(hi) - math.log(lo)))
            else:
                v = lo + float(x) * (hi - lo)
            if isinstance(dom, Integer):
                v = max(dom.lower, min(dom.upper - 1, int(round(v))))
            cfg[k] = v
        return cfg

    def on_trial_result(self, runner, trial, result) -> str:
        # Record reward deltas as bandit observations before the base
        # class potentially wipes the score on exploit.
        if self.metric in result:
            v = self._val(result)
            prev = self._last_score.get(trial.trial_id)
            if prev is not None:
                x = self._encode(trial.config)
                if x is not None:
                    self._obs.append((x, v - prev))
                    if len(self._obs) > 500:
                        self._obs.pop(0)
            self._last_score[trial.trial_id] = v
        return super().on_trial_result(runner, trial, result)

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        dims = self._dims()
        if not dims or len(self._obs) < self._min_obs:
            return super().explore(config)
        new = super().explore(config)   # non-GP keys still PBT-perturbed
        new.update(self._decode(self._ucb_argmax()))
        return new

    def _ucb_argmax(self) -> np.ndarray:
        X = np.stack([x for x, _ in self._obs])
        y = np.array([d for _, d in self._obs])
        sd = y.std() + 1e-12
        yn = (y - y.mean()) / sd

        def k(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / (self._ls ** 2))

        K = k(X, X) + 1e-4 * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        cand = self._np_rng.rand(self._n_cand, X.shape[1])
        Ks = k(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(axis=0), 1e-12, None)
        ucb = mu + self._kappa * np.sqrt(var)
        return cand[int(np.argmax(ucb))]

"""Gaussian-process Bayesian optimization search (native, numpy-only).

Port of ``ray_tpu/tune/search/bayesopt.py``. Design analog: reference
``python/ray/tune/search/bayesopt/`` (wraps the external
`bayesian-optimization` package) — implemented directly here: an RBF-kernel
GP posterior over the normalized continuous dims with an Expected
Improvement acquisition maximized by random multistart. Categorical dims
fall back to the TPE-style frequency model; pure-random until
n_startup_trials observations exist.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search.sample import (Categorical, Domain, Float, Integer,
                                        is_grid)
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.search.tpe import _flatten, _unflatten


class BayesOptSearcher(Searcher):
    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 n_startup_trials: int = 6, n_candidates: int = 256,
                 length_scale: float = 0.2, noise: float = 1e-4,
                 xi: float = 0.01, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._space = _flatten(space) if space else {}
        self._n_startup = n_startup_trials
        self._n_candidates = n_candidates
        self._ls = length_scale
        self._noise = noise
        self._xi = xi
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        self._pending: Dict[str, Dict[tuple, Any]] = {}
        self._done: List[Tuple[Dict[tuple, Any], float]] = []

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        if config and not self._space:
            self._space = _flatten(config)
        return True

    def _numeric_dims(self):
        return [(p, d) for p, d in self._space.items()
                if isinstance(d, (Float, Integer))]

    # -------------------------------------------------------------- encode

    def _to_unit(self, dom, v: float) -> float:
        lo, hi = float(dom.lower), float(dom.upper)
        if getattr(dom, "log", False):
            return (math.log(v) - math.log(lo)) / \
                (math.log(hi) - math.log(lo))
        return (v - lo) / (hi - lo)

    def _from_unit(self, dom, u: float):
        lo, hi = float(dom.lower), float(dom.upper)
        if getattr(dom, "log", False):
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if isinstance(dom, Integer):
            v = max(dom.lower, min(dom.upper - 1, int(round(v))))
        return v

    # ------------------------------------------------------------- suggest

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        dims = self._numeric_dims()
        flat: Dict[tuple, Any] = {}
        for path, dom in self._space.items():
            if not isinstance(dom, Domain):
                flat[path] = dom
            elif not isinstance(dom, (Float, Integer)):
                flat[path] = dom.sample(self._rng)
        if len(self._done) < self._n_startup or not dims:
            for path, dom in dims:
                flat[path] = dom.sample(self._rng)
        else:
            x_best = self._maximize_ei(dims)
            for (path, dom), u in zip(dims, x_best):
                flat[path] = self._from_unit(dom, float(u))
        self._pending[trial_id] = flat
        return _unflatten(flat)

    def on_trial_complete(self, trial_id, result=None, error=False):
        flat = self._pending.pop(trial_id, None)
        if flat is None or error or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        self._done.append((flat, v if self.mode == "max" else -v))

    # ------------------------------------------------------------------ GP

    def _maximize_ei(self, dims) -> np.ndarray:
        X = np.array([[self._to_unit(dom, float(cfg[path]))
                       for path, dom in dims]
                      for cfg, _ in self._done if
                      all(path in cfg for path, _ in dims)])
        y = np.array([v for cfg, v in self._done
                      if all(path in cfg for path, _ in dims)])
        ymu, ysd = y.mean(), y.std() + 1e-12
        yn = (y - ymu) / ysd

        def k(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / (self._ls ** 2))

        K = k(X, X) + self._noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cand = self._np_rng.rand(self._n_candidates, len(dims))
        # Exploit around the incumbent too (local refinement candidates).
        best_x = X[int(np.argmax(yn))]
        local = np.clip(best_x[None, :] + 0.1 *
                        self._np_rng.randn(self._n_candidates // 4,
                                           len(dims)), 0.0, 1.0)
        cand = np.vstack([cand, local])

        Ks = k(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(axis=0), 1e-12, None)
        sd = np.sqrt(var)
        fbest = yn.max()
        z = (mu - fbest - self._xi) / sd
        # Standard-normal pdf/cdf without scipy.
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = (mu - fbest - self._xi) * cdf + sd * pdf
        return cand[int(np.argmax(ei))]

"""Tree-structured Parzen Estimator search (native, numpy-only).

Port of ``ray_tpu/tune/search/tpe.py``. Design analog: reference
``python/ray/tune/search/hyperopt/`` and ``search/optuna/`` — both wrap
external TPE implementations; here TPE is implemented directly (the classic
Bergstra et al. 2011 factorized form): split observations at the
gamma-quantile into good/bad sets, model each dimension with kernel density
estimates l(x) (good) and g(x) (bad), and suggest the candidate maximizing
l(x)/g(x).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search.sample import (Categorical, Domain, Float, Integer,
                                        is_grid)
from ray_tpu_torch.tune.search.searcher import Searcher


def _flatten(space: Dict[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in space.items():
        if isinstance(v, dict) and not is_grid(v):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[tuple, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


class TPESearcher(Searcher):
    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 metric: Optional[str] = None, mode: str = "max",
                 n_startup_trials: int = 8, n_candidates: int = 32,
                 gamma: float = 0.25, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._space = _flatten(space) if space else {}
        self._n_startup = n_startup_trials
        self._n_candidates = n_candidates
        self._gamma = gamma
        self._rng = random.Random(seed)
        self._np_rng = np.random.RandomState(seed)
        # trial_id -> flat config; completed: (flat config, signed metric)
        self._pending: Dict[str, Dict[tuple, Any]] = {}
        self._done: List[Tuple[Dict[tuple, Any], float]] = []

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        if config and not self._space:
            self._space = _flatten(config)
        return True

    # ------------------------------------------------------------- suggest

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        flat = {}
        use_model = len(self._done) >= self._n_startup
        for path, dom in self._space.items():
            if not isinstance(dom, Domain):
                flat[path] = dom                      # constant
            elif use_model and isinstance(dom, (Float, Integer, Categorical)):
                flat[path] = self._suggest_dim(path, dom)
            else:
                flat[path] = dom.sample(self._rng)
        self._pending[trial_id] = flat
        return _unflatten(flat)

    def on_trial_complete(self, trial_id, result=None, error=False):
        flat = self._pending.pop(trial_id, None)
        if flat is None or error or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        self._done.append((flat, v if self.mode == "max" else -v))

    # ---------------------------------------------------------- TPE per dim

    def _split(self):
        """good/bad observation split at the gamma quantile (signed metric,
        larger is better)."""
        ranked = sorted(self._done, key=lambda cv: -cv[1])
        n_good = max(1, int(math.ceil(self._gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_dim(self, path, dom):
        good, bad = self._split()
        gvals = [c[path] for c, _ in good if path in c]
        bvals = [c[path] for c, _ in bad if path in c]
        if not gvals:
            return dom.sample(self._rng)
        if isinstance(dom, Categorical):
            return self._categorical_choice(dom, gvals, bvals)
        return self._numeric_choice(dom, gvals, bvals)

    def _categorical_choice(self, dom, gvals, bvals):
        cats = dom.categories
        # Laplace-smoothed frequency ratio l(c)/g(c).
        lw = np.array([1.0 + sum(1 for v in gvals if v == c) for c in cats])
        gw = np.array([1.0 + sum(1 for v in bvals if v == c) for c in cats])
        score = (lw / lw.sum()) / (gw / gw.sum())
        return cats[int(np.argmax(score))]

    def _numeric_choice(self, dom, gvals, bvals):
        lo, hi = float(dom.lower), float(dom.upper)
        log = getattr(dom, "log", False)
        tf = math.log if log else (lambda x: x)
        inv = math.exp if log else (lambda x: x)
        a, b = tf(lo), tf(hi)
        g = np.array([tf(float(v)) for v in gvals])
        bb = np.array([tf(float(v)) for v in bvals]) if bvals else None
        span = b - a
        bw_g = max(span / max(math.sqrt(len(g)), 1.0), 1e-8 * span + 1e-12)

        # Sample candidates from the good-set mixture, clipped to bounds.
        centers = g[self._np_rng.randint(len(g), size=self._n_candidates)]
        cand = np.clip(centers + self._np_rng.randn(self._n_candidates) *
                       bw_g, a, b)

        def kde(x, pts, bw):
            if pts is None or len(pts) == 0:
                return np.full_like(x, 1.0 / span)
            d = (x[:, None] - pts[None, :]) / bw
            return np.exp(-0.5 * d * d).sum(axis=1) / (len(pts) * bw)

        score = kde(cand, g, bw_g) / (kde(cand, bb, bw_g) + 1e-12)
        best = inv(float(cand[int(np.argmax(score))]))
        if isinstance(dom, Integer):
            q = max(int(getattr(dom, "q", 1) or 1), 1)
            best = int(round(best / q) * q)
            best = max(dom.lower, min(dom.upper - 1, best))
        else:
            if getattr(dom, "q", 0.0):
                best = round(best / dom.q) * dom.q
            best = max(lo, min(hi, best))
        return best

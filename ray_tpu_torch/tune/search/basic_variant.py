"""Grid + random search over a param space.

Port of ``ray_tpu/tune/search/basic_variant.py``. Design analog: reference
``python/ray/tune/search/basic_variant.py`` (BasicVariantGenerator) +
``variant_generator.py`` grid expansion: the cross-product of every
``grid_search`` key, times ``num_samples`` random draws of the Domain keys.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search.sample import Domain, is_grid
from ray_tpu_torch.tune.search.searcher import Searcher


def _grid_paths(space: Dict[str, Any], prefix=()) -> List[tuple]:
    """Collect (path, values) for every grid_search at any nesting depth."""
    out = []
    for k, v in space.items():
        if is_grid(v):
            out.append((prefix + (k,), v["grid_search"]))
        elif isinstance(v, dict):
            out.extend(_grid_paths(v, prefix + (k,)))
    return out


def _deep_copy_dicts(space: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _deep_copy_dicts(v) if isinstance(v, dict) else v
            for k, v in space.items()}


def _set_path(cfg: Dict[str, Any], path: tuple, value: Any):
    for k in path[:-1]:
        cfg = cfg[k]
    cfg[path[-1]] = value


def _expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    grids = _grid_paths(space)
    if not grids:
        return [_deep_copy_dicts(space)]
    axes = [values for _, values in grids]
    out = []
    for combo in itertools.product(*axes):
        cfg = _deep_copy_dicts(space)
        for (path, _), v in zip(grids, combo):
            _set_path(cfg, path, v)
        out.append(cfg)
    return out


def _resolve(cfg: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    out = {}
    for k, v in cfg.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict) and not is_grid(v):
            out[k] = _resolve(v, rng)
        else:
            out[k] = v
    return out


class BasicVariantGenerator(Searcher):
    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 num_samples: int = 1, seed: Optional[int] = None):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._rng = random.Random(seed)
        self._variants: Optional[List[Dict[str, Any]]] = None
        self._idx = 0

    def set_search_properties(self, metric, mode, config):
        if config:
            self._space = config
        self._variants = None
        self._idx = 0
        return super().set_search_properties(metric, mode, config)

    def _materialize(self):
        grids = _expand_grid(self._space)
        self._variants = []
        for _ in range(self._num_samples):
            for g in grids:
                self._variants.append(_resolve(g, self._rng))

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._variants is None:
            self._materialize()
        if self._idx >= len(self._variants):
            return None
        cfg = self._variants[self._idx]
        self._idx += 1
        return cfg

    @property
    def total_suggestions(self) -> int:
        if self._variants is None:
            self._materialize()
        return len(self._variants)

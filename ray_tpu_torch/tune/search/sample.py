"""Search-space primitives.

Port of ``ray_tpu/tune/search/sample.py``. Design analog: reference
``python/ray/tune/search/sample.py`` (Domain / Float / Integer / Categorical
with samplers) and ``tune/search/variant_generator.py`` (grid expansion).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: float = 0.0):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        import math
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False,
                 q: int = 1):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        import math
        if self.log:
            v = int(math.exp(rng.uniform(math.log(self.lower),
                                         math.log(self.upper))))
        else:
            v = rng.randint(self.lower, self.upper - 1)
        v = max(self.lower, min(self.upper - 1, (v // self.q) * self.q))
        return v


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Normal(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None) if self.fn.__code__.co_argcount else self.fn()


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}


def is_grid(spec: Any) -> bool:
    return isinstance(spec, dict) and set(spec.keys()) == {"grid_search"}

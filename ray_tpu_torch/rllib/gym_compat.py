"""Gymnasium/gym interop: wrap external envs into the native VectorEnv.

Port of ``ray_tpu/rllib/gym_compat.py``, copied (numpy only; no gym
import at module level).

Design analog: reference ``rllib/env/vector_env.py`` (``VectorEnv.
vectorize_gym_envs`` wrapping N gym envs behind the vector contract) and
the env-creator registry accepting gym classes.  gym/gymnasium is NOT a
dependency — the wrapper only needs the duck-typed surface
(``reset()/step()``, ``observation_space``/``action_space`` with
``shape``/``n``), so it works with either package when the user has one
installed, and with any object matching the API (the unit tests use a
stub).

Usage::

    from ray_tpu_torch.rllib.gym_compat import GymVectorEnv, register_gym_env
    register_gym_env("MyGym-v0", lambda cfg: gymnasium.make("CartPole-v1"))
    algo = PPOConfig().environment("MyGym-v0").build()
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.env import Space, VectorEnv, register_env


def _convert_space(space) -> Space:
    """gym(nasium) Discrete/Box (duck-typed) -> native Space."""
    n = getattr(space, "n", None)
    if n is not None:
        return Space("discrete", n=int(n))
    shape = tuple(getattr(space, "shape"))
    low = getattr(space, "low", -np.inf)
    high = getattr(space, "high", np.inf)
    low = float(np.min(low)) if np.ndim(low) else float(low)
    high = float(np.max(high)) if np.ndim(high) else float(high)
    return Space("box", shape=shape, low=low, high=high)


def _split_reset(out):
    """gymnasium returns (obs, info); classic gym returns obs."""
    if isinstance(out, tuple) and len(out) == 2 and isinstance(
            out[1], dict):
        return out[0]
    return out


class GymVectorEnv(VectorEnv):
    """N independent gym(nasium) env instances behind the native
    ``VectorEnv`` contract (auto-reset, ``terminal_obs``/``truncated``
    in info — same semantics as the built-in envs)."""

    def __init__(self, env_creator: Callable[[Dict], Any],
                 num_envs: int = 1, seed: int = 0,
                 env_config: Optional[Dict] = None, **kwargs):
        super().__init__(num_envs)
        cfg = dict(env_config or {})
        cfg.update(kwargs)
        self._envs = [env_creator(cfg) for _ in range(num_envs)]
        self._seed = seed
        e0 = self._envs[0]
        self.observation_space = _convert_space(e0.observation_space)
        self.action_space = _convert_space(e0.action_space)

    def _reset_one(self, i: int, seed: Optional[int]) -> np.ndarray:
        env = self._envs[i]
        try:
            out = env.reset(seed=seed)
        except TypeError:   # classic gym: no seed kwarg
            out = env.reset()
        return np.asarray(_split_reset(out), np.float32)

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        base = self._seed if seed is None else seed
        return np.stack([self._reset_one(i, base + i)
                         for i in range(self.num_envs)])

    def vector_step(self, actions: np.ndarray):
        obs, rews, dones, truncs = [], [], [], []
        for i, env in enumerate(self._envs):
            out = env.step(np.asarray(actions[i]).item()
                           if self.action_space.kind == "discrete"
                           else np.asarray(actions[i]))
            if len(out) == 5:       # gymnasium: term/trunc split
                o, r, term, trunc, _ = out
            else:                   # classic gym: done only
                o, r, term, _ = out
                trunc = False
            obs.append(np.asarray(o, np.float32))
            rews.append(float(r))
            dones.append(bool(term) or bool(trunc))
            truncs.append(bool(trunc))
        terminal = np.stack(obs)
        info = {"terminal_obs": terminal,
                "truncated": np.asarray(truncs)}
        for i, d in enumerate(dones):
            if d:
                obs[i] = self._reset_one(i, None)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones), info)


def register_gym_env(name: str,
                     env_creator: Callable[[Dict], Any]) -> None:
    """Register a gym(nasium) env factory under a name usable in any
    algorithm config (reference: tune.registry.register_env with a gym
    creator)."""

    def make(num_envs: int = 1, seed: int = 0, **kwargs):
        return GymVectorEnv(env_creator, num_envs=num_envs, seed=seed,
                            **kwargs)

    register_env(name, make)

"""RL environments: the Env contract, a vectorized wrapper, and built-in
tasks (CartPole, Pendulum) implemented directly in numpy.

Port of ``ray_tpu/rllib/env.py``, copied (numpy only): the same seeds give
bit-identical observations, rewards and dones in both packages.

Design analog: the reference wraps gym environments and vectorizes them in
``rllib/env/vector_env.py``; this framework ships its own envs (no gym in
the image) with the same step/reset semantics, natively vectorized — the
whole env batch steps as one numpy program, which is what a host feeding a
device learner wants (SURVEY.md §2.4 rollout parallelism).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclass
class Space:
    """Minimal space descriptor (discrete n or continuous box shape)."""

    kind: str                      # "discrete" | "box"
    n: int = 0                     # discrete action count
    shape: Tuple[int, ...] = ()    # box shape
    low: float = -np.inf
    high: float = np.inf


class Env:
    """Single-env contract: reset() -> obs; step(a) -> (obs, r, done, info).

    Matches the classic gym API shape (reference rollout workers assume it:
    rllib/evaluation/sampler.py) without depending on gym.
    """

    observation_space: Space
    action_space: Space

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        raise NotImplementedError


class VectorEnv:
    """N independent env instances stepped as one batched numpy program.

    Auto-resets finished sub-envs (the obs returned for a done env is the
    first obs of its next episode; the pre-reset terminal obs is in
    ``info["terminal_obs"]``) — same contract as the reference's
    ``VectorEnv.vector_step`` (rllib/env/vector_env.py).
    """

    def __init__(self, num_envs: int):
        self.num_envs = num_envs

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def vector_step(self, actions: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """Vectorized CartPole with the standard physics constants.

    Dynamics follow the classic control formulation (pole on a cart,
    Euler-integrated at tau=0.02); episode ends at |x|>2.4, |theta|>12deg,
    or ``max_episode_steps``. Reward +1 per live step.
    """

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 500,
                 seed: int = 0):
        super().__init__(num_envs)
        self.observation_space = Space("box", shape=(4,))
        self.action_space = Space("discrete", n=2)
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros((num_envs,), np.int64)

        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masscart + self.masspole
        self.length = 0.5          # half pole length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.x_threshold = 2.4
        self.theta_threshold = 12 * 2 * np.pi / 360

    def _sample_state(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, size=(n, 4))

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._sample_state(self.num_envs)
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def vector_step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(np.asarray(actions) == 1,
                         self.force_mag, -self.force_mag)
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * theta_dot ** 2 * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0
                           - self.masspole * costheta ** 2 / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1

        terminated = ((np.abs(x) > self.x_threshold)
                      | (np.abs(theta) > self.theta_threshold))
        truncated = self._steps >= self.max_episode_steps
        done = terminated | truncated
        reward = np.ones((self.num_envs,), np.float32)

        info = {"terminal_obs": self._state.astype(np.float32),
                "truncated": truncated}
        if done.any():
            idx = np.nonzero(done)[0]
            self._state[idx] = self._sample_state(len(idx))
            self._steps[idx] = 0
        return (self._state.astype(np.float32), reward,
                done, info)


class PendulumVectorEnv(VectorEnv):
    """Vectorized Pendulum (continuous control): swing a pole upright.

    obs = (cos th, sin th, th_dot); action = 1-d torque in [-2, 2];
    reward = -(th^2 + 0.1 th_dot^2 + 0.001 a^2); 200-step episodes.
    """

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 200,
                 seed: int = 0):
        super().__init__(num_envs)
        self.observation_space = Space("box", shape=(3,))
        self.action_space = Space("box", shape=(1,), low=-2.0, high=2.0)
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(seed)
        self._th = np.zeros((num_envs,))
        self._thdot = np.zeros((num_envs,))
        self._steps = np.zeros((num_envs,), np.int64)
        self.g, self.m, self.length, self.dt = 10.0, 1.0, 1.0, 0.05

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._th), np.sin(self._th),
                         self._thdot], axis=1).astype(np.float32)

    def _sample(self, n):
        return (self._rng.uniform(-np.pi, np.pi, n),
                self._rng.uniform(-1.0, 1.0, n))

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th, self._thdot = self._sample(self.num_envs)
        self._steps[:] = 0
        return self._obs()

    def vector_step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(
            self.num_envs), -2.0, 2.0)
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.length) * np.sin(th)
                         + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        thdot = np.clip(thdot, -8.0, 8.0)
        th = th + thdot * self.dt
        self._th, self._thdot = th, thdot
        self._steps += 1
        done = self._steps >= self.max_episode_steps
        info = {"terminal_obs": self._obs(),
                "truncated": done.copy()}
        if done.any():
            idx = np.nonzero(done)[0]
            nth, nthdot = self._sample(len(idx))
            self._th[idx] = nth
            self._thdot[idx] = nthdot
            self._steps[idx] = 0
        return self._obs(), (-cost).astype(np.float32), done, info


class RepeatPreviousVectorEnv(VectorEnv):
    """Memory probe: emit the token seen on the PREVIOUS step.

    Observation is a one-hot token drawn uniformly each step; reward 1.0
    when the action equals the token shown one step earlier (0 on the
    first step of an episode).  A memoryless policy peaks at 1/n_tokens
    expected reward per step; a recurrent policy solves it exactly — the
    standard smoke test for whether hidden state actually carries
    information (reference analog: RepeatAfterMeEnv in
    rllib/examples/envs/classes/repeat_after_me_env.py — behavior
    re-derived, not ported).
    """

    def __init__(self, num_envs: int = 1, n_tokens: int = 3,
                 episode_len: int = 32, seed: int = 0):
        super().__init__(num_envs)
        self.n_tokens = n_tokens
        self.episode_len = episode_len
        self.observation_space = Space("box", shape=(n_tokens,))
        self.action_space = Space("discrete", n=n_tokens)
        self._rng = np.random.default_rng(seed)
        self._token = np.zeros((num_envs,), np.int64)
        self._prev = np.zeros((num_envs,), np.int64)
        self._steps = np.zeros((num_envs,), np.int64)

    def _one_hot(self) -> np.ndarray:
        out = np.zeros((self.num_envs, self.n_tokens), np.float32)
        out[np.arange(self.num_envs), self._token] = 1.0
        return out

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._token = self._rng.integers(0, self.n_tokens,
                                         size=self.num_envs)
        self._prev[:] = -1          # no reward defined for the first step
        self._steps[:] = 0
        return self._one_hot()

    def vector_step(self, actions: np.ndarray):
        actions = np.asarray(actions)
        reward = (actions == self._prev).astype(np.float32)
        reward[self._prev < 0] = 0.0
        self._prev = self._token.copy()
        self._token = self._rng.integers(0, self.n_tokens,
                                         size=self.num_envs)
        self._steps += 1
        truncated = self._steps >= self.episode_len
        done = truncated.copy()
        info = {"terminal_obs": self._one_hot(), "truncated": truncated}
        if done.any():
            idx = np.nonzero(done)[0]
            self._prev[idx] = -1
            self._steps[idx] = 0
            self._token[idx] = self._rng.integers(0, self.n_tokens,
                                                  size=len(idx))
        return self._one_hot(), reward, done, info


class SparseChainVectorEnv(VectorEnv):
    """Exploration stress test (the NChain/DeepSea family): a length-N
    chain where only the far-right state pays (+1) but a small distractor
    (+0.01) pays for sitting at the start.  Greedy/epsilon agents latch
    onto the distractor; novelty-driven exploration (RND) finds the end.
    obs = one-hot position; actions: 0 = left, 1 = right.
    """

    def __init__(self, num_envs: int = 1, length: int = 16,
                 max_episode_steps: int = 32, seed: int = 0):
        super().__init__(num_envs)
        self.length = length
        self.observation_space = Space("box", shape=(length,), low=0.0,
                                       high=1.0)
        self.action_space = Space("discrete", n=2)
        self.max_episode_steps = max_episode_steps
        self.pos = np.zeros(num_envs, np.int64)
        self._steps = np.zeros(num_envs, np.int64)

    def _obs(self) -> np.ndarray:
        return np.eye(self.length,
                      dtype=np.float32)[self.pos]

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        self.pos[:] = 0
        self._steps[:] = 0
        return self._obs()

    def vector_step(self, actions: np.ndarray):
        a = np.asarray(actions)
        self.pos = np.clip(self.pos + np.where(a == 1, 1, -1), 0,
                           self.length - 1)
        self._steps += 1
        at_goal = self.pos == self.length - 1
        reward = np.where(at_goal, 1.0,
                          np.where(self.pos == 0, 0.01, 0.0)
                          ).astype(np.float32)
        truncated = self._steps >= self.max_episode_steps
        done = at_goal | truncated
        info = {"terminal_obs": self._obs(), "truncated": truncated}
        if done.any():
            idx = np.nonzero(done)[0]
            self.pos[idx] = 0
            self._steps[idx] = 0
        return self._obs(), reward, done, info



_ENV_REGISTRY = {
    "CartPole-v1": CartPoleVectorEnv,
    "Pendulum-v1": PendulumVectorEnv,
    "RepeatPrevious-v0": RepeatPreviousVectorEnv,
    "SparseChain-v0": SparseChainVectorEnv,
}


def register_env(name: str, cls) -> None:
    """Register a VectorEnv class under a name (reference analog:
    ray.tune.registry.register_env)."""
    _ENV_REGISTRY[name] = cls


def make_vector_env(name: str, num_envs: int, seed: int = 0,
                    **kwargs) -> VectorEnv:
    if name not in _ENV_REGISTRY:
        # Built-in extras register on first use (the pixel suite).
        import ray_tpu_torch.rllib.pixel_env  # noqa: F401
    if name not in _ENV_REGISTRY:
        raise KeyError(
            f"unknown env {name!r}; registered: {sorted(_ENV_REGISTRY)}")
    return _ENV_REGISTRY[name](num_envs=num_envs, seed=seed, **kwargs)

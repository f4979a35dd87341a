"""Gym(nasium) interop shim, the port's mirror of tests/test_gym_compat.py
— exercised with stub envs (no gym needed), covering both API
generations (reference: rllib/env/vector_env.py gym wrapping).
"""

import numpy as np

from ray_tpu_torch.rllib.env import make_vector_env
from ray_tpu_torch.rllib.gym_compat import GymVectorEnv, register_gym_env


class _StubSpace:
    def __init__(self, n=None, shape=None, low=None, high=None):
        if n is not None:
            self.n = n
        if shape is not None:
            self.shape = shape
            self.low = low
            self.high = high


class _GymnasiumStyleEnv:
    """5-tuple step, reset(seed=) -> (obs, info)."""

    observation_space = _StubSpace(shape=(3,), low=-1.0, high=1.0)
    action_space = _StubSpace(n=2)

    def __init__(self):
        self._t = 0

    def reset(self, seed=None):
        self._t = 0
        return np.zeros(3, np.float32), {}

    def step(self, action):
        self._t += 1
        obs = np.full(3, self._t, np.float32)
        terminated = self._t >= 5
        truncated = self._t >= 4 and not terminated
        return obs, float(action), terminated, truncated, {}


class _ClassicGymStyleEnv:
    """4-tuple step, reset() without seed."""

    observation_space = _StubSpace(shape=(2,), low=0.0, high=1.0)
    action_space = _StubSpace(n=3)

    def __init__(self):
        self._t = 0

    def reset(self):
        self._t = 0
        return np.zeros(2, np.float32)

    def step(self, action):
        self._t += 1
        return (np.full(2, self._t, np.float32), 1.0, self._t >= 3, {})


def test_gymnasium_style_wrapping_and_autoreset():
    env = GymVectorEnv(lambda cfg: _GymnasiumStyleEnv(), num_envs=3,
                       seed=0)
    assert env.observation_space.kind == "box"
    assert env.observation_space.shape == (3,)
    assert env.action_space.n == 2
    obs = env.vector_reset(seed=0)
    assert obs.shape == (3, 3)
    for t in range(4):
        obs, rew, done, info = env.vector_step(np.ones(3, np.int64))
        assert rew.shape == (3,) and info["terminal_obs"].shape == (3, 3)
    assert done.all()              # truncated at t=4
    assert info["truncated"].all()
    assert (obs == 0).all()        # auto-reset to fresh obs
    assert (info["terminal_obs"] == 4).all()   # pre-reset terminal obs


def test_classic_gym_style_and_registry():
    register_gym_env("StubClassic-v0", lambda cfg: _ClassicGymStyleEnv())
    env = make_vector_env("StubClassic-v0", 2, seed=1)
    obs = env.vector_reset()
    assert obs.shape == (2, 2)
    obs, rew, done, info = env.vector_step(np.zeros(2, np.int64))
    assert (rew == 1.0).all() and not done.any()
    env.vector_step(np.zeros(2, np.int64))
    obs, rew, done, info = env.vector_step(np.zeros(2, np.int64))
    assert done.all()
    assert not info["truncated"].any()   # classic gym has no truncation


def test_gym_env_trains_with_ppo():
    """A wrapped (stub) gym env runs through a real PPO training step."""
    from ray_tpu_torch.rllib import PPOConfig
    register_gym_env("StubGymn-v0", lambda cfg: _GymnasiumStyleEnv())
    algo = (PPOConfig().environment("StubGymn-v0")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                      rollout_fragment_length=16)
            .resources(device="cpu")
            .debugging(seed=0).build())
    r = algo.train()
    assert np.isfinite(r["learner_total_loss"])
    algo.stop()

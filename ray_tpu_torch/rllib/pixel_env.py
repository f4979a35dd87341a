"""MinAtar-class pixel environments, natively vectorized in numpy.

Port of ``ray_tpu/rllib/pixel_env.py``, copied (numpy only).

Design analog: the reference's learning evidence for value/policy methods
is ALE Atari (``rllib/tuned_examples/ppo/atari-ppo.yaml``); no ALE/gym
exists in this image, so these are original miniature arcade games in the
MinAtar style (10x10 multi-channel binary images, same observation class)
— NOT ports of MinAtar's code.  The whole env batch steps as one numpy
program (SURVEY.md §2.4 rollout parallelism), so a single host thread
feeds hundreds of environments.

Games:
- ``BreakoutMini-v0``: paddle/ball/brick-wall; +1 per brick, episode ends
  when the ball passes the paddle.  obs 10x10x4 (paddle, ball, trail,
  bricks), 3 actions.
- ``FreewayMini-v0``: cross 8 lanes of deterministic traffic; +1 per
  crossing, collisions push the agent back.  obs 10x10x3 (agent, cars,
  car-direction), 3 actions, fixed 250-step episodes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env import Space, VectorEnv, register_env

G = 10   # grid side


class BreakoutMiniVectorEnv(VectorEnv):
    """Vectorized mini-Breakout on a 10x10 grid.

    State per env: ball position/velocity, paddle column, 3x10 brick wall.
    The ball moves diagonally one cell per step, bouncing off walls, the
    ceiling, bricks (destroying them, +1) and the width-2 paddle on the
    bottom row; missing the ball ends the episode.  A cleared wall
    respawns, so returns are unbounded at perfect play (episode cap
    ``max_episode_steps``)."""

    BRICK_ROWS = (1, 2, 3)

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 500,
                 ball_period: int = 2, seed: int = 0):
        # ball_period=2: the ball advances every other tick, so the paddle
        # (1 cell/tick) can cover the full width — makes sustained rallies
        # learnable; ball_period=1 is the speed-parity hard mode.
        super().__init__(num_envs)
        self.ball_period = ball_period
        self.observation_space = Space("box", shape=(G, G, 4), low=0.0,
                                       high=1.0)
        self.action_space = Space("discrete", n=3)  # stay / left / right
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(seed)
        n = num_envs
        self.ball_y = np.zeros(n, np.int64)
        self.ball_x = np.zeros(n, np.int64)
        self.dy = np.ones(n, np.int64)
        self.dx = np.ones(n, np.int64)
        self.prev_y = np.zeros(n, np.int64)
        self.prev_x = np.zeros(n, np.int64)
        self.pad = np.zeros(n, np.int64)
        self.bricks = np.zeros((n, len(self.BRICK_ROWS), G), bool)
        self._steps = np.zeros(n, np.int64)

    def _reset_envs(self, idx: np.ndarray) -> None:
        k = len(idx)
        self.ball_y[idx] = 4
        self.ball_x[idx] = self._rng.integers(0, G, k)
        self.dy[idx] = 1
        self.dx[idx] = self._rng.choice((-1, 1), k)
        self.prev_y[idx] = self.ball_y[idx]
        self.prev_x[idx] = self.ball_x[idx]
        self.pad[idx] = self._rng.integers(0, G - 1, k)
        self.bricks[idx] = True
        self._steps[idx] = 0

    def _obs(self) -> np.ndarray:
        n = self.num_envs
        obs = np.zeros((n, G, G, 4), np.float32)
        e = np.arange(n)
        obs[e, G - 1, self.pad, 0] = 1.0
        obs[e, G - 1, np.minimum(self.pad + 1, G - 1), 0] = 1.0
        obs[e, self.ball_y, self.ball_x, 1] = 1.0
        obs[e, self.prev_y, self.prev_x, 2] = 1.0
        obs[:, self.BRICK_ROWS[0]:self.BRICK_ROWS[-1] + 1, :, 3] = \
            self.bricks
        return obs

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_envs(np.arange(self.num_envs))
        return self._obs()

    def vector_step(self, actions: np.ndarray):
        n = self.num_envs
        e = np.arange(n)
        a = np.asarray(actions)
        self.pad = np.clip(self.pad + (a == 2).astype(np.int64)
                           - (a == 1).astype(np.int64), 0, G - 2)
        # per-env tick parity: the ball advances only on its move ticks
        # (resets desynchronize env clocks, so parity is per env)
        move = (self._steps % self.ball_period) == 0
        self.prev_y = np.where(move, self.ball_y, self.prev_y)
        self.prev_x = np.where(move, self.ball_x, self.prev_x)

        # side walls reflect horizontal velocity
        nx = self.ball_x + self.dx
        bounce_x = (nx < 0) | (nx >= G)
        self.dx = np.where(move & bounce_x, -self.dx, self.dx)
        nx = self.ball_x + self.dx
        # ceiling reflects vertical velocity
        ny = self.ball_y + self.dy
        bounce_y = ny < 0
        self.dy = np.where(move & bounce_y, -self.dy, self.dy)
        ny = self.ball_y + self.dy

        # brick hit: remove brick, reflect, ball holds position this step
        reward = np.zeros(n, np.float32)
        row_idx = ny - self.BRICK_ROWS[0]
        # move-mask first: nx/ny are only in-range for envs whose ball
        # actually advanced (bounces were skipped for the rest)
        in_wall = move & (ny >= self.BRICK_ROWS[0]) \
            & (ny <= self.BRICK_ROWS[-1])
        hit = np.zeros(n, bool)
        hit[in_wall] = self.bricks[e[in_wall], row_idx[in_wall],
                                   nx[in_wall]]
        if hit.any():
            self.bricks[e[hit], row_idx[hit], nx[hit]] = False
            reward[hit] = 1.0
            self.dy[hit] = -self.dy[hit]
            ny[hit] = self.ball_y[hit]
            nx[hit] = self.ball_x[hit]
        # cleared wall respawns
        cleared = ~self.bricks.any(axis=(1, 2))
        if cleared.any():
            self.bricks[cleared] = True

        # bottom row: paddle bounce or lost ball
        at_bottom = move & (ny >= G - 1)
        on_pad = at_bottom & ((nx == self.pad) | (nx == self.pad + 1))
        self.dy = np.where(on_pad, -1, self.dy)
        ny = np.where(on_pad, G - 1, ny)
        terminated = at_bottom & ~on_pad
        ny = np.minimum(ny, G - 1)

        self.ball_y = np.where(move, ny, self.ball_y)
        self.ball_x = np.where(move, nx, self.ball_x)
        self._steps += 1
        truncated = self._steps >= self.max_episode_steps
        done = terminated | truncated
        info = {"terminal_obs": self._obs(), "truncated": truncated}
        if done.any():
            self._reset_envs(np.nonzero(done)[0])
        return self._obs(), reward, done, info


class FreewayMiniVectorEnv(VectorEnv):
    """Vectorized mini-Freeway: reach the top row through 8 traffic lanes.

    Car positions are a pure function of the global step counter
    (per-lane speed/direction/offset), so the only per-env state is the
    agent's row and the step clock.  Collision sends the agent back to the
    start row; reaching row 0 scores +1 and also resets the agent.
    Episodes are fixed-length (always truncated)."""

    COL = 4                       # the agent climbs a fixed column
    # per-lane (rows 1..8): direction, period (move every p steps), offset
    LANES = [(+1, 1, 0), (-1, 2, 3), (+1, 2, 5), (-1, 1, 2),
             (+1, 3, 7), (-1, 2, 1), (+1, 1, 4), (-1, 3, 6)]

    def __init__(self, num_envs: int = 1, max_episode_steps: int = 250,
                 seed: int = 0):
        super().__init__(num_envs)
        self.observation_space = Space("box", shape=(G, G, 3), low=0.0,
                                       high=1.0)
        self.action_space = Space("discrete", n=3)  # stay / up / down
        self.max_episode_steps = max_episode_steps
        self._rng = np.random.default_rng(seed)
        self.row = np.full(num_envs, G - 1, np.int64)
        self._t = np.zeros(num_envs, np.int64)
        self._steps = np.zeros(num_envs, np.int64)

    def _car_cols(self, t: np.ndarray) -> np.ndarray:
        """[n, 8] car column per lane at per-env time t."""
        cols = np.empty((len(t), len(self.LANES)), np.int64)
        for i, (d, p, off) in enumerate(self.LANES):
            cols[:, i] = (off + d * (t // p)) % G
        return cols

    def _obs(self) -> np.ndarray:
        n = self.num_envs
        obs = np.zeros((n, G, G, 3), np.float32)
        e = np.arange(n)
        obs[e, self.row, self.COL, 0] = 1.0
        cols = self._car_cols(self._t)
        for i, (d, _p, _o) in enumerate(self.LANES):
            obs[e, i + 1, cols[:, i], 1] = 1.0
            obs[e, i + 1, cols[:, i], 2] = 1.0 if d > 0 else 0.0
        return obs

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.row[:] = G - 1
        self._t = self._rng.integers(0, 60, self.num_envs)
        self._steps[:] = 0
        return self._obs()

    def vector_step(self, actions: np.ndarray):
        n = self.num_envs
        a = np.asarray(actions)
        self.row = np.clip(self.row - (a == 1).astype(np.int64)
                           + (a == 2).astype(np.int64), 0, G - 1)
        self._t += 1
        cols = self._car_cols(self._t)
        in_lane = (self.row >= 1) & (self.row <= len(self.LANES))
        lane_idx = np.clip(self.row - 1, 0, len(self.LANES) - 1)
        crash = in_lane & (cols[np.arange(n), lane_idx] == self.COL)
        self.row[crash] = G - 1

        reward = (self.row == 0).astype(np.float32)
        self.row[self.row == 0] = G - 1   # scored: restart the climb

        self._steps += 1
        done = self._steps >= self.max_episode_steps
        info = {"terminal_obs": self._obs(),
                "truncated": done.copy()}
        if done.any():
            idx = np.nonzero(done)[0]
            self.row[idx] = G - 1
            self._steps[idx] = 0
            self._t[idx] = self._rng.integers(0, 60, len(idx))
        return self._obs(), reward, done, info


register_env("BreakoutMini-v0", BreakoutMiniVectorEnv)
register_env("FreewayMini-v0", FreewayMiniVectorEnv)

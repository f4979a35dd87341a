"""Replay buffers: uniform ring + proportional prioritized.

Port of ``ray_tpu/rllib/replay_buffer.py``, copied: numpy columns and a
``np.random.default_rng``, so samples, importance weights and priorities
equal the JAX package's exactly.  Design analog: reference
``rllib/utils/replay_buffers/`` — ReplayBuffer (uniform) and
PrioritizedReplayBuffer (proportional sampling with importance weights,
Schaul et al.).  Columnar storage (one ring array per SampleBatch key) so
a sample() is pure fancy indexing — the sampled batch moves to the
learner's device as one copy a column.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> np.ndarray:
        """Insert every row; returns the storage indices used."""
        n = batch.count
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        return idx

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, size=num_items)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        out = SampleBatch({k: c[idx] for k, c in self._cols.items()})
        out["batch_indexes"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization: P(i) ∝ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta / max w (reference
    utils/replay_buffers/prioritized_replay_buffer.py)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._prios = np.zeros((capacity,), np.float64)
        self._max_prio = 1.0

    def add(self, batch: SampleBatch) -> np.ndarray:
        idx = super().add(batch)
        # New experience gets max priority so it's seen at least once.
        self._prios[idx] = self._max_prio
        return idx

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        p = self._prios[:self._size] ** self.alpha
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        out = self._take(idx)
        w = (self._size * probs[idx]) ** (-beta)
        out["weights"] = (w / w.max()).astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._prios[np.asarray(idx)] = priorities
        self._max_prio = max(self._max_prio, float(priorities.max()))

"""SampleBatch: the columnar container rollout data travels in.

Port of ``ray_tpu/rllib/sample_batch.py``, copied: a batch holds numpy,
never tensors, so it crosses the object store and the offline npz files
in both packages' formats.

Design analog: reference ``rllib/policy/sample_batch.py:96`` (dict of
equal-length arrays with concat/shuffle/minibatch utilities).  Kept numpy
-first: batches are built on host CPUs by rollout workers and copied
once into the learner's device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    """A dict of numpy arrays sharing a leading (time/batch) dimension."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def __len__(self) -> int:  # len(batch) == row count, as in reference
        return self.count

    @staticmethod
    def concat_samples(batches: Sequence["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches], axis=0)
            for k in keys})

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def minibatches(self, minibatch_size: int,
                    rng: np.random.Generator) -> Iterator["SampleBatch"]:
        """Shuffled minibatches; drops the ragged tail so every minibatch
        has a static shape."""
        shuffled = self.shuffle(rng)
        for start in range(0, self.count - minibatch_size + 1,
                           minibatch_size):
            yield shuffled.slice(start, start + minibatch_size)

    def split_by_episode(self) -> List["SampleBatch"]:
        """Split a time-ordered batch at done boundaries."""
        dones = np.asarray(self[DONES])
        ends = np.nonzero(dones)[0]
        out, start = [], 0
        for e in ends:
            out.append(self.slice(start, e + 1))
            start = e + 1
        if start < self.count:
            out.append(self.slice(start, self.count))
        return out

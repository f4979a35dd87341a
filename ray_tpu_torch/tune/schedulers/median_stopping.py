"""Median stopping rule.

Port of ``ray_tpu/tune/schedulers/median_stopping.py``. Design analog:
reference ``python/ray/tune/schedulers/median_stopping_rule.py``: stop a
trial at time t if its best result so far is worse than the median of other
trials' running averages at t.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class MedianStoppingRule(TrialScheduler):
    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._histories: Dict[str, List[float]] = defaultdict(list)

    def _val(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, runner, trial, result) -> str:
        if self.metric not in result:
            return self.CONTINUE
        self._histories[trial.trial_id].append(self._val(result))
        t = result.get(self.time_attr, 0)
        if t < self.grace_period:
            return self.CONTINUE
        means = [sum(h) / len(h)
                 for tid, h in self._histories.items()
                 if tid != trial.trial_id and h]
        if len(means) < self.min_samples:
            return self.CONTINUE
        means.sort()
        median = means[len(means) // 2]
        best = max(self._histories[trial.trial_id])
        return self.STOP if best < median else self.CONTINUE

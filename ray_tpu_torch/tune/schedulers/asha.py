"""Asynchronous Successive Halving (ASHA).

Port of ``ray_tpu/tune/schedulers/asha.py``. Design analog: reference
``python/ray/tune/schedulers/async_hyperband.py`` (AsyncHyperBandScheduler /
ASHAScheduler): rungs at grace_period * reduction_factor^k; a trial reaching
a rung continues only if its metric is in the top 1/reduction_factor of
results recorded at that rung.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _Rung:
    def __init__(self, milestone: float):
        self.milestone = milestone
        self.recorded: List[float] = []

    def cutoff(self, reduction_factor: float) -> float:
        import math
        if not self.recorded:
            return float("-inf")
        vals = sorted(self.recorded, reverse=True)
        k = max(0, int(math.ceil(len(vals) / reduction_factor)) - 1)
        return vals[k]


class ASHAScheduler(TrialScheduler):
    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4.0, brackets: int = 1):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        rungs: List[_Rung] = []
        t = grace_period
        while t < max_t:
            rungs.append(_Rung(t))
            t = int(t * reduction_factor)
        self.rungs = rungs  # ascending milestones

    def _metric_val(self, result: Dict[str, Any]) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, runner, trial, result) -> str:
        if self.metric not in result or self.time_attr not in result:
            return self.CONTINUE
        t = result[self.time_attr]
        if t >= self.max_t:
            return self.STOP
        v = self._metric_val(result)
        action = self.CONTINUE
        for rung in reversed(self.rungs):
            if t < rung.milestone:
                continue
            marker = f"_asha_rung_{rung.milestone}"
            if trial.scratch.get(marker):
                break
            trial.scratch[marker] = True
            cutoff = rung.cutoff(self.rf)
            rung.recorded.append(v)
            if v < cutoff:
                action = self.STOP
            break
        return action

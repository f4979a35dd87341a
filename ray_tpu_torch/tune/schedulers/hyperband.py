"""HyperBand scheduler: bracketed synchronous successive halving.

Port of ``ray_tpu/tune/schedulers/hyperband.py``. Design analog: reference
``python/ray/tune/schedulers/hyperband.py`` (HyperBandScheduler). Trials are
assigned round-robin to brackets with different starting budgets; within a
bracket, when the whole cohort has reported at a rung milestone, only the
top 1/eta continue (the reference pauses trials at the rung barrier; this
runtime has no PAUSE, so leaders keep running and losers are stopped when
the rung resolves — same selection, slightly more compute spent on winners,
no idle waiting).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _Bracket:
    def __init__(self, min_t: int, max_t: int, eta: float):
        self.eta = eta
        self.milestones: List[int] = []
        t = min_t
        while t < max_t:
            self.milestones.append(int(t))
            t *= eta
        self.trials: List[str] = []            # trial ids in this bracket
        # milestone -> {trial_id: signed metric}
        self.recorded: Dict[int, Dict[str, float]] = {
            m: {} for m in self.milestones}
        self.stopped: set = set()
        self.done: set = set()                 # finished/errored trial ids

    def live_cohort(self, milestone: int) -> List[str]:
        """Trials that could still report at this milestone."""
        return [t for t in self.trials
                if t not in self.stopped and t not in self.done]

    def resolve(self, milestone: int) -> List[str]:
        """If every live cohort member has recorded at the milestone,
        return the ids to stop (bottom 1 - 1/eta); else []."""
        rec = self.recorded[milestone]
        cohort = self.live_cohort(milestone)
        if not cohort or any(t not in rec for t in cohort):
            return []
        ranked = sorted(cohort, key=lambda t: -rec[t])
        keep = max(1, int(math.floor(len(ranked) / self.eta)))
        losers = ranked[keep:]
        self.stopped.update(losers)
        return losers


class HyperBandScheduler(TrialScheduler):
    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: float = 3.0):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        # s_max+1 brackets, bracket s starts at max_t / eta^s (classic
        # HyperBand budget ladder).
        s_max = int(math.log(max_t) / math.log(reduction_factor))
        self.brackets = [
            _Bracket(max(1, int(max_t / reduction_factor ** s)), max_t,
                     reduction_factor)
            for s in range(s_max, -1, -1)]
        self._assign_idx = 0
        self._by_trial: Dict[str, _Bracket] = {}

    def on_trial_add(self, runner, trial):
        bracket = self.brackets[self._assign_idx % len(self.brackets)]
        self._assign_idx += 1
        bracket.trials.append(trial.trial_id)
        self._by_trial[trial.trial_id] = bracket

    def _signed(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, runner, trial, result) -> str:
        if self.metric not in result or self.time_attr not in result:
            return self.CONTINUE
        bracket = self._by_trial.get(trial.trial_id)
        if bracket is None:
            return self.CONTINUE
        t = result[self.time_attr]
        if trial.trial_id in bracket.stopped:
            return self.STOP
        action = self.CONTINUE
        for m in bracket.milestones:
            if t >= m and trial.trial_id not in bracket.recorded[m]:
                bracket.recorded[m][trial.trial_id] = self._signed(result)
                # Rung losers are marked; each stops at its next report
                # (the runner enacts decisions per-trial, so cross-trial
                # stops are deferred one iteration).
                losers = bracket.resolve(m)
                if trial.trial_id in losers:
                    action = self.STOP
        if trial.trial_id in bracket.stopped:
            action = self.STOP
        if t >= self.max_t:
            action = self.STOP
        return action

    def on_trial_complete(self, runner, trial, result):
        b = self._by_trial.get(trial.trial_id)
        if b:
            b.done.add(trial.trial_id)
            # A finished trial can unblock pending rung barriers.
            for m in b.milestones:
                b.resolve(m)

    def on_trial_error(self, runner, trial):
        self.on_trial_complete(runner, trial, None)

"""Population Based Training.

Port of ``ray_tpu/tune/schedulers/pbt.py``. Design analog: reference
``python/ray/tune/schedulers/pbt.py`` (PopulationBasedTraining): every
perturbation_interval, trials in the bottom quantile exploit (clone
checkpoint + config of) a top-quantile trial, then explore (perturb
hyperparams by 1.2x/0.8x or resample). The runner applies the exploit by
restoring the victim's trainable from the donor's checkpoint with the
perturbed config.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.tune.search.sample import Domain
from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class PopulationBasedTraining(TrialScheduler):
    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}

    def _val(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        new = dict(config)
        for k, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or k not in new:
                new[k] = self._sample(spec)
            elif isinstance(new[k], (int, float)):
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                new[k] = type(new[k])(new[k] * factor)
            else:
                new[k] = self._sample(spec)
        return new

    def _sample(self, spec):
        if isinstance(spec, Domain):
            return spec.sample(self._rng)
        if isinstance(spec, list):
            return self._rng.choice(spec)
        if isinstance(spec, Callable):
            return spec()
        return spec

    def on_trial_result(self, runner, trial, result) -> str:
        if self.metric not in result:
            return self.CONTINUE
        self._scores[trial.trial_id] = self._val(result)
        t = result.get(self.time_attr, 0)
        last = trial.scratch.get("_pbt_last_perturb", 0)
        if t - last < self.interval:
            return self.CONTINUE
        trial.scratch["_pbt_last_perturb"] = t

        live = [tr for tr in runner.live_trials() if tr.trial_id
                in self._scores]
        if len(live) < 2:
            return self.CONTINUE
        ranked = sorted(live, key=lambda tr: self._scores[tr.trial_id])
        n_q = max(1, int(len(ranked) * self.quantile))
        bottom = ranked[:n_q]
        top = ranked[-n_q:]
        if trial in bottom and trial not in top:
            donor = self._rng.choice(top)
            new_config = self.explore(donor.config)
            # Drop the victim's stale score: until it reports from the
            # donor's checkpoint it must not participate in quantile
            # ranking (otherwise two near-tied trials exploit each other
            # every report — ping-pong churn that never converges).
            self._scores.pop(trial.trial_id, None)
            # The runner performs checkpoint transfer + in-place restart.
            runner.request_exploit(trial, donor, new_config)
        return self.CONTINUE

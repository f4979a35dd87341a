"""Trial scheduler contract.

Port of ``ray_tpu/tune/schedulers/trial_scheduler.py``. Design analog:
reference ``python/ray/tune/schedulers/trial_scheduler.py`` (TrialScheduler
with CONTINUE/PAUSE/STOP decisions fed from TrialRunner.step).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    metric: Optional[str] = None
    mode: str = "max"

    def set_search_properties(self, metric: Optional[str], mode: str) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_add(self, runner, trial):
        pass

    def on_trial_result(self, runner, trial,
                        result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, runner, trial, result: Dict[str, Any]):
        pass

    def on_trial_error(self, runner, trial):
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference default)."""

"""Direct (non-Tune) trainer execution.

Port of ``ray_tpu/train/_internal/loop_runner.py``.  The reference always
routes Trainer.fit through a single-trial Tune run (base_trainer.py:339);
here the direct path is first-class: a driver-side session collects
session.report calls from training_loop and materializes an air.Result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result


class StopTraining(Exception):
    """Raised into the trainer's loop when RunConfig.stop criteria are met;
    the training_loop treats it as a clean early exit."""


class _DriverSession(air_session._SessionBase):
    """Accumulates reports made by the trainer's training_loop."""

    def __init__(self, stop: Optional[Dict[str, Any]] = None):
        self.history: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[Checkpoint] = None
        self._stop = stop or {}
        self.iteration = 0

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self.iteration += 1
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", self.iteration)
        self.history.append(metrics)
        if checkpoint is not None:
            self.latest_checkpoint = checkpoint
        if self._should_stop(metrics):
            raise StopTraining()

    def _should_stop(self, metrics: Dict[str, Any]) -> bool:
        for key, threshold in self._stop.items():
            if key in metrics and metrics[key] >= threshold:
                return True
        return False


def run_trainer_directly(trainer) -> Result:
    from ray_tpu_torch.train.base_trainer import TrainingFailedError

    prev = air_session._get_session()
    sess = _DriverSession(stop=trainer.run_config.stop)
    air_session._set_session(sess)
    error: Optional[Exception] = None
    try:
        trainer.training_loop()
    except StopTraining:
        pass  # RunConfig.stop criteria met: clean early exit
    except Exception as e:  # noqa: BLE001 - surfaced in Result + raised
        error = e
    finally:
        air_session._set_session(prev)

    result = Result(
        metrics=sess.history[-1] if sess.history else {},
        checkpoint=sess.latest_checkpoint,
        error=error,
        metrics_history=sess.history,
    )
    if error is not None:
        raise TrainingFailedError(
            f"training loop failed: {error}") from error
    return result

"""BaseTrainer: the fit() entry point.

Port of ``ray_tpu/train/base_trainer.py`` (reference
``python/ray/train/base_trainer.py``: BaseTrainer, fit:339,
as_trainable:500).  fit() runs the training loop and returns an
air.Result; ``as_trainable()`` adapts any trainer into the Tune Trainable
contract, so ``Tuner(trainer)`` composes as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result


class TrainingFailedError(RuntimeError):
    """fit() failed after exhausting FailureConfig.max_failures."""


class BaseTrainer:
    def __init__(self,
                 *,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Any] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        # A string is treated as a storage URI (file://, gs://, ...) —
        # reference base_trainer accepts Checkpoint objects whose storage
        # may be remote; here the URI form is explicit.
        if isinstance(resume_from_checkpoint, str):
            resume_from_checkpoint = Checkpoint.from_uri(
                resume_from_checkpoint)
        self.resume_from_checkpoint = resume_from_checkpoint

    def setup(self) -> None:
        """Pre-fit hook (reference base_trainer.py:287)."""

    def training_loop(self) -> None:
        """Subclass hook: run training, reporting through the session.
        Must be driven through _run_training_loop below."""
        raise NotImplementedError

    def fit(self) -> Result:
        from ray_tpu_torch.train._internal.loop_runner import (
            run_trainer_directly)
        self.setup()
        return run_trainer_directly(self)

    def as_trainable(self) -> Type:
        """Wrap this trainer as a Tune Trainable class (reference
        base_trainer.py:500) so it can be passed to Tuner."""
        from ray_tpu_torch.tune.trainable import wrap_trainer_as_trainable
        return wrap_trainer_as_trainable(self)

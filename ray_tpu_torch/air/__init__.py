"""AIR-style shared trainer surface.

Port of ``ray_tpu/air`` (reference ``python/ray/air/``: Checkpoint
(air/checkpoint.py:63), ScalingConfig/FailureConfig/CheckpointConfig/
RunConfig (air/config.py:79,483,542,670), session.report
(air/session.py:41), Result (air/result.py)).  Checkpoints hold nested
dicts of tensors (raw bytes + dtype + shape a leaf, bf16 included), and
ScalingConfig speaks whole cards: ``use_gpu`` + ``gpus_per_worker``.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "Result",
    "session",
]

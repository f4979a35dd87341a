"""AIR configuration dataclasses.

Port of ``ray_tpu/air/config.py`` (reference ``python/ray/air/config.py``
-- ScalingConfig:79, FailureConfig:483, CheckpointConfig:542,
RunConfig:670).  The schedulable unit is a worker process that drives
whole cards: ``use_gpu`` + ``gpus_per_worker`` replace the JAX package's
``use_tpu`` + ``chips_per_worker``, and a worker's bundle asks for
``"GPU"``.  The runtime leases whole cards only, so a worker's count is
a whole number.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    """How many workers, on what resources, gang-placed how.

    num_workers: one worker actor per process.
    use_gpu: give each worker cards (one unless ``gpus_per_worker``).
    gpus_per_worker: whole cards each worker drives.
    resources_per_worker: extra custom resources per bundle.
    placement_strategy: PACK/SPREAD/STRICT_PACK/STRICT_SPREAD.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu or self.gpus_per_worker:
            res["GPU"] = float(self.gpus_per_worker or 1)
        return res

    def as_placement_group_bundles(self) -> List[Dict[str, float]]:
        head = dict(self.trainer_resources or {"CPU": 0.0})
        bundles = [b for b in [head] if any(v > 0 for v in b.values())]
        bundles += [self.bundle() for _ in range(self.num_workers)]
        return bundles

    @property
    def num_gpus_total(self) -> int:
        return self.num_workers * max(1, self.gpus_per_worker) \
            if (self.use_gpu or self.gpus_per_worker) else 0


@dataclass
class FailureConfig:
    """max_failures: retries of the whole trial on worker/host loss.
    -1 means infinite (reference semantics, air/config.py:483)."""

    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    """num_to_keep: None keeps all. checkpoint_score_attribute orders kept
    checkpoints; checkpoint_frequency applies to class Trainables."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    log_to_file: bool = False

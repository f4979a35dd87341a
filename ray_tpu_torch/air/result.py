"""Result: the terminal report of a trial/run.

Design analog: reference ``python/ray/air/result.py`` (Result dataclass with
metrics/checkpoint/error/metrics_dataframe).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")

    def __repr__(self):
        keys = sorted((self.metrics or {}).keys())
        return (f"Result(metrics_keys={keys[:8]}, "
                f"checkpoint={self.checkpoint is not None}, "
                f"error={type(self.error).__name__ if self.error else None})")

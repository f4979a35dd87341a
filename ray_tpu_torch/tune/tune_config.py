"""TuneConfig.

Port of ``ray_tpu/tune/tune_config.py``. Design analog: reference
``python/ray/tune/tune_config.py`` (TuneConfig dataclass:
metric/mode/search_alg/scheduler/num_samples/ max_concurrent_trials).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: Optional[str] = None
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[object] = None
    scheduler: Optional[object] = None
    # Default True: trainables opt in via reset_config (FunctionTrainable
    # does); class trainables returning False still get a fresh actor.
    # Avoids a worker-process restart per PBT exploit.
    reuse_actors: bool = True
    seed: Optional[int] = None

    def __post_init__(self):
        if self.mode is not None and self.mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")

"""Trial state record.

Port of ``ray_tpu/tune/experiment/trial.py``. Design analog: reference
``python/ray/tune/experiment/trial.py:207`` (Trial with status lifecycle
PENDING/RUNNING/PAUSED/TERMINATED/ERROR, last_result, checkpoint manager
hooks).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, config: Dict[str, Any], trial_id: str = "",
                 experiment_name: str = ""):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.config = config
        self.experiment_name = experiment_name
        self.status = PENDING
        self.last_result: Dict[str, Any] = {}
        self.metrics_history: List[Dict[str, Any]] = []
        self.checkpoint: Optional[Checkpoint] = None
        self.error: Optional[str] = None
        self.actor = None           # _TrialActor handle while RUNNING
        self.pending_ref = None     # in-flight train() ref
        self.num_failures = 0
        self.scratch: Dict[str, Any] = {}  # scheduler scratch space

    @property
    def trial_name(self) -> str:
        return f"{self.experiment_name}_{self.trial_id}"

    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "error": self.error,
            "num_failures": self.num_failures,
            "checkpoint": self.checkpoint.to_dict()
            if self.checkpoint else None,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any],
                   experiment_name: str = "") -> "Trial":
        t = cls(state["config"], trial_id=state["trial_id"],
                experiment_name=experiment_name)
        t.status = state["status"]
        t.last_result = state.get("last_result") or {}
        t.error = state.get("error")
        t.num_failures = state.get("num_failures", 0)
        if state.get("checkpoint") is not None:
            t.checkpoint = Checkpoint.from_dict(state["checkpoint"])
        return t

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"

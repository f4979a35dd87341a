"""Training/tuning session: the worker-side half of the report channel.

Design analog: reference ``python/ray/air/session.py`` (report:41,
get_checkpoint:94, get_world_rank/get_world_size/get_local_rank) backed by
``train/_internal/session.py:63`` (_TrainSession result queue).  Here a
session is a plain object installed per-process (one worker process per
host = one session; no thread juggling needed), and ``report`` enqueues to
whatever transport the installed session provides (Train: queue actor back
to the driver; Tune function-API: in-process queue).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_SessionBase"] = None


class _SessionBase:
    """Contract every concrete session implements."""

    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    trial_name: str = ""
    trial_id: str = ""
    experiment_name: str = ""

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        raise NotImplementedError

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return None


def _set_session(session: Optional[_SessionBase]):
    global _session
    with _session_lock:
        _session = session


def _get_session(warn: bool = True) -> Optional[_SessionBase]:
    return _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) for this iteration.
    Must be called inside a train loop / tune function."""
    s = _get_session()
    if s is None:
        raise RuntimeError(
            "session.report() called outside a train/tune session")
    s.report(dict(metrics), checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = _get_session()
    return s.get_checkpoint() if s else None


def get_world_rank() -> int:
    s = _get_session()
    return s.world_rank if s else 0


def get_world_size() -> int:
    s = _get_session()
    return s.world_size if s else 1


def get_local_rank() -> int:
    s = _get_session()
    return s.local_rank if s else 0


def get_local_world_size() -> int:
    s = _get_session()
    return s.local_world_size if s else 1


def get_node_rank() -> int:
    s = _get_session()
    return s.node_rank if s else 0


def get_trial_name() -> str:
    s = _get_session()
    return s.trial_name if s else ""


def get_trial_id() -> str:
    s = _get_session()
    return s.trial_id if s else ""


def get_experiment_name() -> str:
    s = _get_session()
    return s.experiment_name if s else ""

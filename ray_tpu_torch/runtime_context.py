"""Runtime context: introspection of the current task/actor/job.

Design analog: reference ``python/ray/runtime_context.py``
(``RuntimeContext`` behind ``ray.get_runtime_context()``: get_job_id,
get_node_id, get_task_id, get_actor_id, get_worker_id,
get_assigned_resources, was_current_actor_reconstructed).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class RuntimeContext:
    """Snapshot accessor over the connected CoreWorker + (in a worker)
    the live TaskExecutor."""

    def __init__(self, core, executor):
        self._core = core
        self._executor = executor

    def get_node_id(self) -> str:
        return self._core.node_id_hex

    def get_job_id(self) -> str:
        return self._core.job_id or ""

    def get_task_id(self) -> Optional[str]:
        """Task id while inside a task/actor call, else None."""
        if self._executor is None:
            return None
        return self._executor._current_task_id

    def get_actor_id(self) -> Optional[str]:
        if self._executor is None:
            return None
        return self._executor.actor_id

    def get_worker_id(self) -> str:
        import os
        return f"{self._core.node_id_hex[:8]}-{os.getpid()}"

    @property
    def worker_mode(self) -> str:
        return "worker" if self._executor is not None else "driver"

    def get(self) -> Dict[str, Any]:
        """Whole context as a dict (reference RuntimeContext.get)."""
        return {
            "node_id": self.get_node_id(),
            "job_id": self.get_job_id(),
            "task_id": self.get_task_id(),
            "actor_id": self.get_actor_id(),
            "worker_id": self.get_worker_id(),
            "worker_mode": self.worker_mode,
        }


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch._private.worker import get_core
    core = get_core()
    return RuntimeContext(core, getattr(core, "task_executor", None))

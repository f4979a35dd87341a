"""Backend plug-in contract for worker-group process setup.

Design analog: reference ``python/ray/train/backend.py`` (Backend with
on_start/on_training_start/on_shutdown hooks called by BackendExecutor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    """Base config; subclasses carry framework-specific knobs."""

    def backend_cls(self):
        return Backend


class Backend:
    """Hooks run by BackendExecutor around the worker group lifecycle."""

    share_env_vars: tuple = ()

    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: BackendConfig):
        """Called after all workers started, before the train fn runs."""

    def on_training_start(self, worker_group: "WorkerGroup",
                          backend_config: BackendConfig):
        """Called right before start_training on each worker."""

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: BackendConfig):
        """Called before the worker group is torn down."""

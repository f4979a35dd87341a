"""User-facing exceptions.

Design analog: reference ``python/ray/exceptions.py`` (RayTaskError,
RayActorError, GetTimeoutError, ObjectLostError, ...).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    The original exception is chained as ``cause``; the remote traceback is
    preserved as text (reference: RayTaskError pickles cause + traceback str).
    """

    def __init__(self, cause: BaseException, traceback_str: str = "",
                 task_repr: str = ""):
        self.cause = cause
        self.traceback_str = traceback_str
        self.task_repr = task_repr
        super().__init__(
            f"task {task_repr} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{traceback_str}"
        )


class WorkerCrashedError(RayTpuError):
    """The worker process executing a task died unexpectedly."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """A method was called on an actor that is dead and will not restart."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get() timed out."""


class ObjectLostError(RayTpuError):
    """An object's value was lost from every node and cannot be recovered."""


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class SchedulingError(RayTpuError):
    """No node can satisfy the request's scheduling constraints
    (reference: TaskUnschedulableError)."""


class PlacementGroupUnavailableError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    """The task producing this object was cancelled via ray_tpu_torch.cancel()
    (reference: ray.exceptions.TaskCancelledError)."""

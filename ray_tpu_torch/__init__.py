"""ray_tpu_torch: ray_tpu in PyTorch, for NVIDIA Hopper.

Two halves, each mirroring ``ray_tpu``'s layout:

* **The runtime core** (``_private/``, ``_native/``, ``actor.py``,
  ``remote_function.py``, ``util/``): the GCS, the raylet, the shared-memory
  object store and the core worker, with the public API below (``init``,
  ``@remote``, ``get``/``put``/``wait``, actors, placement groups).  A node
  advertises the GPUs it finds as the ``GPU`` resource, and a task or actor
  leased ``num_gpus=k`` runs with ``CUDA_VISIBLE_DEVICES`` naming k cards of
  its own.  torch tensors travel through the object store at any dtype.
  Importing the package imports no torch: daemons, the forkserver template
  and workers that hold no card never touch CUDA.
* **The compute side** (``ops/``, ``models/``, ``parallel/``,
  ``serve/engine/``, ``autotune/``) keeps ``ray_tpu``'s parameter names and
  layouts, so weights convert one to one.  Every TPU kernel that
  ``ray_tpu`` wrote in Pallas is a CUDA kernel here, written by hand for
  ``sm_90a`` (sources in ``csrc/``, built with nvcc at first use and loaded
  through ctypes).

Compute entry points run on the card unless the caller passes
``device="cpu"``: with no card and no explicit CPU request they raise.  On
the CPU each kernel's wrapper runs its plain PyTorch version, which follows
the same blockwise recurrence as the kernel.
"""

from __future__ import annotations

from typing import (TYPE_CHECKING, Any, Dict, List, Optional, Sequence,
                    Union)

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.object_ref import (ObjectRef,  # noqa: F401
                                               ObjectRefGenerator,
                                               StreamingObjectRefGenerator)
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.actor import (ActorClass, ActorHandle,  # noqa: F401
                                 exit_actor, method)
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"

DeviceLike = Union[str, "torch.device", None]


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """The device an entry point runs on.

    ``None`` means the first CUDA card and raises when there is none: the
    port never carries on quietly on the CPU.  ``"cpu"`` (or any explicit
    device) is taken as given, after checking that a CUDA device exists.
    """
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the "
                "CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init(address: Optional[str] = None, **kwargs) -> dict:
    """Start (or connect to) a cluster. See Worker.init for options."""
    return global_worker.init(address, **kwargs)


def shutdown():
    global_worker.shutdown()


def is_initialized() -> bool:
    return global_worker.connected


def cancel(ref, *, force: bool = False) -> bool:
    """Best-effort cancel of the task producing ``ref``; its ``get``
    raises TaskCancelledError (reference: ray.cancel).

    Normal tasks: pending ones never start; running ones get a
    KeyboardInterrupt on their execution thread; ``force=True`` kills the
    worker process.  Actor calls: cancellable while queued / resolving
    args / awaiting an async method; a sync method already executing
    cannot be interrupted, and ``force=True`` raises ValueError (use
    ``ray_tpu_torch.kill`` to destroy the actor itself)."""
    from ray_tpu_torch._private.worker import get_core
    return get_core().cancel_task(ref, force=force)


def remote(*args, **kwargs):
    """Decorator turning a function into a RemoteFunction or a class into an
    ActorClass.  Usable bare (@remote) or with options (@remote(num_cpus=2)).
    """
    if len(args) == 1 and not kwargs and (
        callable(args[0]) or isinstance(args[0], type)
    ):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return decorator


def put(value: Any) -> ObjectRef:
    from ray_tpu_torch._private.worker import get_core
    return get_core().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    from ray_tpu_torch._private.worker import get_core
    core = get_core()
    if isinstance(refs, ObjectRef):
        return core.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or a list, got {type(refs)}")
    if not refs:
        return []
    return core.get(list(refs), timeout)


def wait(refs: List[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    """Readiness is metadata-only (deciding 'ready' never moves value
    bytes); fetch_local=True (the reference's default) additionally starts
    pulling ready remote objects to this node in the background so a
    following get() is warm."""
    from ray_tpu_torch._private.worker import get_core
    if not isinstance(refs, list):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return get_core().wait(refs, num_returns, timeout,
                           fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    from ray_tpu_torch._private.worker import get_core
    get_core().kill_actor(actor._actor_id, no_restart)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    from ray_tpu_torch._private.worker import get_core
    info = get_core().get_named_actor(
        name, namespace or global_worker.namespace)
    if info is None:
        raise ValueError(f"no live actor named '{name}'")
    return ActorHandle(info["actor_id"], name,
                       _method_meta=info.get("method_meta") or {})


def cluster_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.worker import get_core
    return get_core().gcs_request({"type": "cluster_resources"})["total"]


def available_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.worker import get_core
    return get_core().gcs_request({"type": "cluster_resources"})["available"]


def nodes() -> List[dict]:
    from ray_tpu_torch._private.worker import get_core
    return get_core().gcs_request({"type": "get_nodes"})


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace JSON of task executions (reference: `ray timeline`)."""
    from ray_tpu_torch.util.state import timeline as _timeline
    return _timeline(filename)


def usage_report() -> dict:
    """Local-only usage snapshot (reference usage_lib without the
    phone-home); also written to the log dir at shutdown unless
    RT_USAGE_STATS=0."""
    from ray_tpu_torch._private.usage_stats import usage_report as _ur
    return _ur()


# ray_tpu_torch.util is part of the public surface (reference: `ray.util`
# is importable off the bare `import ray`); imported last to avoid cycles.
from ray_tpu_torch import util  # noqa: E402,F401

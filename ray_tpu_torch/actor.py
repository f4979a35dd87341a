"""Actor classes and handles.

Design analog: reference ``python/ray/actor.py`` (ActorClass._remote:659,
ActorHandle, ActorMethod) with max_restarts/max_task_retries options
(actor.py:326-345).  Method calls go through the CoreWorker's direct actor
transport (per-handle ordering, restart-aware resubmission).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.worker import get_core
from ray_tpu_torch.remote_function import _build_resources, _build_scheduling

_ACTOR_DEFAULTS = dict(
    num_cpus=1.0,
    num_gpus=0.0,
    resources=None,
    max_restarts=0,
    max_task_retries=0,
    name=None,
    namespace=None,
    get_if_exists=False,
    lifetime=None,          # None | "detached"
    max_concurrency=1,
    scheduling_strategy=None,
    runtime_env=None,
    num_returns=1,
    concurrency_groups=None,
    accelerator_type=None,
)


class ActorMethod:
    __slots__ = ("_actor_id_hex", "_method_name", "_num_returns",
                 "_concurrency_group")

    def __init__(self, handle, method_name: str,
                 num_returns: int = 1, concurrency_group=None):
        # Only the actor id is kept (not the handle): handles cache their
        # ActorMethods in __dict__, and a method->handle backref would
        # cycle — deferring the original handle's __del__ (and thus the
        # anonymous actor's kill) to a gc pass instead of refcounting.
        self._actor_id_hex = (handle._actor_id_hex
                              if isinstance(handle, ActorHandle) else handle)
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        core = get_core()
        refs = core.submit_actor_task(
            self._actor_id_hex, self._method_name, args, kwargs,
            num_returns=self._num_returns,
            concurrency_group=self._concurrency_group)
        if self._num_returns in (1, "dynamic", "streaming"):
            return refs[0]
        return refs

    def options(self, num_returns=None, concurrency_group=None, **_):
        return ActorMethod(
            self._actor_id_hex, self._method_name,
            self._num_returns if num_returns is None else num_returns,
            concurrency_group or self._concurrency_group)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method '{self._method_name}' cannot be called directly; "
            f"use .remote()")


class ActorHandle:
    def __init__(self, actor_id_hex: str, class_name: str = "Actor",
                 _original: bool = False, _method_meta=None):
        self._actor_id_hex = actor_id_hex
        self._class_name = class_name
        # Only the handle returned by ActorClass.remote() owns the actor's
        # lifetime (reference: the original handle's out-of-scope kills a
        # non-detached actor; deserialized copies never do).
        self._original = _original
        # {method_name: num_returns} from @ray_tpu_torch.method decorators —
        # return arity must be known caller-side at submission.
        self._method_meta = _method_meta or {}

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        m = ActorMethod(self._actor_id_hex, item,
                        num_returns=self._method_meta.get(item, 1))
        # Cache on the instance: the next `handle.method` is a plain
        # attribute hit (an ActorMethod per access measured ~4us on the
        # submit hot path).  __reduce__ carries only the ctor args, so
        # cached methods never ride a pickled handle.
        self.__dict__[item] = m
        return m

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id_hex[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id_hex, self._class_name,
                              False, self._method_meta))

    def __del__(self):
        if not getattr(self, "_original", False):
            return
        try:
            from ray_tpu_torch._private.worker import global_worker
            core = global_worker.core_worker
            if core is not None:
                # Never block in __del__: GC may run on the IO loop thread.
                core.kill_actor_nowait(self._actor_id_hex)
        except Exception:
            pass  # interpreter teardown / already disconnected

    @property
    def _actor_id(self) -> str:
        return self._actor_id_hex


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = {**_ACTOR_DEFAULTS, **(options or {})}
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class '{self._cls.__name__}' cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()")

    def options(self, **kwargs) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **kwargs})

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = get_core()
        opts = self._options
        from ray_tpu_torch._private.worker import global_worker
        namespace = opts["namespace"] or global_worker.namespace
        meta = {name: nr for name in dir(self._cls)
                if (nr := getattr(getattr(self._cls, name, None),
                                  "_rt_num_returns", None)) is not None}
        actor_id_hex = core.create_actor(
            self._cls, args, kwargs,
            method_meta=meta,
            resources=_build_resources(opts),
            max_restarts=opts["max_restarts"],
            name=opts["name"],
            namespace=namespace,
            get_if_exists=opts["get_if_exists"],
            detached=opts["lifetime"] == "detached",
            max_concurrency=opts["max_concurrency"],
            concurrency_groups=opts.get("concurrency_groups"),
            scheduling=_build_scheduling(opts),
        )
        # Detached/named actors outlive their handles by design; anonymous
        # actors die with their original handle.
        original = opts["lifetime"] != "detached" and not opts["name"]
        return ActorHandle(actor_id_hex, self._cls.__name__,
                           _original=original, _method_meta=meta)


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: ray.actor.exit_actor)."""
    raise SystemExit(0)


def method(*, concurrency_group: str = None, num_returns=None):
    """Per-method options decorator (reference: ``ray.method``): tag an
    actor method with its concurrency group and/or return arity."""

    def wrap(fn):
        if concurrency_group is not None:
            fn._rt_concurrency_group = concurrency_group
        if num_returns is not None:
            fn._rt_num_returns = num_returns
        return fn

    return wrap

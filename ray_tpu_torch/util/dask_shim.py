"""Dask-graph scheduler over cluster tasks.

Port of ``ray_tpu/util/dask_shim.py``.

Design analog: reference ``python/ray/util/dask/scheduler.py``
(``ray_dask_get``: a dask custom scheduler that submits each graph task
as a Ray task, with inter-task data flowing as ObjectRefs).  The dask
graph format is plain data — ``{key: spec}`` where a spec is a literal,
a key reference, or a ``(callable, arg, ...)`` tuple — so this scheduler
is fully functional (and testable) without dask installed; with dask in
the environment, ``dask_obj.compute(scheduler=ray_dask_get)`` just
works, same as the reference's entry point.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

import ray_tpu_torch


def _is_task(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _is_key(graph: Dict, x: Any) -> bool:
    """dask.core semantics: a tuple is a task iff tuple[0] is callable;
    any other hashable present in the graph is a key — including the
    ``(name, index)`` tuple keys real dask collections use."""
    if _is_task(x) or not isinstance(x, Hashable):
        return False
    try:
        return x in graph
    except TypeError:   # e.g. tuple containing a list
        return False


def _exec_spec(fn, *resolved):
    """Remote kernel: run one graph task on its resolved inputs.  Nested
    containers were resolved driver-side; refs in ``resolved`` are
    materialized by the task runtime."""
    return fn(*resolved)


def ray_dask_get(graph: Dict, keys, **kwargs):
    """Execute a dask graph, one cluster task per graph task.

    ``keys`` may be a key, a list of keys, or nested lists (dask passes
    nested key lists for collections); the result mirrors its shape.
    Tasks whose arguments are other keys receive those tasks' ObjectRefs
    — the scheduler never pulls intermediates to the driver.
    """
    exec_task = ray_tpu_torch.remote(_exec_spec)
    refs: Dict[Any, Any] = {}

    def resolve(x):
        """Literal | key | (fn, ...) | [list] -> value-or-ref.  Task
        check precedes key check, mirroring dask.core._execute_task."""
        if _is_task(x):
            # Inline (anonymous nested) task: dask nests these inside
            # specs; compute eagerly as its own cluster task.
            fn, *args = x
            return exec_task.remote(fn, *[resolve(a) for a in args])
        if _is_key(graph, x):
            return materialize(x)
        if isinstance(x, list):
            resolved = [resolve(a) for a in x]
            if any(isinstance(r, ray_tpu_torch.ObjectRef) for r in resolved):
                # A list mixing refs and literals must be materialized
                # inside a task so the refs resolve to values.
                return exec_task.remote(lambda *xs: list(xs), *resolved)
            return resolved
        return x

    def materialize(key):
        if key in refs:
            return refs[key]
        spec = graph[key]
        if _is_task(spec):
            fn, *args = spec
            ref = exec_task.remote(fn, *[resolve(a) for a in args])
        elif _is_key(graph, spec):
            ref = materialize(spec)   # alias
        else:
            ref = spec                # literal
        refs[key] = ref
        return ref

    def collect(ks):
        if isinstance(ks, list):
            return [collect(k) for k in ks]
        r = materialize(ks)
        return (ray_tpu_torch.get(r)
                if isinstance(r, ray_tpu_torch.ObjectRef) else r)

    single = not isinstance(keys, list)
    out = collect([keys] if single else keys)
    return out[0] if single else out


def enable_dask_on_ray_tpu() -> None:
    """Set ray_dask_get as dask's default scheduler (requires dask;
    reference: ray.util.dask.enable_dask_on_ray)."""
    import dask
    dask.config.set(scheduler=ray_dask_get)

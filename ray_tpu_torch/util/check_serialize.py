"""Serializability inspector: WHY won't this object travel to the cluster?

Port of ``ray_tpu/util/check_serialize.py``.

Design analog: reference ``python/ray/util/check_serialize.py``
(inspect_serializability) — recursively pinpoints the unpicklable leaves
(a lock inside a closure, a client handle on an attribute) instead of
surfacing cloudpickle's opaque top-level error.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, List, Set, Tuple

from ray_tpu_torch._private import cloudpickle


@dataclass
class FailureTuple:
    obj: Any
    name: str
    parent: str

    def __repr__(self):
        return f"FailureTuple({self.name} [as part of {self.parent}])"


@dataclass
class _Ctx:
    failures: List[FailureTuple] = field(default_factory=list)
    seen: Set[int] = field(default_factory=set)


def _serializable(obj) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:
        return False


def _descend(obj, name: str, ctx: _Ctx, depth: int) -> None:
    if id(obj) in ctx.seen or depth > 4:
        return
    ctx.seen.add(id(obj))
    found_child = False
    # closures
    if inspect.isfunction(obj):
        closure = inspect.getclosurevars(obj)
        for src in (closure.nonlocals, closure.globals):
            for var, val in src.items():
                if not _serializable(val):
                    found_child = True
                    ctx.failures.append(FailureTuple(val, var, name))
                    _descend(val, var, ctx, depth + 1)
        return
    # containers
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (list, tuple, set)):
        items = enumerate(obj)
    else:
        items = list(getattr(obj, "__dict__", {}).items())
    for key, val in items:
        if not _serializable(val):
            found_child = True
            ctx.failures.append(FailureTuple(val, str(key), name))
            _descend(val, str(key), ctx, depth + 1)
    if not found_child:
        # the object itself is the leaf problem
        if not any(f.obj is obj for f in ctx.failures):
            ctx.failures.append(FailureTuple(obj, name, name))


def inspect_serializability(obj: Any, name: str = None
                            ) -> Tuple[bool, List[FailureTuple]]:
    """Returns (serializable, failures).  failures name the INNER objects
    that block pickling, with the attribute/variable path that reaches
    them — the actionable error the raw PicklingError hides."""
    name = name or getattr(obj, "__name__", type(obj).__name__)
    if _serializable(obj):
        return True, []
    ctx = _Ctx()
    _descend(obj, name, ctx, 0)
    # de-dup by identity, keep first sighting
    out, seen = [], set()
    for f in ctx.failures:
        if id(f.obj) not in seen:
            seen.add(id(f.obj))
            out.append(f)
    return False, out

"""@ray_tpu_torch.remote functions.

Design analog: reference ``python/ray/remote_function.py`` (RemoteFunction,
``_remote:241``) and option plumbing (``_private/ray_option_utils.py``).
``num_gpus=k`` asks for k whole cards: the raylet names them in the
worker's ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private.worker import get_core

_DEFAULTS = dict(
    num_returns=1,
    num_cpus=1.0,
    num_gpus=0.0,
    resources=None,
    max_retries=None,   # None -> config().task_max_retries
    retry_exceptions=False,
    scheduling_strategy=None,
    runtime_env=None,
    accelerator_type=None,
    name=None,
)


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if res.get("GPU", 0) != int(res.get("GPU", 0)):
        raise ValueError(f"num_gpus must be a whole number of cards, got "
                         f"{res['GPU']}")
    if opts.get("accelerator_type"):
        # Constrain placement to nodes advertising this card model, e.g.
        # "H100" (reference: @ray.remote(accelerator_type=...)).
        res[f"accelerator_type:{opts['accelerator_type']}"] = 0.001
    return res


def _build_scheduling(opts: Dict[str, Any]) -> Dict[str, Any]:
    strategy = opts.get("scheduling_strategy")
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )
    out: Dict[str, Any] = {}
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        out = {
            "placement_group_id": strategy.placement_group.id.hex(),
            "bundle_index": strategy.placement_group_bundle_index,
        }
    elif isinstance(strategy, NodeAffinitySchedulingStrategy):
        out = {"node_id": strategy.node_id, "soft": strategy.soft}
    elif isinstance(strategy, str):
        out = {"strategy": strategy}
    renv = opts.get("runtime_env")
    if renv:
        from ray_tpu_torch.runtime_env import env_hash, normalize_runtime_env
        norm = normalize_runtime_env(renv)
        if norm:
            out["runtime_env"] = norm
            out["env_key"] = env_hash(norm)
    return out


class RemoteFunction:
    def __init__(self, func, options: Optional[Dict[str, Any]] = None):
        self._function = func
        self._options = {**_DEFAULTS, **(options or {})}
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function '{self._function.__name__}' cannot be called "
            f"directly; use {self._function.__name__}.remote()")

    def options(self, **kwargs) -> "RemoteFunction":
        return RemoteFunction(self._function, {**self._options, **kwargs})

    def bind(self, *args, **kwargs):
        """Lazy DAG node for this call (reference dag_node build surface:
        remote_function.py bind -> FunctionNode)."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        core = get_core()
        opts = self._options
        refs = core.submit_task(
            self._function, args, kwargs,
            num_returns=opts["num_returns"],
            resources=_build_resources(opts),
            max_retries=opts["max_retries"],
            retry_exceptions=opts["retry_exceptions"],
            scheduling=_build_scheduling(opts),
            name=opts["name"] or self._function.__name__,
        )
        if opts["num_returns"] in (1, "dynamic", "streaming"):
            return refs[0]
        return refs

    @property
    def func(self):
        return self._function

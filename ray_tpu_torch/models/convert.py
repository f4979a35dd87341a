"""Weights to and from the JAX package's params, one to one.

The port keeps the reference's names and stacked ``[L]`` layout, so a
nested dict of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side) maps leaf for leaf onto the port's params, and
``params_to_numpy`` gives the same tree back.  The shapes come from the
config's family: a ``GPTConfig``, a ``LlamaConfig``, or the layer sizes of
an MLP.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt, llama
from ray_tpu_torch.models.mlp import mlp_param_shapes

ModelConfig = Union[gpt.GPTConfig, llama.LlamaConfig, Sequence[int]]


def _shapes(cfg: ModelConfig) -> dict:
    if isinstance(cfg, gpt.GPTConfig):
        return gpt.param_shapes(cfg)
    if isinstance(cfg, llama.LlamaConfig):
        return llama.param_shapes(cfg)
    if isinstance(cfg, (list, tuple)):
        return mlp_param_shapes(cfg)
    raise TypeError(f"no params layout for {type(cfg).__name__}")


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> gpt.Params:
    """The port's f32 params from a nested dict of numpy arrays.  Raises on
    a missing or extra name or a shape that does not match ``cfg``."""
    dev = resolve_device(device)

    def convert(tree, shapes, path):
        if set(tree) != set(shapes):
            raise KeyError(f"params at {path or '<root>'}: got "
                           f"{sorted(tree)}, expected {sorted(shapes)}")
        out = {}
        for name, shape in shapes.items():
            where = f"{path}.{name}" if path else name
            if isinstance(shape, dict):
                out[name] = convert(tree[name], shape, where)
                continue
            arr = np.asarray(tree[name], dtype=np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(f"{where}: shape {arr.shape}, expected "
                                 f"{tuple(shape)}")
            out[name] = torch.from_numpy(arr.copy()).to(dev)
        return out

    return convert(np_tree, _shapes(cfg), "")


def params_to_numpy(params: gpt.Params) -> dict:
    """The port's params as a nested dict of f32 numpy arrays (host
    copies), the tree ``params_from_jax`` takes."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in params.items()}

"""Minimal MLP classifier: ReLU layers and a log-softmax NLL loss.

Port of ``ray_tpu/models/mlp.py``, the small model of the train, tune and
RLlib tests.  The params tree keeps the reference's names,
``{"layer<i>": {"w": [in, out], "b": [out]}}``, so ``params_from_jax``
converts it when given the layer sizes.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt import _normal_sampler


def mlp_param_shapes(sizes: Sequence[int]) -> Dict:
    """The params tree as shapes for layer sizes ``[in, hidden..., out]``."""
    return {f"layer{i}": {"w": (sizes[i], sizes[i + 1]),
                          "b": (sizes[i + 1],)}
            for i in range(len(sizes) - 1)}


def mlp_init(seed_or_generator: Union[int, torch.Generator],
             sizes: Sequence[int], device: DeviceLike = None) -> Dict:
    """f32 params: weights normal over sqrt(fan-in), biases zero."""
    dev = resolve_device(device)
    normal = _normal_sampler(seed_or_generator, dev)
    return {name: {"w": normal(s["w"], 1.0 / math.sqrt(s["w"][0])),
                   "b": torch.zeros(s["b"], device=dev)}
            for name, s in mlp_param_shapes(sizes).items()}


def mlp_forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        p = params[f"layer{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = F.relu(x)
    return x


def mlp_loss(params: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean negative log-likelihood of the labels ``batch["y"]`` [B] under
    the logits of ``batch["x"]`` [B, in]."""
    logp = F.log_softmax(mlp_forward(params, batch["x"]), dim=-1)
    return -torch.gather(logp, -1, batch["y"][:, None].long())[:, 0].mean()

"""Predictors: checkpoint -> inference callable.

Port of ``ray_tpu/train/predictor.py`` (reference
``python/ray/train/predictor.py``: Predictor base with from_checkpoint /
predict, and ``train/torch/torch_predictor.py``).  ``TorchPredictor`` runs
a pure ``apply_fn(params, x)`` under ``torch.no_grad()`` on an explicit
device: the params move there once, in ``__init__`` (as the reference's
torch predictor moves the model to the card once), so a batch costs one
host-to-device copy of its input.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, Union

from ray_tpu_torch.air import _tensor_tree
from ray_tpu_torch.air.checkpoint import Checkpoint

if TYPE_CHECKING:   # numpy is not imported with the package (the raylet
    import numpy as np  # imports it for its train counters)

DataBatchType = Union["np.ndarray", Dict[str, "np.ndarray"]]


class Predictor:
    """Base predictor contract (reference train/predictor.py:71)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, data: DataBatchType, **kwargs) -> DataBatchType:
        raise NotImplementedError


class TorchPredictor(Predictor):
    """Predictor over a pure ``apply_fn(params, x)`` on ``device`` (the
    first card when None; raises without one: pass ``device="cpu"`` for
    the CPU)."""

    def __init__(self, apply_fn: Callable, params: Any, device=None):
        import torch

        from ray_tpu_torch import resolve_device
        self._apply = apply_fn
        self._device = resolve_device(device)
        self._params = _tensor_tree.map_leaves(
            lambda x: torch.as_tensor(x).to(self._device), params)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, params_key: str = "params",
                        device=None) -> "TorchPredictor":
        data = checkpoint.to_dict()
        if params_key not in data:
            raise ValueError(
                f"checkpoint has no {params_key!r} entry "
                f"(keys: {sorted(data)})")
        return cls(apply_fn, data[params_key], device=device)

    def predict(self, data: DataBatchType, **kwargs) -> "np.ndarray":
        import torch
        x = _tensor_tree.map_leaves(
            lambda a: torch.as_tensor(a).to(self._device), data)
        with torch.no_grad():
            out = self._apply(self._params, x)
        return out.detach().cpu().numpy()

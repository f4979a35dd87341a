"""Distributed training orchestration (Ray Train equivalent) on cards.

Port of ``ray_tpu/train`` (reference ``python/ray/train/``:
BaseTrainer.fit (base_trainer.py:339), DataParallelTrainer
(data_parallel_trainer.py:56), BackendExecutor
(_internal/backend_executor.py:43), WorkerGroup
(_internal/worker_group.py:92)).  The framework backend is torch: workers
join one ``torch.distributed`` world (reference
``train/torch/config.py:113``), NCCL between cards and gloo on the CPU.
``TorchTrainer``/``TorchConfig`` take the place of the JAX package's
``JaxTrainer``/``JaxConfig``.  ``BaseTrainer.as_trainable()``
(base_trainer.py:500) hands any trainer to ``ray_tpu_torch.tune.Tuner``;
the package exports the reference's names and no others.  The trainers
that read Data's datasets (GBDT, sklearn, transformers) and
``BatchPredictor`` load when first named (``__getattr__``): importing
the package imports neither torch nor numpy, since the raylet imports it
for its train counters.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer, TrainingFailedError
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.predictor import Predictor, TorchPredictor
from ray_tpu_torch.train.torch.config import TorchConfig
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer

# The Data-bound names, each from its module (imported on first use).
_LAZY = {
    "BatchPredictor": "batch_predictor",
    "TransformersTrainer": "transformers_trainer",
    "load_model": "transformers_trainer",
    "GBDTTrainer": "gbdt_trainer",
    "SklearnTrainer": "gbdt_trainer",
    "load_estimator": "gbdt_trainer",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    return getattr(module, name)


__all__ = [
    "Backend",
    "BackendConfig",
    "BaseTrainer",
    "TrainingFailedError",
    "BatchPredictor",
    "DataParallelTrainer",
    "GBDTTrainer", "TransformersTrainer", "load_model",
    "SklearnTrainer",
    "load_estimator",
    "TorchConfig",
    "TorchTrainer",
    "TorchPredictor",
    "Predictor",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("train")
del _rlu

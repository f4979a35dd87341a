"""Distributed training orchestration (Ray Train equivalent) on cards.

Port of ``ray_tpu/train`` (reference ``python/ray/train/``:
BaseTrainer.fit (base_trainer.py:339), DataParallelTrainer
(data_parallel_trainer.py:56), BackendExecutor
(_internal/backend_executor.py:43), WorkerGroup
(_internal/worker_group.py:92)).  The framework backend is torch: workers
join one ``torch.distributed`` world (reference
``train/torch/config.py:113``), NCCL between cards and gloo on the CPU.
``TorchTrainer``/``TorchConfig`` take the place of the JAX package's
``JaxTrainer``/``JaxConfig``.  The trainers that read Data's datasets
(GBDT, sklearn, transformers) and ``BatchPredictor`` come with the port of
Data.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer, TrainingFailedError
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.predictor import Predictor, TorchPredictor
from ray_tpu_torch.train.torch.config import TorchConfig
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer

__all__ = [
    "Backend",
    "BackendConfig",
    "BaseTrainer",
    "TrainingFailedError",
    "DataParallelTrainer",
    "TorchConfig",
    "TorchTrainer",
    "TorchPredictor",
    "Predictor",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("train")
del _rlu

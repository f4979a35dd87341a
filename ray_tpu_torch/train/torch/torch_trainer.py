"""TorchTrainer: the port's flagship DataParallelTrainer.

Port of ``ray_tpu/train/jax/jax_trainer.py`` (JaxTrainer) and
``ray_tpu/train/torch/torch_trainer.py`` (reference
``python/ray/train/torch/torch_trainer.py``: TorchTrainer =
DataParallelTrainer + TorchConfig).  The train_loop_per_worker is one rank
of a torch.distributed world (NCCL on cards, gloo on the CPU; see
``config.py``): its step runs on the worker's card, and a mesh over the
world (``ray_tpu_torch.parallel``) shards it as the JAX package's pjit
step is sharded.  ``prepare_model``/``prepare_data_loader`` give the
reference's DDP conveniences.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


class TorchTrainer(DataParallelTrainer):
    _backend_config_cls = TorchConfig

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)

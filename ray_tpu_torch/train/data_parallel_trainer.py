"""DataParallelTrainer: SPMD train loop over a worker gang.

Port of ``ray_tpu/train/data_parallel_trainer.py`` (reference
``python/ray/train/data_parallel_trainer.py:56``: training_loop:343 drives
BackendExecutor; dataset shards via _internal/dataset_spec.py +
Dataset.split).  The train_loop_per_worker runs once per worker process;
with more than one worker, each invocation is one rank of a
``torch.distributed`` world (see ``train/torch/config.py``).  A dataset is
sharded by duck typing: anything with ``split(n, equal=True)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor, TrainingWorkerError)


class DataParallelTrainer(BaseTrainer):
    _backend_config_cls = BackendConfig

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._backend_config = backend_config or self._backend_config_cls()

    def training_loop(self) -> None:
        executor = BackendExecutor(
            self._backend_config, self.scaling_config,
            max_failures=self.run_config.failure_config.max_failures)
        # Tune's trainer trial shuts the gang down through this when the
        # trial stops (tune/trainable.py _TrainerTrainable.cleanup).
        self._executor = executor
        executor.start()
        train_fn = self._wrap_train_loop()
        config = self._train_loop_config
        try:
            executor.start_training(
                train_fn, config, checkpoint=self.resume_from_checkpoint)
            while True:
                try:
                    results = executor.get_next_results()
                except TrainingWorkerError as e:
                    # A planned preemption handoff (worker checkpointed and
                    # exited clean) restarts without burning the budget.
                    if not executor.recover(
                            train_fn, config,
                            preempted=getattr(e, "preempted", False)):
                        raise
                    continue
                if results is None:
                    break
                # Forward rank-0 metrics upward (driver session: Tune or
                # the direct runner), attaching the aggregated checkpoint.
                air_session.report(results[0],
                                   checkpoint=executor.latest_checkpoint)
        finally:
            self._final_checkpoint = executor.latest_checkpoint
            executor.shutdown()

    def _wrap_train_loop(self) -> Callable:
        """Hook for sharding datasets into the per-worker fn."""
        datasets = self.datasets
        user_fn = self._train_loop
        if not datasets:
            return user_fn

        def wrapped(config=None):
            # Late module import: this closure is shipped by value, so any
            # global it captured at pickle time would be a disconnected
            # snapshot on the worker -- resolve the real module dict here.
            from ray_tpu_torch.air import session
            from ray_tpu_torch.train import data_parallel_trainer as dpt
            rank = session.get_world_rank()
            world = session.get_world_size()
            shards = {}
            for name, ds in datasets.items():
                split = getattr(ds, "split", None)
                if callable(split):
                    shards[name] = ds.split(world, equal=True)[rank]
                else:
                    shards[name] = ds
            dpt._DATASET_SHARDS.update(shards)
            try:
                import inspect
                if inspect.signature(user_fn).parameters:
                    return user_fn(config if config is not None else {})
                return user_fn()
            finally:
                dpt._DATASET_SHARDS.clear()

        return wrapped


# Per-worker dataset shards exposed through session.get_dataset_shard
# (reference: air/session.py get_dataset_shard).
_DATASET_SHARDS: Dict[str, Any] = {}


def get_dataset_shard(name: str = "train"):
    if name not in _DATASET_SHARDS:
        raise KeyError(f"no dataset shard named '{name}' "
                       f"(have {list(_DATASET_SHARDS)})")
    return _DATASET_SHARDS[name]

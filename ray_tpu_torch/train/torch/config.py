"""Torch distributed backend: the worker gang as one torch.distributed world.

Port of ``ray_tpu/train/torch/config.py`` and ``ray_tpu/train/jax/config.py``
(reference ``python/ray/train/torch/config.py``: ``_TorchBackend.on_start:132``
-> ``_setup_torch_process_group:69`` -> ``dist.init_process_group:113``).
Rank 0 publishes a free port; every worker joins the world through that TCP
rendezvous.  The backend is NCCL when the workers hold cards and gloo
otherwise; a card-holding worker first makes its first visible card its
current device.  As in both reference backends the world is only set up
for more than one worker, unless ``distributed`` says otherwise (None
means "when more than one worker", as ``JaxConfig.distributed``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig

logger = logging.getLogger(__name__)


@dataclass
class TorchConfig(BackendConfig):
    """distributed: None = set up a world when num_workers > 1."""

    distributed: Optional[bool] = None
    init_timeout_s: float = 120.0

    def backend_cls(self):
        return _TorchBackend


def _setup_torch_process_group(backend: str, init_method: str,
                               rank: int, world_size: int,
                               timeout_s: float) -> bool:
    import datetime

    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.is_initialized()


def _shutdown_torch_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _holds_cards() -> bool:
    return bool(os.environ.get("CUDA_VISIBLE_DEVICES"))


class _TorchBackend(Backend):
    _distributed = False

    def on_start(self, worker_group, backend_config: TorchConfig):
        distributed = backend_config.distributed
        if distributed is None:
            distributed = len(worker_group) > 1
        self._distributed = distributed
        if not distributed:
            return
        import ray_tpu_torch
        backend = ("nccl" if worker_group.execute_single(0, _holds_cards)
                   else "gloo")
        ip = worker_group.workers[0].ip
        port = worker_group.execute_single(0, _free_port)
        init_method = f"tcp://{ip}:{port}"
        logger.info("torch.distributed %s rendezvous at %s", backend,
                    init_method)
        refs = [
            w.actor.execute.remote(
                _setup_torch_process_group, backend, init_method, w.rank,
                len(worker_group), backend_config.init_timeout_s)
            for w in worker_group.workers
        ]
        ray_tpu_torch.get(refs, timeout=backend_config.init_timeout_s + 30)

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        if self._distributed:
            worker_group.execute(_shutdown_torch_process_group)


def prepare_model(model, parallel_strategy: Optional[str] = "ddp",
                  device=None):
    """Move ``model`` to ``device`` (this worker's first card when None;
    raises without one: pass ``device="cpu"`` for the CPU) and wrap it for
    data-parallel training when a world of more than one rank is up
    (reference ``train/torch/train_loop_utils.py prepare_model:70``: DDP,
    with ``device_ids`` on a card)."""
    import torch.distributed as dist

    from ray_tpu_torch import resolve_device
    dev = resolve_device(device)
    model = model.to(dev)
    if parallel_strategy and dist.is_initialized() and \
            dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        if dev.type == "cuda":
            return DistributedDataParallel(model, device_ids=[dev.index])
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(dataset, batch_size: int, shuffle: bool = True):
    """DataLoader with a DistributedSampler when a process group is up
    (reference: train_loop_utils.py prepare_data_loader)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, DistributedSampler
    sampler = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        sampler = DistributedSampler(dataset)
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      shuffle=shuffle if sampler is None else False)

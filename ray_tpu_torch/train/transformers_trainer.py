"""TransformersTrainer: fine-tune Hugging Face torch models on the gang.

Port of ``ray_tpu/train/transformers_trainer.py`` (reference
``python/ray/train/huggingface/huggingface_trainer.py``: HuggingFaceTrainer
wraps transformers' Trainer inside a DataParallelTrainer worker loop).
The JAX package jits one optax step over a Flax model; here the worker
loop builds the user's torch model (e.g. ``transformers.GPT2LMHeadModel``),
prepares it for the ``TorchConfig`` world (DDP when there is more than one
worker) and trains it with ``torch.optim.AdamW`` on the same shifted
causal-LM cross-entropy, fed by the framework's Dataset shards (host
numpy -> device).  As in the reference, the model runs without dropout
(Flax's ``__call__`` defaults to ``train=False``).

The model is constructed inside each worker by a user ``model_init_fn``
(e.g. ``lambda: GPT2LMHeadModel(GPT2Config(...))``) — constructing from a
config works fully offline; loading pretrained weights works wherever
HF's cache/network does.  The loop runs on the worker's card unless
``train_loop_config["device"]`` says otherwise (``"cpu"``).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


def _default_loop(config: Dict[str, Any]) -> None:
    """Per-worker loop: causal-LM fine-tuning over the shard."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train.data_parallel_trainer import get_dataset_shard
    from ray_tpu_torch.train.torch.config import prepare_model

    model = config["model_init_fn"]()
    ckpt = session.get_checkpoint()
    start_epoch = 0
    if ckpt is not None:
        state = ckpt.to_dict()
        model.load_state_dict(state["params"])
        start_epoch = state["epoch"] + 1   # the optimizer restarts (moments
        # are cheap to rebuild at this scale)
    model = prepare_model(model, device=config.get("device"))
    model.eval()                           # no dropout, as the reference
    inner = getattr(model, "module", model)
    device = next(inner.parameters()).device
    opt = torch.optim.AdamW(model.parameters(), lr=config.get("lr", 5e-4),
                            weight_decay=config.get("weight_decay", 0.0))

    def loss_fn(tokens):
        # Causal LM: predict token t+1 from prefix <= t.
        logits = model(tokens[:, :-1]).logits
        return F.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            tokens[:, 1:].reshape(-1))

    batch_size = config.get("batch_size", 8)
    shard = get_dataset_shard("train")
    for epoch in range(start_epoch, config.get("epochs", 1)):
        losses = []
        for batch in shard.iter_batches(batch_size=batch_size,
                                        batch_format="numpy"):
            tokens = torch.from_numpy(
                np.asarray(batch["tokens"], np.int64)).to(device)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(tokens)
            loss.backward()
            opt.step()
            losses.append(float(loss))
        session.report(
            {"loss": float(np.mean(losses)), "epoch": epoch},
            checkpoint=Checkpoint.from_dict({
                "params": {k: v.detach().cpu()
                           for k, v in inner.state_dict().items()},
                "epoch": epoch}))


def _torch_only_transformers() -> None:
    """Set transformers' own switches before it is imported: it imports
    TensorFlow and Flax, and with them JAX, whenever it finds them
    installed, and a torch trainer needs neither.  A value the process's
    environment already has is kept."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")


def _torch_only(loop: Callable) -> Callable:
    """``loop``, with the switches set in the worker first."""
    @functools.wraps(loop)
    def run(*args):
        _torch_only_transformers()
        return loop(*args)
    return run


class TransformersTrainer(DataParallelTrainer):
    """Fine-tune a HF torch model with the default causal-LM loop, or any
    user loop via ``train_loop_per_worker`` (same contract as
    DataParallelTrainer — the reference's trainer_init_per_worker
    pattern maps to ``model_init_fn``)."""

    _backend_config_cls = TorchConfig

    def __init__(self, *,
                 model_init_fn: Callable[[], Any],
                 train_loop_per_worker: Optional[Callable] = None,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        cfg = dict(train_loop_config or {})
        cfg["model_init_fn"] = model_init_fn
        super().__init__(
            _torch_only(train_loop_per_worker or _default_loop),
            train_loop_config=cfg,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)


def load_model(checkpoint: Checkpoint, model_init_fn: Callable[[], Any]):
    """Rebuild a fine-tuned model from a TransformersTrainer checkpoint
    (reference: HuggingFaceCheckpoint.get_model), on the CPU."""
    _torch_only_transformers()
    model = model_init_fn()
    model.load_state_dict(checkpoint.to_dict()["params"])
    return model

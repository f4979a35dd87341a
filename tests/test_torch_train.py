"""Train layer tests, the port's mirror of tests/test_train.py.

Reference shape: python/ray/train/tests/test_data_parallel_trainer.py
(fit reports metrics, ranks assigned, checkpoint restore, failure
recovery).  Workers run single-process torch on the CPU (no world is set
up for them: ``TorchConfig(distributed=False)``); the multi-process path
is exercised by tests/test_torch_train_distributed.py.  This module imports
no JAX: the cluster's workers import it to run its loops.
"""

import pytest

from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch.air import Checkpoint, RunConfig, ScalingConfig, session
from ray_tpu_torch.air.config import FailureConfig
from ray_tpu_torch.train import TorchConfig, TorchTrainer, TrainingFailedError


def _loop_basic(config):
    for i in range(config["iters"]):
        session.report({"loss": 1.0 / (i + 1),
                        "rank": session.get_world_rank(),
                        "world": session.get_world_size()})


def test_trainer_reports_metrics(ray_start):  # noqa: F811
    trainer = TorchTrainer(
        _loop_basic,
        train_loop_config={"iters": 3},
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=2),
    )
    result = trainer.fit()
    assert len(result.metrics_history) == 3
    assert result.metrics["loss"] == pytest.approx(1 / 3)
    assert result.metrics["rank"] == 0
    assert result.metrics["world"] == 2


def _loop_ckpt(config):
    ckpt = session.get_checkpoint()
    start = ckpt.to_dict()["step"] if ckpt else 0
    for i in range(start, 4):
        session.report({"step_done": i},
                       checkpoint=Checkpoint.from_dict({"step": i + 1}))


def test_trainer_checkpoint_and_resume(ray_start):  # noqa: F811
    trainer = TorchTrainer(
        _loop_ckpt,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
    )
    result = trainer.fit()
    assert result.checkpoint is not None
    assert result.checkpoint.to_dict()["step"] == 4

    resumed = TorchTrainer(
        _loop_ckpt,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        resume_from_checkpoint=Checkpoint.from_dict({"step": 2}),
    )
    r2 = resumed.fit()
    # Resumed from step 2 -> only steps 2,3 run.
    assert len(r2.metrics_history) == 2


def _loop_fails(config):
    raise RuntimeError("boom in train loop")


def test_trainer_surfaces_worker_error(ray_start):  # noqa: F811
    trainer = TorchTrainer(
        _loop_fails,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
    )
    with pytest.raises(TrainingFailedError, match="boom"):
        trainer.fit()


def _loop_fail_once(config):
    import os
    import tempfile
    marker = os.path.join(tempfile.gettempdir(), config["marker"])
    ckpt = session.get_checkpoint()
    start = ckpt.to_dict()["step"] if ckpt else 0
    for i in range(start, 4):
        if i == 2 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("transient failure at step 2")
        session.report({"step": i},
                       checkpoint=Checkpoint.from_dict({"step": i + 1}))


def test_trainer_recovers_from_failure(ray_start, tmp_path):  # noqa: F811
    import uuid
    marker = f"rtt_fail_once_{uuid.uuid4().hex}"
    trainer = TorchTrainer(
        _loop_fail_once,
        train_loop_config={"marker": marker},
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
    )
    result = trainer.fit()
    # Restarted from checkpoint step=2 after the injected failure.
    assert result.metrics["step"] == 3
    assert result.checkpoint.to_dict()["step"] == 4


def _loop_torch_train(config):
    """The torch twin of the reference's optax SGD regression: 60 steps of
    SGD(0.1) on a mean squared error, one full batch of 64 rows."""
    import torch

    gen = torch.Generator().manual_seed(0)
    w = torch.zeros(4, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    xs = torch.randn((64, 4), generator=gen)
    true_w = torch.tensor([1.0, -2.0, 3.0, 0.5])
    ys = xs @ true_w
    for _ in range(60):
        opt.zero_grad()
        loss = torch.mean((xs @ w - ys) ** 2)
        loss.backward()
        opt.step()
    session.report({"loss": float(loss)},
                   checkpoint=Checkpoint.from_pytree({"w": w.detach()}))


def test_trainer_torch_end_to_end(ray_start):  # noqa: F811
    trainer = TorchTrainer(
        _loop_torch_train,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
    )
    result = trainer.fit()
    assert result.metrics["loss"] < 1e-2
    import numpy as np
    w = result.checkpoint.to_pytree()["w"]
    np.testing.assert_allclose(w.numpy(), [1.0, -2.0, 3.0, 0.5], atol=0.1)


class _FakeDataset:
    def __init__(self, items):
        self._items = items

    def split(self, n, equal=True):
        per = len(self._items) // n
        return [_FakeDataset(self._items[i * per:(i + 1) * per])
                for i in range(n)]

    def items(self):
        return self._items


def _loop_with_data(config):
    from ray_tpu_torch.train.data_parallel_trainer import get_dataset_shard
    shard = get_dataset_shard("train")
    session.report({"n_items": len(shard.items()),
                    "first": shard.items()[0]})


def test_trainer_dataset_sharding(ray_start):  # noqa: F811
    trainer = TorchTrainer(
        _loop_with_data,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": _FakeDataset(list(range(8)))},
    )
    result = trainer.fit()
    assert result.metrics["n_items"] == 4


def _loop_many(config):
    for i in range(50):
        session.report({"loss": float(i)})


def test_run_config_stop_criteria(ray_start):  # noqa: F811
    trainer = TorchTrainer(
        _loop_many,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(stop={"training_iteration": 5}),
    )
    result = trainer.fit()
    assert len(result.metrics_history) == 5

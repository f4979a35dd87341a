"""Tune on the card.

* A function trial given ``{"GPU": 1}`` by ``with_resources`` trains a
  small bf16 flash GPT (2 layers, width 128, [4, 256]) on its card for
  four AdamW steps and reports each loss; the losses are finite and
  equal an in-process run's from the same init on the same batches, and
  the card is free once the trial stops.
* chip_smoke.py's runtime_tune step at 2 layers: a Tuner over a
  num_gpus=1 TorchTrainer under ASHA, one trial at a time, every trial's
  losses equal the in-process run's, the runner's stops ASHA's replay,
  the best checkpoint's hash the in-process params', the card free after
  every trial, exact launches.

The tests need a CUDA card and skip without one.  This module imports
nothing of JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_tune_gpu.py
"""

import dataclasses
import os
import sys
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.models import GPTConfig
from ray_tpu_torch.tune import TuneConfig, Tuner

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=512, max_seq_len=256, num_layers=2, num_heads=2,
           embed_dim=128, attention="flash", remat=True,
           remat_policy="dots", ce_block=128)
STEPS = 4


@pytest.fixture(scope="module")
def card_cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_tune_gpu.py`")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)       # chip_smoke.py; workers inherit it
    ray_tpu_torch.init(num_cpus=4, object_store_memory=2 << 30)
    yield
    ray_tpu_torch.shutdown()


def _batches():
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, CFG["vocab_size"], (4, CFG["max_seq_len"] + 1),
                          generator=gen) for _ in range(STEPS)]


def _train(device, lr):
    from ray_tpu_torch.models import make_train_state, make_train_step
    cfg = GPTConfig(dtype=torch.bfloat16, **CFG)
    params, opt = make_train_state(0, cfg, learning_rate=lr,
                                   weight_decay=1e-4, device=device)
    step = make_train_step(cfg, opt)
    return [float(step(params, {"tokens": b.to(device)})["loss"])
            for b in _batches()]


def _trial(config):
    losses = _train(torch.device("cuda", 0), config["lr"])
    for loss in losses:
        tune.report({"loss": loss,
                     "cards": os.environ["CUDA_VISIBLE_DEVICES"],
                     "device_count": torch.cuda.device_count()})


def test_function_trial_trains_on_its_card(card_cluster):
    results = Tuner(
        tune.with_resources(_trial, {"CPU": 1, "GPU": 1}),
        param_space={"lr": 1e-3},
        tune_config=TuneConfig(metric="loss", mode="min")).fit()
    assert not results.errors, results.errors
    [r] = list(results)
    hist = r.metrics_history
    assert [m["cards"] for m in hist] == ["0"] * STEPS
    assert hist[0]["device_count"] == 1
    got = [m["loss"] for m in hist]
    assert all(torch.isfinite(torch.tensor(got)))
    assert got == _train(torch.device("cuda", 0), 1e-3)
    deadline = time.monotonic() + 60
    while ray_tpu_torch.available_resources().get("GPU") != 1.0:
        assert time.monotonic() < deadline, "the card never came back"
        time.sleep(0.1)


def test_tune_a_gpu_trainer_under_asha(card_cluster):
    """The runtime_tune step at 2 layers of GPT-2-small."""
    import chip_smoke
    cfg = dataclasses.replace(
        GPTConfig.gpt2_small(), num_layers=2, dtype=torch.bfloat16,
        attention="flash", remat=True, remat_policy="dots", ce_block=256)
    out = chip_smoke.runtime_tune(torch.device("cuda", 0), cfg)
    assert any(it < chip_smoke.TUNE_MAX_T for it in out["stops"].values())
    ran = sum(t["iterations"] for t in out["trials"])
    assert out["launches"] == (4 * ran, 2 * ran, 2 * ran, 0, 0, 0)
    assert out["gpu_actors_max"] == 1

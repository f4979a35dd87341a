"""TransformersTrainer: fine-tune a HF torch model through the gang, on the
port's cluster: ``test_transformers_trainer.py``'s case, with
``GPT2LMHeadModel`` where the reference builds ``FlaxGPT2LMHeadModel``.

Reference shape: python/ray/train/tests/test_huggingface_trainer.py
(train over Dataset shards, metrics via session.report, checkpoint
round-trips into a usable model).  Runs hermetically: the model is
built from a config (no pretrained download), on the CPU
(``device="cpu"``), in a driver process of its own.  This module imports
no JAX.
"""

import os
import pathlib
import subprocess
import sys

ROOT = str(pathlib.Path(__file__).resolve().parents[1])

SCRIPT = """
import numpy as np
import torch
import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.air import ScalingConfig
from ray_tpu_torch.train import TransformersTrainer, load_model

ray_tpu_torch.init(num_cpus=4)

def model_init():
    from transformers import GPT2Config, GPT2LMHeadModel
    torch.manual_seed(0)
    return GPT2LMHeadModel(GPT2Config(
        n_layer=2, n_head=2, n_embd=32, n_positions=64, vocab_size=64))

# A deterministic 2-token repeating corpus: loss must fall fast.
rng = np.random.default_rng(0)
rows = [{"tokens": np.tile(rng.integers(0, 64, 2), 9)[:17]}
        for _ in range(64)]
ds = rd.from_items(rows).repartition(2)

trainer = TransformersTrainer(
    model_init_fn=model_init,
    train_loop_config={"epochs": 3, "batch_size": 8, "lr": 5e-3,
                       "device": "cpu"},
    scaling_config=ScalingConfig(num_workers=2),
    datasets={"train": ds})
result = trainer.fit()
print("LOSS_SERIES", [round(m["loss"], 3) for m in result.metrics_history])
assert result.metrics["epoch"] == 2
assert result.metrics_history[-1]["loss"] < result.metrics_history[0]["loss"]

model = load_model(result.checkpoint, model_init)
logits = model(torch.as_tensor([[1, 2, 3]])).logits
assert logits.shape == (1, 3, 64)
ray_tpu_torch.shutdown()
print("TRANSFORMERS_TRAINER_OK")
"""


def test_transformers_trainer_end_to_end():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RT_") and k != "CUDA_VISIBLE_DEVICES"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "TRANSFORMERS_TRAINER_OK" in r.stdout

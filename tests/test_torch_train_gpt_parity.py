"""A one-worker TorchTrainer runs the port's GPT training step, held to
the JAX package's.

The worker (``device="cpu"``) trains a small GPT (2 layers, width 32,
flash, remat "dots", blocked CE) from the JAX init (``params_from_jax``)
with AdamW(3e-4, b2 0.95, wd 1e-4) on three numpy-seeded batches, and
reports each step's loss and grad norm through the session.  They are held
to ``ray_tpu.models.gpt.make_train_step`` with ``optax.adamw(3e-4,
b2=0.95)`` on the same batches in this process: loss rtol 1e-5, grad norm
rtol 1e-4 (the tolerances of test_torch_gpt_train.py, f32 on both sides).
The loop lives in ``_torch_train_loops.py``: this module imports JAX and
the workers must not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import _torch_train_loops as loops
from _torch_runtime import ray_start  # noqa: F401
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.air import ScalingConfig
from ray_tpu_torch.train import TorchTrainer

CFG = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
           embed_dim=32, attention="flash", remat_policy="dots", ce_block=8)


def test_trainer_losses_match_jax_train_step(ray_start):  # noqa: F811
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **CFG)
    jparams = jgpt.gpt_init(jax.random.PRNGKey(0), jcfg)
    batches = [np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (4, CFG["max_seq_len"] + 1), dtype=np.int64)
        for seed in (1, 2, 3)]
    result = TorchTrainer(
        loops.loop_gpt_train,
        train_loop_config={"cfg": CFG, "batches": batches,
                           "params": jax.tree_util.tree_map(np.asarray,
                                                            jparams)},
        scaling_config=ScalingConfig(num_workers=1),
    ).fit()
    got = result.metrics_history
    assert len(got) == 3

    tx = optax.adamw(3e-4, b2=0.95)
    step = jgpt.make_train_step(jcfg, tx, donate=False)
    p, state = jparams, tx.init(jparams)
    for toks, m in zip(batches, got):
        p, state, jm = step(p, state, {"tokens": jnp.asarray(toks,
                                                             jnp.int32)})
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-4)

"""Multi-process torch.distributed training under TorchTrainer.

The port's mirror of tests/test_train_distributed.py (reference
python/ray/train/torch/config.py:69-113 ``_setup_torch_process_group``):
TorchTrainer launches 2 real worker processes, the gang forms one gloo
world through rank 0's TCP rendezvous, and collectives run ACROSS the
process boundary.  The JAX package skips its three cases on the CPU
(jaxlib's CPU backend has no multi-process collectives); over gloo they
run here.  The GPT step on a slice-aligned mesh is held to the JAX
package's ``gpt_loss`` on the whole batch in this process, at rtol 1e-5
(f32 on both sides, the loss tolerance of test_torch_gpt_train.py).

The loops live in ``_torch_train_loops.py``: this module imports JAX and
the workers must not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_train_loops as loops
from _torch_runtime import ray_start_fresh  # noqa: F401
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.air import ScalingConfig
from ray_tpu_torch.train import TorchConfig, TorchTrainer


def test_torch_distributed_two_processes(ray_start_fresh):  # noqa: F811
    trainer = TorchTrainer(
        loops.loop_allreduce,
        torch_config=TorchConfig(distributed=True),
        scaling_config=ScalingConfig(num_workers=2),
    )
    m = trainer.fit().metrics
    assert m["num_processes"] == 2
    assert m["backend"] == "gloo"       # no cards: gloo, never NCCL
    # ranks 0 and 1 each contribute their rank.
    assert m["psum"] == pytest.approx(1.0)


def test_torch_distributed_data_parallel_training(
        ray_start_fresh):  # noqa: F811
    trainer = TorchTrainer(
        loops.loop_dp_regression,
        scaling_config=ScalingConfig(num_workers=2),
    )
    result = trainer.fit()
    assert result.metrics["loss"] < 1e-2
    assert result.metrics["w_err"] < 0.2


CFG = dict(vocab_size=128, max_seq_len=32, num_layers=1, num_heads=2,
           embed_dim=16)


def test_torch_trainer_multislice_mesh(ray_start_fresh):  # noqa: F811
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **CFG)
    jparams = jgpt.gpt_init(jax.random.PRNGKey(0), jcfg)
    trainer = TorchTrainer(
        loops.loop_slice_mesh_gpt,
        train_loop_config={"cfg": CFG, "params": jax.tree_util.tree_map(
            np.asarray, jparams)},
        scaling_config=ScalingConfig(num_workers=2),
    )
    m = trainer.fit().metrics
    assert m["procs"] == 2
    assert m["dp"] >= 2          # dp spans the two processes
    assert np.isfinite(m["loss"])
    assert m["loss"] < 20
    # Rank 0's rows come first on the dp axis: the whole batch is both
    # ranks' rows, which rank 0's RandomState(0) and RandomState(1) drew.
    rows = np.concatenate([np.random.RandomState(r).randint(
        0, CFG["vocab_size"], (len(m["rows"]), CFG["max_seq_len"] + 1))
        for r in range(2)])
    assert rows[:len(m["rows"])].tolist() == m["rows"]
    want = jgpt.gpt_loss(jparams, {"tokens": jnp.asarray(rows, jnp.int32)},
                         jcfg)
    np.testing.assert_allclose(m["loss"], float(want), rtol=1e-5)

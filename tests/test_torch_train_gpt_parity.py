"""A one-worker TorchTrainer runs the port's GPT training step, held to
the JAX package's.

The worker (``device="cpu"``) trains a small GPT (2 layers, width 32,
flash, remat "dots", blocked CE) from the JAX init (``params_from_jax``)
with AdamW(3e-4, b2 0.95, wd 1e-4) on three numpy-seeded batches, and
reports each step's loss and grad norm through the session.  They are held
to ``ray_tpu.models.gpt.make_train_step`` with ``optax.adamw(3e-4,
b2=0.95)`` on the same batches in this process: loss rtol 1e-5, grad norm
rtol 1e-4 (the tolerances of test_torch_gpt_train.py, f32 on both sides).
The second case feeds the trainer from a shuffled Dataset through
``iter_device_batches(device="cpu")``, against the JAX step fed by the JAX
package's Dataset of the same rows and seed.  The third tunes the same
trainer with ``Tuner`` over two learning rates under ASHA, one trial at a
time: each trial's losses are held to the JAX step at its rate, and the
trials the port's runner stopped, and where, to the JAX package's
``ASHAScheduler`` fed the JAX losses in the same trial order.  The loops
live in ``_torch_train_loops.py``: this module imports JAX and the
workers must not.
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


def test_dataset_fed_trainer_matches_jax_train_step(ray_start):  # noqa: F811
    """The same GPT and settings, fed by the trainer's dataset shard through
    ``iter_device_batches(device="cpu")``: 12 seeded rows in 4 blocks,
    ``random_shuffle(seed=0)``, batches of 4.  The JAX side's batches come
    from the JAX package's Dataset of the same rows and seed, on a cluster
    of the same size; both take the same tokens, and the losses and grad
    norms agree within the tolerances above."""
    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu_torch import data as rd

    rows = np.random.default_rng(4).integers(
        0, CFG["vocab_size"], (12, CFG["max_seq_len"] + 1), dtype=np.int64)
    ray_tpu.init(num_cpus=16)
    try:
        want_batches = [b["data"] for b in jdata.from_numpy(
            rows, parallelism=4).random_shuffle(seed=0).iter_batches(
                batch_size=4)]
    finally:
        ray_tpu.shutdown()
    assert len(want_batches) == 3

    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **CFG)
    jparams = jgpt.gpt_init(jax.random.PRNGKey(0), jcfg)
    result = TorchTrainer(
        loops.loop_gpt_train_from_dataset,
        train_loop_config={"cfg": CFG, "batch_size": 4,
                           "params": jax.tree_util.tree_map(np.asarray,
                                                            jparams)},
        scaling_config=ScalingConfig(num_workers=1),
        datasets={"train": rd.from_numpy(rows, parallelism=4)
                  .random_shuffle(seed=0)},
    ).fit()
    got = result.metrics_history
    assert len(got) == 3

    tx = optax.adamw(3e-4, b2=0.95)
    step = jgpt.make_train_step(jcfg, tx, donate=False)
    p, state = jparams, tx.init(jparams)
    for toks, m in zip(want_batches, got):
        np.testing.assert_array_equal(np.asarray(m["tokens"]), toks)
        p, state, jm = step(p, state, {"tokens": jnp.asarray(toks,
                                                             jnp.int32)})
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]),
                                   rtol=1e-4)


class _Trial:
    """What ASHAScheduler reads of a trial."""

    def __init__(self, trial_id):
        self.trial_id = trial_id
        self.scratch = {}


def test_tuned_trainer_matches_jax_steps_and_asha(ray_start):  # noqa: F811
    """``Tuner(TorchTrainer)`` over lr 1e-2 and 1e-4 (in that order) with
    ``ASHAScheduler(max_t=4, grace_period=1, reduction_factor=2)`` and
    ``max_concurrent_trials=1`` on four batches.  Both trials take the
    same first loss (the same init and batch); at the second rung the
    1e-4 trial trails the 1e-2 trial's loss and is stopped there, while
    the 1e-2 trial runs to max_t."""
    from ray_tpu.tune.schedulers import ASHAScheduler as JaxASHA
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune import TuneConfig, Tuner
    from ray_tpu_torch.tune.schedulers import ASHAScheduler

    lrs = [1e-2, 1e-4]
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **CFG)
    jparams = jgpt.gpt_init(jax.random.PRNGKey(0), jcfg)
    batches = [np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (4, CFG["max_seq_len"] + 1), dtype=np.int64)
        for seed in (1, 2, 3, 4)]
    trainer = TorchTrainer(
        loops.loop_gpt_train,
        train_loop_config={"cfg": CFG, "batches": batches,
                           "params": jax.tree_util.tree_map(np.asarray,
                                                            jparams)},
        scaling_config=ScalingConfig(num_workers=1))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(lrs)}},
        tune_config=TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=ASHAScheduler(max_t=4, grace_period=1,
                                    reduction_factor=2))).fit()
    assert not results.errors, results.errors
    got = {r.metrics["config"]["train_loop_config"]["lr"]:
           [m["loss"] for m in r.metrics_history] for r in results}
    assert sorted(got) == sorted(lrs)

    want = {}
    for lr in lrs:
        tx = optax.adamw(lr, b2=0.95)
        step = jgpt.make_train_step(jcfg, tx, donate=False)
        p, state = jparams, tx.init(jparams)
        want[lr] = []
        for toks in batches:
            p, state, jm = step(p, state, {
                "tokens": jnp.asarray(toks, jnp.int32)})
            want[lr].append(float(jm["loss"]))
        np.testing.assert_allclose(got[lr], want[lr][:len(got[lr])],
                                   rtol=1e-5)

    # The reference's ASHA on the JAX losses, trial after trial.
    ref = JaxASHA(max_t=4, grace_period=1, reduction_factor=2)
    ref.set_search_properties("loss", "min")
    stops = {}
    for i, lr in enumerate(lrs):
        trial = _Trial(f"{i:05d}")
        for it, loss in enumerate(want[lr], start=1):
            decision = ref.on_trial_result(
                None, trial, {"loss": loss, "training_iteration": it})
            if decision == "STOP":
                stops[lr] = it
                break
    assert stops == {1e-2: 4, 1e-4: 2}
    assert {lr: len(h) for lr, h in got.items()} == stops

"""Train gang chaos: mid-run SIGKILL, preemption handoff, torn restore.

The port's mirror of tests/test_train_chaos.py, with the same markers
(``-m slow`` or ``-m train_chaos`` selects it).  This module imports no
JAX: the cluster's workers import it to run its loops.

The determinism bar is bit-identical, not approximate: a run killed
mid-training and auto-recovered from its last verified checkpoint must
land on EXACTLY the loss an uninterrupted run lands on, because the
checkpoint carries params + host RNG + data position and the restart
replays the identical trajectory.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.air import RunConfig, ScalingConfig
from ray_tpu_torch.air.config import FailureConfig
from ray_tpu_torch.train import TorchConfig, TorchTrainer
from ray_tpu_torch.train import metrics as train_metrics
from ray_tpu_torch.train._internal import checkpoint_store as cs
from ray_tpu_torch.util import fault_injection

pytestmark = [pytest.mark.slow, pytest.mark.chaos, pytest.mark.train_chaos]

_TRUE_W = np.array([1.0, -2.0, 3.0, 0.5])


@contextlib.contextmanager
def _cluster(extra_env=None):
    ray_tpu_torch.init(num_cpus=8, _worker_env=dict(extra_env or {}))
    try:
        yield
    finally:
        with contextlib.suppress(Exception):
            ray_tpu_torch.shutdown()


def _sgd_step(w, rng_draw):
    """One deterministic SGD step on data drawn from the global RNG."""
    x = rng_draw(8, 4)
    y = x @ _TRUE_W
    err = x @ w - y
    loss = float(np.mean(err ** 2))
    w = w - 0.05 * (2.0 / len(y)) * (x.T @ err)
    return w, loss


def _control_losses(steps, seed):
    """Uninterrupted in-process run of the same math: the ground truth
    the killed-and-recovered run must reproduce bit-for-bit."""
    np.random.seed(seed)
    w, losses = np.zeros(4), []
    for _ in range(steps):
        w, loss = _sgd_step(w, np.random.randn)
        losses.append(loss)
    return losses


def _chaos_sgd_loop(config):
    """Worker train loop: every step synchronously commits a verified
    checkpoint (params + RNG + step) to the shared store, so whatever
    instant a SIGKILL lands, the restarted gang resumes from the last
    durable step and replays the identical trajectory."""
    import numpy as np
    from ray_tpu_torch.air import session
    from ray_tpu_torch.train._internal import checkpoint_store as cs

    store = cs.CheckpointStore(config["root"], keep=4)
    rc = store.restore_latest()
    if rc is not None:
        rc.restore_host_rng()
        w, start = rc.tree["w"], rc.step
    else:
        np.random.seed(config["seed"])
        w, start = np.zeros(4), 0
    session.report({"restored_from": start})
    for step in range(start, config["steps"]):
        w, loss = _sgd_step(w, np.random.randn)
        store.save(step + 1, {"w": w},
                   rng_state=cs.capture_rng_state(),
                   data_state=step + 1)
        session.report({"loss": loss, "step": step})
        time.sleep(config.get("sleep", 0.05))


def test_sigkill_midrun_recovers_bit_identical(tmp_path):
    """An abrupt worker SIGKILL mid-run: the gang supervisor observes the
    death, tears down, restarts from the last verified checkpoint, and
    the final loss is bit-identical to an uninterrupted run."""
    steps, seed = 40, 1234
    root = str(tmp_path / "store")
    control = _control_losses(steps, seed)
    train_metrics.reset()

    killed = {}

    def _killer():
        store = cs.CheckpointStore(root)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not killed:
            if len(store.list_steps()) >= 3:
                try:
                    killed.update(fault_injection.kill_train_worker(
                        mode="sigkill"))
                except Exception:
                    time.sleep(0.1)
            else:
                time.sleep(0.05)

    with _cluster():
        t = threading.Thread(target=_killer, daemon=True)
        t.start()
        trainer = TorchTrainer(
            _chaos_sgd_loop,
            train_loop_config={"root": root, "steps": steps, "seed": seed},
            torch_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=3)),
        )
        result = trainer.fit()
        t.join(timeout=10)

    assert killed, "killer thread never found a live train worker"
    # The run finished every step and recovered at least once.
    assert result.metrics["step"] == steps - 1
    assert train_metrics.stats()["train_recoveries"] >= 1
    # The resumed worker restarted from a non-zero verified checkpoint...
    restored = [m["restored_from"] for m in result.metrics_history
                if "restored_from" in m]
    assert restored and restored[-1] > 0
    # ...and the final loss is EXACTLY the uninterrupted run's.
    assert result.metrics["loss"] == control[-1]


def _preempt_loop(config):
    from ray_tpu_torch.air import Checkpoint, session
    ckpt = session.get_checkpoint()
    start = ckpt.to_dict()["step"] if ckpt else 0
    session.report({"restored_from": start})
    for step in range(start, config["steps"]):
        session.report({"step": step},
                       checkpoint=Checkpoint.from_dict({"step": step + 1}))
        time.sleep(config.get("sleep", 0.05))


def test_preempt_notice_clean_handoff(tmp_path):
    """The preempt_notice fault fires ~1s into every worker's loop; each
    incarnation checkpoints at the step boundary and exits CLEAN, and the
    supervisor restarts WITHOUT burning recovery budget (max_failures=0:
    any unplanned failure would abort the run) until the loop outruns the
    notice and completes."""
    steps = 60
    train_metrics.reset()
    env = fault_injection.env_for(
        preempt_notice={"after_s": 1.0, "grace_s": 30.0})
    with _cluster(env):
        trainer = TorchTrainer(
            _preempt_loop,
            train_loop_config={"steps": steps},
            torch_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(num_workers=1),
        )
        result = trainer.fit()

    assert result.metrics["step"] == steps - 1
    stats = train_metrics.stats()
    # Planned handoffs happened; none were booked as failures.
    assert stats["preemptions"] >= 1
    assert stats["train_recoveries"] == 0
    # Each handoff resumed from the preempted incarnation's checkpoint.
    restored = [m["restored_from"] for m in result.metrics_history
                if "restored_from" in m]
    assert restored[0] == 0 and restored[-1] > 0


def test_torn_checkpoint_restore_falls_back(tmp_path):
    """Resume against a store whose NEWEST checkpoint is torn post-commit:
    CRC verification rejects it, the run restores the previous intact one
    and still reproduces the uninterrupted trajectory bit-for-bit."""
    steps, seed = 20, 77
    root = str(tmp_path / "store")
    control = _control_losses(steps, seed)

    # Pre-populate the store: the same loop run in-process to step 10.
    np.random.seed(seed)
    store = cs.CheckpointStore(root, keep=4)
    w = np.zeros(4)
    for step in range(10):
        w, _ = _sgd_step(w, np.random.randn)
        store.save(step + 1, {"w": w},
                   rng_state=cs.capture_rng_state(), data_state=step + 1)
    # Tear the newest checkpoint AFTER its commit (post-commit bit-rot).
    shard = os.path.join(root, "ckpt-000000000010", "leaf_0.bin")
    blob = bytearray(open(shard, "rb").read())
    blob[-1] ^= 0xFF
    open(shard, "wb").write(bytes(blob))

    with _cluster():
        trainer = TorchTrainer(
            _chaos_sgd_loop,
            train_loop_config={"root": root, "steps": steps, "seed": seed,
                               "sleep": 0.0},
            torch_config=TorchConfig(distributed=False),
            scaling_config=ScalingConfig(num_workers=1),
        )
        result = trainer.fit()

    # Fallback: restored from step 9 (the previous intact checkpoint),
    # not 10 (torn) and not 0 (scratch).
    restored = [m["restored_from"] for m in result.metrics_history
                if "restored_from" in m]
    assert restored == [9]
    assert result.metrics["step"] == steps - 1
    assert result.metrics["loss"] == control[-1]

"""Preemption-tolerant training: store, async writer, supervisor, resume.

The port's mirror of tests/test_train_resilience.py: the same cases on
``ray_tpu_torch.train``, with the deterministic resume held on torch state
(params, AdamW state, torch's and numpy's RNG, the data cursor) and the
orbax seal cases on the DCP envelope.  This module imports no JAX: the
cluster's workers import it to run its loops.

Tier-1 coverage of the elastic-training layer without needing chaos
process kills (tests/test_train_chaos.py does those):

* CheckpointStore crash consistency — manifest is the commit point,
  partial/torn directories are invisible, CRC mismatches fall back to
  the previous intact checkpoint;
* AsyncCheckpointWriter — IO off the step loop, at most one write in
  flight, backpressure counted;
* deterministic resume — a run resumed from a checkpoint (params + host
  RNG + data position) reproduces the uninterrupted loss trajectory
  bit-for-bit;
* gang-supervisor state machine — restart budget (env + FailureConfig),
  exponential backoff, verified-checkpoint gate, preemption handoff via
  both the preempt() RPC and the preempt_notice fault.
"""

import os
import threading
import time

import numpy as np
import pytest

import torch

from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch.air import Checkpoint, RunConfig, ScalingConfig, session
from ray_tpu_torch.air.config import FailureConfig
from ray_tpu_torch.train import metrics as train_metrics
from ray_tpu_torch.train._internal import checkpoint_store as cs
from ray_tpu_torch.train._internal.backend_executor import BackendExecutor
from ray_tpu_torch.train._internal.worker_group import RayTrainWorker
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.util import fault_injection


@pytest.fixture(autouse=True)
def _clean_faults():
    fault_injection.clear_spec()
    yield
    fault_injection.clear_spec()


# -- CheckpointStore: commit protocol + verification ----------------------

def test_store_roundtrip_with_rng_and_data_state(tmp_path):
    store = cs.CheckpointStore(str(tmp_path))
    np.random.seed(7)
    tree = {"w": np.arange(8.0), "b": np.ones((2, 2))}
    store.save(3, tree, rng_state=cs.capture_rng_state(), data_state=42,
               meta={"note": "x"})
    expected_draw = np.random.rand(4)

    rc = store.restore_latest()
    assert rc.step == 3 and rc.data_state == 42
    assert rc.meta == {"note": "x"}
    np.testing.assert_array_equal(rc.tree["w"], tree["w"])
    np.testing.assert_array_equal(rc.tree["b"], tree["b"])
    # Restoring host RNG reproduces the exact next draw.
    np.random.seed(0)          # scramble
    rc.restore_host_rng()
    np.testing.assert_array_equal(np.random.rand(4), expected_draw)


def test_store_manifest_is_the_commit_point(tmp_path):
    store = cs.CheckpointStore(str(tmp_path))
    store.save(1, {"w": np.zeros(4)})
    # A manifest-less directory (crash before the manifest write) is not a
    # checkpoint: invisible to list_steps and restore_latest.
    torn = tmp_path / "ckpt-000000000002"
    torn.mkdir()
    (torn / "leaf_0.bin").write_bytes(b"garbage")
    # A .writing orphan (crash mid-write) is equally invisible.
    (tmp_path / "ckpt-000000000003.writing").mkdir()
    assert store.list_steps() == [1]
    assert store.restore_latest().step == 1


def test_store_crc_fallback_to_previous_intact(tmp_path):
    train_metrics.reset()
    store = cs.CheckpointStore(str(tmp_path))
    store.save(1, {"w": np.arange(4.0)})
    store.save(2, {"w": np.arange(4.0) * 2})
    # Post-commit bit-rot in the newest checkpoint's shard.
    shard = tmp_path / "ckpt-000000000002" / "leaf_0.bin"
    blob = bytearray(shard.read_bytes())
    blob[-1] ^= 0xFF
    shard.write_bytes(bytes(blob))

    with pytest.raises(cs.CorruptCheckpointError):
        store.verify(2)
    rc = store.restore_latest()
    assert rc.step == 1
    np.testing.assert_array_equal(rc.tree["w"], np.arange(4.0))
    assert train_metrics.stats()["ckpt_corrupt_skipped"] >= 1


def test_store_detects_truncation(tmp_path):
    store = cs.CheckpointStore(str(tmp_path))
    store.save(5, {"w": np.arange(32.0)})
    shard = os.path.join(str(tmp_path), "ckpt-000000000005", "leaf_0.bin")
    os.truncate(shard, os.path.getsize(shard) // 2)
    with pytest.raises(cs.CorruptCheckpointError, match="torn write"):
        cs.verify_checkpoint_dir(os.path.dirname(shard))
    assert store.restore_latest() is None


def test_store_gc_keeps_fallback_window(tmp_path):
    store = cs.CheckpointStore(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        store.save(step, {"w": np.full(2, float(step))})
    # Newest `keep` survive: the previous intact one IS the fallback.
    assert store.list_steps() == [3, 4]


# -- AsyncCheckpointWriter: overlap + one-in-flight -----------------------

def test_async_writer_overlaps_compute(tmp_path):
    store = cs.CheckpointStore(str(tmp_path))
    fault_injection.set_spec(slow_ckpt_io={"delay_s": 0.2})
    w = cs.AsyncCheckpointWriter(store)
    try:
        w.submit(1, {"w": np.zeros(4)})
        # The write is executor IO; the "step loop" (this thread) keeps
        # running while it is in flight.
        assert w.in_flight()
        compute_done_while_inflight = w.in_flight()
        w.wait()
        assert not w.in_flight()
        assert compute_done_while_inflight
        assert store.list_steps() == [1]
    finally:
        w.close()


def test_async_writer_one_in_flight_backpressure(tmp_path):
    store = cs.CheckpointStore(str(tmp_path))
    fault_injection.set_spec(slow_ckpt_io={"delay_s": 0.1})
    w = cs.AsyncCheckpointWriter(store)
    try:
        w.submit(1, {"w": np.zeros(4)})
        w.submit(2, {"w": np.ones(4)})     # waits for step 1 first
        assert w.stalls == 1
        assert w.submitted == 2
        w.wait()
        assert store.list_steps() == [1, 2]
    finally:
        w.close()


def test_async_writer_surfaces_failed_write(tmp_path):
    store = cs.CheckpointStore(str(tmp_path))
    w = cs.AsyncCheckpointWriter(store)
    try:
        class _Unsavable:
            pass
        w.submit(1, _Unsavable())
        with pytest.raises(Exception):
            w.wait()
    finally:
        try:
            w.close()
        except Exception:
            pass


# -- deterministic resume -------------------------------------------------

_TRUE_W = torch.tensor([1.0, -2.0, 3.0, 0.5])


def _toy_state():
    w = torch.zeros(4, requires_grad=True)
    return w, torch.optim.AdamW([w], lr=0.05, betas=(0.9, 0.95),
                                weight_decay=1e-4)


def _toy_steps(store, w, opt, start, stop, ckpt_every=5):
    """One AdamW step per iteration on data drawn from the GLOBAL torch
    RNG, with a dropout-like mask from the global numpy RNG (so both draw
    sequences are part of checkpointed state), returning the float64 loss
    trajectory."""
    losses = []
    for step in range(start, stop):
        x = torch.randn(8, 4)
        keep = torch.from_numpy(np.random.rand(8) > 0.25).float()
        y = x @ _TRUE_W
        opt.zero_grad()
        loss = ((x @ w - y) ** 2 * keep).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach().double()))
        if (step + 1) % ckpt_every == 0:
            store.save(step + 1, cs.snapshot_to_host(
                {"w": w, "opt": opt.state_dict()}),
                rng_state=cs.capture_rng_state(), data_state=step + 1)
    return losses


def test_bit_identical_resume(tmp_path):
    # Uninterrupted control run.
    torch.manual_seed(1234)
    np.random.seed(1234)
    control_store = cs.CheckpointStore(str(tmp_path / "control"), keep=10)
    control_losses = _toy_steps(control_store, *_toy_state(), 0, 20)

    # Interrupted run: same seeds, "killed" right after the step-10
    # checkpoint commits (nothing after it survives).
    torch.manual_seed(1234)
    np.random.seed(1234)
    store = cs.CheckpointStore(str(tmp_path / "victim"), keep=10)
    first_half = _toy_steps(store, *_toy_state(), 0, 10)

    # "New process": fresh store handle, fresh params and optimizer,
    # scrambled RNGs — everything must come from the checkpoint (params +
    # AdamW state + host RNGs + data position).
    torch.manual_seed(999)
    np.random.seed(999)
    store2 = cs.CheckpointStore(str(tmp_path / "victim"), keep=10)
    rc = store2.restore_latest()
    assert rc.step == 10 and rc.data_state == 10
    rc.restore_host_rng()
    w, opt = _toy_state()
    with torch.no_grad():
        w.copy_(rc.tree["w"])
    opt.load_state_dict(rc.tree["opt"])
    second_half = _toy_steps(store2, w, opt, rc.step, 20)

    # Bit-identical, not approximately equal: == on float sequences.
    assert first_half + second_half == control_losses


# -- gang supervisor state machine ---------------------------------------

def _executor(max_failures=0):
    return BackendExecutor(BackendConfig(), ScalingConfig(num_workers=1),
                           max_failures=max_failures)


def test_failure_budget_env_fallback(monkeypatch):
    ex = _executor(max_failures=0)
    monkeypatch.delenv("RT_TRAIN_MAX_RECOVERIES", raising=False)
    assert ex._failure_budget() == 0
    monkeypatch.setenv("RT_TRAIN_MAX_RECOVERIES", "3")
    assert ex._failure_budget() == 3
    # Explicit FailureConfig wins over the env.
    assert _executor(max_failures=5)._failure_budget() == 5
    assert _executor(max_failures=-1)._failure_budget() == -1


def test_recovery_backoff_doubles_and_caps(monkeypatch):
    monkeypatch.setenv("RT_TRAIN_RECOVERY_BACKOFF_S", "0.5")
    monkeypatch.setenv("RT_TRAIN_RECOVERY_BACKOFF_MAX_S", "4")
    ex = _executor()
    got = []
    for n in (1, 2, 3, 4, 5):
        ex._num_failures = n
        got.append(ex._recovery_backoff_s())
    assert got == [0.5, 1.0, 2.0, 4.0, 4.0]
    monkeypatch.setenv("RT_TRAIN_RECOVERY_BACKOFF_S", "0")
    assert ex._recovery_backoff_s() == 0.0


def test_verified_checkpoint_gate_falls_back(tmp_path):
    train_metrics.reset()
    store = cs.CheckpointStore(str(tmp_path))
    store.save(1, {"w": np.arange(4.0)})
    p2 = store.save(2, {"w": np.arange(4.0) * 2})
    shard = os.path.join(p2, "leaf_0.bin")
    blob = bytearray(open(shard, "rb").read())
    blob[-1] ^= 0xFF
    open(shard, "wb").write(bytes(blob))

    ex = _executor()
    out = ex._verified_checkpoint(Checkpoint.from_directory(p2))
    # Corrupt latest -> previous intact sibling.
    assert out is not None
    assert out.path.endswith("ckpt-000000000001")
    assert train_metrics.stats()["ckpt_corrupt_skipped"] >= 1

    # Intact latest passes through unchanged.
    ok = ex._verified_checkpoint(
        Checkpoint.from_directory(os.path.join(str(tmp_path),
                                               "ckpt-000000000001")))
    assert ok.path.endswith("ckpt-000000000001")

    # Dict-form and non-store checkpoints are not gated.
    d = Checkpoint.from_dict({"step": 1})
    assert ex._verified_checkpoint(d) is d
    assert ex._verified_checkpoint(None) is None


def test_verified_checkpoint_gate_no_intact_sibling(tmp_path):
    store = cs.CheckpointStore(str(tmp_path), keep=1)
    p = store.save(1, {"w": np.arange(4.0)})
    os.truncate(os.path.join(p, "leaf_0.bin"), 3)
    ex = _executor()
    # Nothing intact left: restart from scratch rather than load garbage.
    assert ex._verified_checkpoint(Checkpoint.from_directory(p)) is None


# -- preemption handoff (in-process worker machinery) ---------------------

def _drain_until(worker, kind, limit=50):
    seen = []
    for _ in range(limit):
        msg = worker.get_next()
        seen.append(msg)
        if msg[0] == kind:
            return seen
    raise AssertionError(f"no {kind!r} message within {limit} "
                         f"(saw {[m[0] for m in seen]})")


def test_preempt_rpc_exits_clean_after_checkpoint():
    worker = RayTrainWorker()
    worker.set_context(world_rank=0, world_size=1)

    def loop(config):
        for i in range(1000):
            session.report({"i": i},
                           checkpoint=Checkpoint.from_dict({"step": i}))
            time.sleep(0.01)

    worker.start_training(loop, {}, None)
    first = worker.get_next()
    assert first[0] == "report"
    worker.preempt(grace_s=30.0)
    seen = _drain_until(worker, "preempted")
    # The handoff came AFTER a final checkpoint-bearing report, and the
    # loop did not run to completion (no "done", no "error").
    kinds = [m[0] for m in seen]
    assert "error" not in kinds and "done" not in kinds
    assert seen[-2][0] == "report" and seen[-2][2] is not None


def test_preempt_grace_expiry_exits_without_checkpoint():
    worker = RayTrainWorker()
    worker.set_context(world_rank=0, world_size=1)

    def loop(config):
        for i in range(1000):
            session.report({"i": i})      # never checkpoints
            time.sleep(0.01)

    worker.start_training(loop, {}, None)
    assert worker.get_next()[0] == "report"
    worker.preempt(grace_s=0.0)           # deadline already passed
    seen = _drain_until(worker, "preempted")
    assert "error" not in [m[0] for m in seen]


def test_preempt_notice_fault_targets_rank():
    # Rank 1 is targeted; rank 0 must run to completion.
    fault_injection.set_spec(
        preempt_notice={"after_s": 0.0, "grace_s": 30.0, "rank": 1})
    worker = RayTrainWorker()
    worker.set_context(world_rank=0, world_size=2)

    def loop(config):
        for i in range(3):
            session.report({"i": i},
                           checkpoint=Checkpoint.from_dict({"step": i}))

    worker.start_training(loop, {}, None)
    seen = _drain_until(worker, "done")
    assert [m[0] for m in seen].count("report") == 3


def test_preempt_notice_fault_triggers_handoff():
    fault_injection.set_spec(
        preempt_notice={"after_s": 0.0, "grace_s": 30.0})
    worker = RayTrainWorker()
    worker.set_context(world_rank=0, world_size=1)

    def loop(config):
        for i in range(1000):
            session.report({"i": i},
                           checkpoint=Checkpoint.from_dict({"step": i}))

    worker.start_training(loop, {}, None)
    seen = _drain_until(worker, "preempted")
    kinds = [m[0] for m in seen]
    assert "error" not in kinds and "done" not in kinds


# -- end-to-end: budget exhaustion through the trainer --------------------

def _loop_always_fails(config):
    import os as _os
    with open(_os.path.join(config["dir"], f"attempt-{_os.getpid()}-"
                            f"{time.time_ns()}"), "w"):
        pass
    raise RuntimeError("persistent failure")


def test_trainer_budget_exhaustion(ray_start, tmp_path,  # noqa: F811
                                   monkeypatch):
    from ray_tpu_torch.train import (TorchConfig, TorchTrainer,
                                     TrainingFailedError)
    monkeypatch.setenv("RT_TRAIN_RECOVERY_BACKOFF_S", "0")
    attempts = tmp_path / "attempts"
    attempts.mkdir()
    trainer = TorchTrainer(
        _loop_always_fails,
        train_loop_config={"dir": str(attempts)},
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)),
    )
    with pytest.raises(TrainingFailedError, match="persistent failure"):
        trainer.fit()
    # Initial attempt + exactly max_failures restarts.
    assert len(list(attempts.iterdir())) == 3


def test_train_totals_shape(ray_start):  # noqa: F811
    from ray_tpu_torch.util import state
    totals = state.train_totals()
    for key in ("train_recoveries", "preemptions", "ckpt_write_ms",
                "ckpt_restore_ms", "ckpt_corrupt_skipped"):
        assert key in totals


# -- DCP envelope seal (the reference's orbax cases) ----------------------

def test_dcp_seal_detects_torn_write(tmp_path):
    from ray_tpu_torch.train.torch import dcp_checkpoint as dc

    path = str(tmp_path / "ck")
    dc.save_sharded(path, {"w": torch.arange(16, dtype=torch.float32)})
    manifest = dc.verify_sharded(path)
    assert manifest["files"]

    # Truncate one payload file the manifest attests to.
    victim = None
    for rel in manifest["files"]:
        if rel != dc.RT_MANIFEST:
            full = os.path.join(path, rel)
            if os.path.getsize(full) > 0:
                victim = full
                break
    assert victim is not None
    os.truncate(victim, os.path.getsize(victim) - 1)
    with pytest.raises(cs.CorruptCheckpointError):
        dc.restore_sharded(path)


def test_dcp_seal_rejects_manifestless_dir(tmp_path):
    from ray_tpu_torch.train.torch import dcp_checkpoint as dc
    d = tmp_path / "unsealed"
    d.mkdir()
    (d / "data").write_bytes(b"x")
    with pytest.raises(cs.CorruptCheckpointError, match="partial"):
        dc.verify_sharded(str(d))

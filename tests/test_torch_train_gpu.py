"""Train workers on cards, with fake cards.

A node started with ``RT_NUM_GPUS=2`` advertises two cards with no card
present (as in test_torch_gpu_resources.py).  A ``use_gpu`` gang's
workers each see a card of their own in ``CUDA_VISIBLE_DEVICES``; a
worker SIGKILLed by ``kill_train_worker`` is replaced on the card it held,
once the raylet has reaped the dead process; and a ``use_gpu`` trainer on a
node without a free card stays pending (never running on the CPU) until a
card frees.  The loops read the environment only, so no world is set up
(``TorchConfig(distributed=False)``: NCCL needs real cards).  This module
imports no JAX: the cluster's workers import it.
"""

import os
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.air import Checkpoint, RunConfig, ScalingConfig, session
from ray_tpu_torch.air.config import FailureConfig
from ray_tpu_torch.train import TorchConfig, TorchTrainer
from ray_tpu_torch.train import metrics as train_metrics
from ray_tpu_torch.util import fault_injection, state


@pytest.fixture(scope="module")
def gpu_cluster():
    old = os.environ.get("RT_NUM_GPUS")
    os.environ["RT_NUM_GPUS"] = "2"
    try:
        ray_tpu_torch.init(num_cpus=8)
    finally:
        if old is None:
            del os.environ["RT_NUM_GPUS"]
        else:
            os.environ["RT_NUM_GPUS"] = old
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_gpus=1)
class CardHolder:
    def card(self):
        return os.environ["CUDA_VISIBLE_DEVICES"]


def _wait_all_cards_free(timeout=60):
    deadline = time.monotonic() + timeout
    while ray_tpu_torch.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline, "cards never came back"
        time.sleep(0.1)


def _gpu_trainer(loop, config, num_workers=1, **kw):
    return TorchTrainer(
        loop, train_loop_config=config,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=num_workers, use_gpu=True),
        **kw)


def _loop_cards_to_files(config):
    rank = session.get_world_rank()
    with open(os.path.join(config["dir"], f"rank-{rank}"), "w") as f:
        f.write(os.environ["CUDA_VISIBLE_DEVICES"])
    session.report({"cards": os.environ["CUDA_VISIBLE_DEVICES"]})


def test_gpu_gang_sees_distinct_cards(gpu_cluster, tmp_path):
    _wait_all_cards_free()
    _gpu_trainer(_loop_cards_to_files, {"dir": str(tmp_path)},
                 num_workers=2).fit()
    seen = sorted((tmp_path / f"rank-{r}").read_text() for r in range(2))
    assert seen == ["0", "1"]
    _wait_all_cards_free()


def _loop_steps_on_card(config):
    ckpt = session.get_checkpoint()
    start = ckpt.to_dict()["step"] if ckpt else 0
    for step in range(start, config["steps"]):
        session.report({"step": step, "pid": os.getpid(),
                        "cards": os.environ["CUDA_VISIBLE_DEVICES"]},
                       checkpoint=Checkpoint.from_dict({"step": step + 1}))
        if step == 1:
            open(os.path.join(config["dir"], f"ready-{os.getpid()}"),
                 "w").close()
        time.sleep(0.2)


def test_killed_gpu_worker_is_replaced_on_its_card(gpu_cluster, tmp_path,
                                                   monkeypatch):
    """The other card is held, so the replacement can only be placed on
    the card the killed worker held, and only after its reap."""
    monkeypatch.setenv("RT_TRAIN_RECOVERY_BACKOFF_S", "0")
    _wait_all_cards_free()
    train_metrics.reset()
    holder = CardHolder.remote()
    held = ray_tpu_torch.get(holder.card.remote(), timeout=120)
    killed = {}

    def _killer():
        # SIGKILL once the worker's pid has reached the GCS (before that,
        # kill_train_worker falls back to a GCS kill).
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not killed:
            ready = [int(p.name.split("-")[1]) for p in tmp_path.iterdir()
                     if p.name.startswith("ready-")]
            if ready and any(w.get("pid") == ready[0]
                             for w in state.list_workers()):
                killed.update(fault_injection.kill_train_worker(
                    mode="sigkill"))
            else:
                time.sleep(0.05)

    t = threading.Thread(target=_killer, daemon=True)
    t.start()
    try:
        result = _gpu_trainer(
            _loop_steps_on_card, {"steps": 12, "dir": str(tmp_path)},
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=1))).fit()
        t.join(timeout=10)
    finally:
        ray_tpu_torch.kill(holder)
    assert killed and killed["pid"] is not None
    hist = result.metrics_history
    assert hist[-1]["step"] == 11
    pids = {m["pid"] for m in hist}
    assert killed["pid"] in pids and len(pids) == 2
    free = {"0", "1"} - {held}
    assert {m["cards"] for m in hist} == free
    assert train_metrics.stats()["train_recoveries"] >= 1
    _wait_all_cards_free()


def _loop_marker(config):
    open(config["marker"], "w").close()
    session.report({"cards": os.environ["CUDA_VISIBLE_DEVICES"]})


def test_gpu_trainer_without_free_card_stays_pending(gpu_cluster, tmp_path):
    _wait_all_cards_free()
    holders = [CardHolder.remote() for _ in range(2)]
    cards = ray_tpu_torch.get([h.card.remote() for h in holders],
                              timeout=120)
    marker = tmp_path / "ran"
    out = {}

    def _fit():
        out["result"] = _gpu_trainer(_loop_marker,
                                     {"marker": str(marker)}).fit()

    t = threading.Thread(target=_fit, daemon=True)
    t.start()
    try:
        time.sleep(4)
        # Pending: no worker ran the loop, on a card or on the CPU.
        assert t.is_alive() and not marker.exists()
    finally:
        ray_tpu_torch.kill(holders[0])
    t.join(timeout=60)
    assert not t.is_alive() and marker.exists()
    assert out["result"].metrics["cards"] == cards[0]
    ray_tpu_torch.kill(holders[1])
    _wait_all_cards_free()


def test_group_removed_before_its_actor_exits_returns_cards_once(
        gpu_cluster):
    """A gang's teardown kills its actors and removes their group at once:
    the bundles go back before the killed processes are reaped.  The
    node's count must end at its total, not above it (the reaped actor's
    share is already in the bundle the group gave back)."""
    from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                    placement_group, remove_placement_group)
    _wait_all_cards_free()
    pg = placement_group([{"CPU": 1, "GPU": 1}] * 2, strategy="PACK")
    assert pg.ready(timeout=60)
    holders = [CardHolder.options(
        num_cpus=1, scheduling_strategy=PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=i)).remote() for i in range(2)]
    assert sorted(ray_tpu_torch.get([h.card.remote() for h in holders],
                                    timeout=120)) == ["0", "1"]
    for h in holders:
        ray_tpu_torch.kill(h)
    remove_placement_group(pg)
    _wait_all_cards_free()
    time.sleep(2)      # the reaps land after the bundles' return
    res = ray_tpu_torch.available_resources()
    assert res.get("GPU") == 2.0 and res.get("CPU") == 8.0, res

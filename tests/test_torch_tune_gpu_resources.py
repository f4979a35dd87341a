"""Tune's trials on cards, with fake cards.

A node started with ``RT_NUM_GPUS=2`` advertises two cards with no card
present (as in test_torch_gpu_resources.py).  A function trial given
``{"GPU": 1}`` by ``with_resources`` leases one card of its own, and
trials beyond the cards queue.  A ``Tuner(TorchTrainer(use_gpu=True))``
trial actor holds no card; its gang holds one.  The trap these cases hold:
a trial stopped by its scheduler must give its gang's card back (the gang
is created by the trial actor's process, and the GCS records no owner for
an actor, so killing the trial actor alone leaves the gang alive); and a
trainer trial queued behind another's card waits for it within the gang's
60 s placement limit.  The purity case holds that no process of a tuned
cluster imports JAX or anything of ``ray_tpu``.  The loops read the
environment only, so no world is set up (``TorchConfig(distributed=
False)``).  This module imports no JAX: the cluster's workers import it.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air import ScalingConfig, session
from ray_tpu_torch.train import TorchConfig, TorchTrainer
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.schedulers import ASHAScheduler
from ray_tpu_torch.util import state
from test_torch_gpu_resources import _FORBIDDEN_IMPORT, _driver, _imports


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


def _wait_cards_free(n, timeout=60):
    deadline = time.monotonic() + timeout
    while ray_tpu_torch.available_resources().get("GPU") != n:
        assert time.monotonic() < deadline, (
            "cards never came back", ray_tpu_torch.available_resources())
        time.sleep(0.1)


def _live_train_workers():
    return [a for a in state.list_actors()
            if (a.get("name") or "").startswith("_train:")
            and a["state"] != "DEAD"]


@pytest.fixture
def one_free_card(gpu_cluster):
    """Hold one of the two cards, so the test's trials share the other."""
    _wait_cards_free(2.0)
    holder = CardHolder.remote()
    ray_tpu_torch.get(holder.card.remote(), timeout=120)
    yield
    ray_tpu_torch.kill(holder)
    _wait_cards_free(2.0)


def _fn_card(config):
    start = time.time()
    time.sleep(config["hold_s"])
    tune.report({"cards": os.environ["CUDA_VISIBLE_DEVICES"],
                 "start": start, "end": time.time()})


def test_function_trials_each_lease_one_card_and_queue(gpu_cluster):
    _wait_cards_free(2.0)
    trainable = tune.with_resources(_fn_card, {"CPU": 1, "GPU": 1})
    results = Tuner(
        trainable,
        param_space={"hold_s": 1.0, "i": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(metric="end", mode="max",
                               max_concurrent_trials=3)).fit()
    assert not results.errors
    runs = sorted((r.metrics["start"], r.metrics["end"], r.metrics["cards"])
                  for r in results)
    assert len(runs) == 3
    assert all(cards in ("0", "1") for _, _, cards in runs), runs
    # Three trials on two cards: the third starts once a card frees, and
    # two trials that overlap hold different cards.
    for s0, _, _ in runs:
        live = [(s, c) for s, e, c in runs if s <= s0 < e]
        assert len(live) <= 2, runs
        assert len({c for _, c in live}) == len(live), runs
    assert runs[2][0] >= min(runs[0][1], runs[1][1]), runs
    _wait_cards_free(2.0)


class _EnvTrainer(TorchTrainer):
    """Writes the trial actor's card mask (setup runs in the trial
    actor's process, before the gang starts)."""

    def setup(self):
        path = os.path.join(self._train_loop_config["dir"],
                            f"trial-{self._train_loop_config['i']}")
        with open(path, "w") as f:
            f.write(os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>"))


def _loop_card(config):
    session.report({"cards": os.environ["CUDA_VISIBLE_DEVICES"],
                    "i": config["i"]})


def test_trainer_trial_actor_holds_no_card_and_its_gang_one(
        gpu_cluster, tmp_path):
    _wait_cards_free(2.0)
    trainer = _EnvTrainer(
        _loop_card, train_loop_config={"dir": str(tmp_path)},
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {"i": tune.grid_search([0, 1])}},
        tune_config=TuneConfig(metric="i", mode="max")).fit()
    assert not results.errors
    assert sorted(r.metrics["i"] for r in results) == [0, 1]
    assert all(r.metrics["cards"] in ("0", "1") for r in results)
    assert [(tmp_path / f"trial-{i}").read_text() for i in (0, 1)] == \
        ["", ""]
    _wait_cards_free(2.0)
    assert _live_train_workers() == []


def _loop_steps(config):
    """One report a step for 30 steps of 0.25 s, so a trial's worker is
    still stepping when its trial is stopped.  The first report carries
    the train workers alive at the gang's start."""
    live = sorted(a["name"] for a in _live_train_workers())
    for step in range(30):
        rec = {"value": config["rate"] * (step + 1), "pid": os.getpid(),
               "cards": os.environ["CUDA_VISIBLE_DEVICES"],
               "time": time.time()}
        if step == 0:
            rec["live_train_workers"] = live
        session.report(rec)
        time.sleep(0.25)


def _card_trainer():
    return TorchTrainer(
        _loop_steps, torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True))


def test_asha_stopped_trainer_trials_give_their_card_back(one_free_card):
    """Three trainer trials, one at a time, on one free card.  ASHA
    (max_t 4, grace 1, rf 2) stops the 1.0 trial at max_t and the other
    two at the first rung, each while its worker still steps.  Were a
    stopped trial's gang left alive, it would keep the card, and the next
    trial's gang would fail to place after 60 s."""
    results = Tuner(
        _card_trainer(),
        param_space={"train_loop_config": {
            "rate": tune.grid_search([1.0, 0.5, 0.1])}},
        tune_config=TuneConfig(
            metric="value", mode="max", max_concurrent_trials=1,
            scheduler=ASHAScheduler(max_t=4, grace_period=1,
                                    reduction_factor=2))).fit()
    assert not results.errors, results.errors
    iters = {r.metrics["config"]["train_loop_config"]["rate"]:
             r.metrics["training_iteration"] for r in results}
    assert iters == {1.0: 4, 0.5: 1, 0.1: 1}
    firsts = [r.metrics_history[0] for r in results]
    # Each gang found only its own worker alive: the stopped trials'
    # workers were gone before the next gang started.
    assert [len(f["live_train_workers"]) for f in firsts] == [1, 1, 1]
    assert len({f["pid"] for f in firsts}) == 3
    assert {f["cards"] for f in firsts} == {firsts[0]["cards"]}
    assert _live_train_workers() == []
    _wait_cards_free(1.0, timeout=30)


def _loop_hold(config):
    session.report({"start": time.time(), "i": config["i"]})
    time.sleep(config["hold_s"])
    session.report({"end": time.time(), "i": config["i"]})


def test_queued_trainer_trial_waits_for_the_card(one_free_card):
    """Two trainer trials at concurrency 2 on one free card: the second
    gang's placement group waits for the first trial's card (at most 60 s,
    then TrainBackendError).  The first holds it for 3 s, so the second
    gets it once the first ends."""
    trainer = TorchTrainer(
        _loop_hold, train_loop_config={"hold_s": 3.0},
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {"i": tune.grid_search([0, 1])}},
        tune_config=TuneConfig(metric="i", mode="max",
                               max_concurrent_trials=2)).fit()
    assert not results.errors, results.errors
    runs = sorted((r.metrics_history[0]["start"], r.metrics["end"])
                  for r in results)
    assert len(runs) == 2
    (s0, e0), (s1, _) = runs
    assert s1 >= e0, runs
    assert s1 - s0 < 60.0, runs
    _wait_cards_free(1.0, timeout=30)


def test_no_process_of_a_tuned_cluster_imports_jax_or_ray_tpu(tmp_path):
    """The purity rule (test_torch_gpu_resources.py) on a cluster that
    tunes a card trainer under ASHA: the driver, the trial actors and the
    train workers (the driver, the helpers and the forbidden pattern are
    test_torch_gpu_resources.py's)."""
    code = """
import os
import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.air import ScalingConfig, session
from ray_tpu_torch.train import TorchConfig, TorchTrainer
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.schedulers import ASHAScheduler
rt.init(num_cpus=4)

def loop(config):
    for step in range(3):
        session.report({"value": config["rate"] * (step + 1),
                        "cards": os.environ["CUDA_VISIBLE_DEVICES"]})

results = Tuner(
    TorchTrainer(loop, torch_config=TorchConfig(distributed=False),
                 scaling_config=ScalingConfig(num_workers=1, use_gpu=True)),
    param_space={"train_loop_config": {"rate": tune.grid_search([1.0,
                                                                 0.5])}},
    tune_config=TuneConfig(metric="value", mode="max",
                           max_concurrent_trials=1,
                           scheduler=ASHAScheduler(max_t=3,
                                                   grace_period=1))).fit()
assert not results.errors, results.errors
print("RESULT", sorted(r.metrics["cards"] for r in results))
rt.shutdown()
"""
    proc = _driver(code, {"RT_NUM_GPUS": "1", "PYTHONPROFILEIMPORTTIME": "1",
                          "RT_LOG_DIR": str(tmp_path)}, timeout=180)
    assert "RESULT ['0', '0']" in proc.stdout
    logs = {p.name: p.read_text() for p in tmp_path.iterdir()
            if p.suffix in (".err", ".log")}
    workers = [v for k, v in logs.items() if k.startswith("worker-")]
    # Two trial actors (forked) and two train workers (cold, on the card)
    # at least; the cold ones import the runtime themselves.
    assert sum("ray_tpu_torch._private.core_worker" in _imports(t)
               for t in workers) >= 2
    assert "ray_tpu_torch.tune" in _imports(proc.stderr)
    for name, text in [("driver+daemon", proc.stderr)] + sorted(
            logs.items()):
        mods = _imports(text)
        bad = [m for m in mods if _FORBIDDEN_IMPORT.search("| " + m)]
        assert not bad, (name, bad)

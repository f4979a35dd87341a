"""Tune layer tests, the port's mirror of tests/test_tune.py.

Reference shape: python/ray/tune/tests/test_tune_* (grid/random search,
schedulers early-stop, PBT perturbation, Tuner+Trainer composition,
experiment checkpoint/resume).  The trainer case tunes a TorchTrainer
whose workers run no world (``TorchConfig(distributed=False)``).  This
module imports no JAX: the cluster's workers import it to run its
trainables.
"""

import pytest

from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch import tune
from ray_tpu_torch.air import Checkpoint, RunConfig, ScalingConfig, session
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler, MedianStoppingRule, PopulationBasedTraining)


def _objective(config):
    # Quadratic bowl: best at x=3.
    score = -(config["x"] - 3) ** 2
    tune.report({"score": score, "x": config["x"]})


def test_grid_search(ray_start):  # noqa: F811
    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=TuneConfig(metric="score", mode="max"),
    )
    results = tuner.fit()
    assert len(results) == 5
    best = results.get_best_result()
    assert best.metrics["x"] == 3


def test_random_search_num_samples(ray_start):  # noqa: F811
    tuner = Tuner(
        _objective,
        param_space={"x": tune.uniform(-5, 5)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=6,
                               seed=7),
    )
    results = tuner.fit()
    assert len(results) == 6
    xs = [r.metrics["x"] for r in results]
    assert len(set(xs)) > 1  # actually sampled


def test_sample_domains():
    import random
    rng = random.Random(0)
    assert 1 <= tune.randint(1, 10).sample(rng) < 10
    assert 0.1 <= tune.loguniform(0.1, 10).sample(rng) <= 10
    assert tune.choice(["a", "b"]).sample(rng) in ("a", "b")
    q = tune.quniform(0, 1, 0.25).sample(rng)
    assert q in (0.0, 0.25, 0.5, 0.75, 1.0)


class _StepTrainable(tune.Trainable):
    def setup(self, config):
        self.lr = config.get("lr", 0.1)
        self.value = 0.0

    def step(self):
        self.value += self.lr
        return {"value": self.value}

    def save_checkpoint(self):
        return {"value": self.value}

    def load_checkpoint(self, state):
        self.value = state["value"]


def test_class_trainable_with_stop(ray_start):  # noqa: F811
    tuner = Tuner(
        _StepTrainable,
        param_space={"lr": tune.grid_search([0.1, 1.0])},
        tune_config=TuneConfig(metric="value", mode="max"),
        run_config=RunConfig(stop={"training_iteration": 4}),
    )
    results = tuner.fit()
    assert len(results) == 2
    best = results.get_best_result()
    assert best.metrics["value"] == pytest.approx(4.0)
    # Checkpoint captured at completion.
    assert best.checkpoint is not None
    state = best.checkpoint.to_dict()
    assert state["trainable_state"]["value"] == pytest.approx(4.0)


def _iterative(config):
    v = 0.0
    for i in range(20):
        v += config["rate"]
        tune.report({"value": v})


def test_asha_stops_bad_trials(ray_start):  # noqa: F811
    scheduler = ASHAScheduler(max_t=20, grace_period=2, reduction_factor=2)
    tuner = Tuner(
        _iterative,
        param_space={"rate": tune.grid_search([0.01, 0.02, 1.0, 2.0])},
        tune_config=TuneConfig(metric="value", mode="max",
                               scheduler=scheduler,
                               max_concurrent_trials=4),
    )
    results = tuner.fit()
    iters = {r.metrics["config"]["rate"]:
             r.metrics.get("training_iteration", 0) for r in results}
    # The best trial ran to the cap; at least one bad one stopped early.
    assert max(iters.values()) >= 19
    assert min(iters.values()) < 20


def test_median_stopping(ray_start):  # noqa: F811
    scheduler = MedianStoppingRule(grace_period=3, min_samples_required=2)
    tuner = Tuner(
        _iterative,
        param_space={"rate": tune.grid_search([0.01, 1.0, 1.5, 2.0])},
        tune_config=TuneConfig(metric="value", mode="max",
                               scheduler=scheduler,
                               max_concurrent_trials=4),
        run_config=RunConfig(stop={"training_iteration": 15}),
    )
    results = tuner.fit()
    assert len(results) == 4


def _pbt_fn(config):
    # Standard PBT contract: checkpoint carries the step too, so an
    # exploited trial resumes the donor's progress instead of restarting
    # its 30 iterations from scratch (which would never terminate under
    # repeated exploits).
    ckpt = session.get_checkpoint()
    state = ckpt.to_dict() if ckpt else {"value": 0.0, "step": 0}
    v = state["value"]
    for step in range(state.get("step", 0), 30):
        v += config["rate"]
        tune.report({"value": v},
                    checkpoint=Checkpoint.from_dict(
                        {"value": v, "step": step + 1}))


def test_pbt_exploits(ray_start):  # noqa: F811
    scheduler = PopulationBasedTraining(
        perturbation_interval=5,
        hyperparam_mutations={"rate": tune.uniform(0.1, 2.0)},
        quantile_fraction=0.5,
        seed=3,
    )
    tuner = Tuner(
        _pbt_fn,
        param_space={"rate": tune.grid_search([0.001, 1.0])},
        tune_config=TuneConfig(metric="value", mode="max",
                               scheduler=scheduler,
                               max_concurrent_trials=2),
    )
    results = tuner.fit()
    assert len(results) == 2
    # The weak trial must have been pulled up by exploiting the strong one:
    # with rate=0.001 alone it would end near 0.03.
    values = sorted(r.metrics["value"] for r in results)
    assert values[0] > 1.0


def test_tuner_with_trainer(ray_start):  # noqa: F811
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    def loop(config):
        for i in range(3):
            session.report({"loss": config["lr"] * (i + 1)})

    trainer = TorchTrainer(
        loop,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=1),
    )
    tuner = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "lr": tune.grid_search([0.1, 0.2])}},
        tune_config=TuneConfig(metric="loss", mode="min"),
    )
    results = tuner.fit()
    assert len(results) == 2
    assert results.get_best_result().metrics["loss"] == pytest.approx(0.3)


def test_experiment_checkpoint_and_restore(ray_start, tmp_path):  # noqa: F811
    tuner = Tuner(
        _objective,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="ckpt_exp", storage_path=str(tmp_path)),
    )
    results = tuner.fit()
    assert len(results) == 3
    exp_dir = tmp_path / "ckpt_exp"
    assert (exp_dir / "experiment_state.pkl").exists()
    assert (exp_dir / "experiment_state.json").exists()

    restored = Tuner.restore(str(exp_dir), _objective)
    r2 = restored.fit()
    assert len(r2) == 3
    assert r2.get_best_result(metric="score", mode="max").metrics["x"] == 3


def test_with_resources_and_parameters(ray_start):  # noqa: F811
    big = list(range(1000))

    def fn(config, data=None):
        tune.report({"n": len(data), "x": config["x"]})

    wrapped = tune.with_parameters(fn, data=big)
    trainable = tune.with_resources(wrapped, {"CPU": 0.5})
    tuner = Tuner(trainable,
                  param_space={"x": tune.grid_search([1])},
                  tune_config=TuneConfig(metric="n", mode="max"))
    results = tuner.fit()
    assert results.get_best_result().metrics["n"] == 1000

"""The port's searchers and schedulers against the JAX package's.

Tune is host code (numpy, ``random``): the same seeds and the same inputs
must give the same suggestions and decisions, exactly.  Each case builds
its search space or scheduler from each package's own ``tune`` names and
runs both through one driver:

* ``BasicVariantGenerator`` over a grid and a random space, every
  suggestion until it is exhausted;
* ``TPESearcher`` and ``BayesOptSearcher`` for 40 suggestions through
  ``test_tune_searchers.py``'s ``_drive`` loop, on its mixed space and its
  integer/log space;
* ``ASHAScheduler``, ``HyperBandScheduler``, ``MedianStoppingRule``,
  ``PopulationBasedTraining(seed=...)`` and ``PB2(seed=...)``, each fed
  one scripted stream of results (seeded numpy) through a stub runner and
  each package's own ``Trial``: every decision, exploit request and new
  config.

No cluster is started.
"""

import math

import numpy as np
import pytest

from ray_tpu import tune as jtune
from ray_tpu.tune import experiment as jexperiment
from ray_tpu.tune import schedulers as jschedulers
from ray_tpu.tune import search as jsearch
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.tune import experiment as texperiment
from ray_tpu_torch.tune import schedulers as tschedulers
from ray_tpu_torch.tune import search as tsearch

PACKAGES = {"jax": (jtune, jsearch, jschedulers, jexperiment),
            "torch": (ttune, tsearch, tschedulers, texperiment)}


def _both(fn):
    """``fn(tune, search, schedulers, experiment)`` for each package."""
    return [fn(*PACKAGES[name]) for name in ("jax", "torch")]


# ------------------------------------------------------------- searchers


def _variants(tune, search, space_fn, num_samples, seed):
    gen = search.BasicVariantGenerator(space_fn(tune),
                                       num_samples=num_samples, seed=seed)
    out = []
    while (cfg := gen.suggest(f"t{len(out)}")) is not None:
        out.append(cfg)
    return out, gen.total_suggestions


def _grid_space(tune):
    return {"lr": tune.grid_search([1e-3, 3e-4, 3e-5]),
            "model": {"layers": tune.grid_search([2, 4]),
                      "dropout": tune.uniform(0.0, 0.5)},
            "batch": 32}


def _random_space(tune):
    return {"lr": tune.loguniform(1e-5, 1e-1),
            "width": tune.qrandint(64, 1024, 64),
            "act": tune.choice(["relu", "gelu", "tanh"]),
            "wd": tune.quniform(0.0, 0.1, 0.01),
            "noise": tune.randn(0.0, 2.0),
            "depth": tune.lograndint(1, 48),
            "fixed": tune.sample_from(lambda _: 7)}


@pytest.mark.parametrize("space_fn,num_samples,seed", [
    (_grid_space, 2, 0), (_random_space, 25, 11)],
    ids=["grid", "random"])
def test_basic_variant_generator_matches(space_fn, num_samples, seed):
    want, got = _both(lambda tune, search, *_: _variants(
        tune, search, space_fn, num_samples, seed))
    assert got == want
    assert len(got[0]) == got[1] > 1


def _drive(searcher, objective, space, n=40):
    """test_tune_searchers.py's offline suggest/complete loop."""
    searcher.set_search_properties("obj", "max", space)
    cfgs, vals = [], []
    for i in range(n):
        cfg = searcher.suggest(f"t{i}")
        v = objective(cfg)
        searcher.on_trial_complete(f"t{i}", {"obj": v})
        cfgs.append(cfg)
        vals.append(v)
    return cfgs, vals


def _mixed_space(tune):
    return {"lr": tune.loguniform(1e-5, 1e-1),
            "layers": tune.randint(1, 8),
            "act": tune.choice(["relu", "gelu", "tanh"]),
            "nested": {"dropout": tune.uniform(0.0, 0.5)}}


def _mixed_obj(cfg):
    score = -abs(math.log10(cfg["lr"]) + 3)
    score += -abs(cfg["layers"] - 4) * 0.1
    score += 0.5 if cfg["act"] == "gelu" else 0.0
    score += -abs(cfg["nested"]["dropout"] - 0.1)
    return score


def _int_log_space(tune):
    return {"n": tune.randint(2, 64), "lr": tune.loguniform(1e-5, 1e-1)}


def _int_log_obj(cfg):
    return -abs(cfg["n"] - 32) / 32.0


@pytest.mark.parametrize("searcher", ["TPESearcher", "BayesOptSearcher"])
@pytest.mark.parametrize("space_fn,objective,seed", [
    (_mixed_space, _mixed_obj, 1), (_int_log_space, _int_log_obj, 2)],
    ids=["mixed", "int_log"])
def test_model_searchers_match(searcher, space_fn, objective, seed):
    want, got = _both(lambda tune, search, *_: _drive(
        getattr(search, searcher)(seed=seed, n_startup_trials=6),
        objective, space_fn(tune)))
    assert got == want
    # Past the startup draws the model picks (not a repeat of one point).
    assert len({repr(c) for c in got[0][6:]}) > 1


# ------------------------------------------------------------ schedulers

N_TRIALS = 6
N_STEPS = 12


def _stream():
    """Each trial's score at steps 1..N_STEPS: a rate per trial plus
    seeded noise, so trials cross and rungs see ties broken by data."""
    gen = np.random.default_rng(5)
    rates = gen.uniform(0.2, 2.0, N_TRIALS)
    noise = gen.normal(0.0, 0.5, (N_TRIALS, N_STEPS))
    return np.cumsum(rates[:, None] + noise, axis=1).tolist()


class _StubRunner:
    """The scheduler callback surface of TrialRunner."""

    def __init__(self, trials, running):
        self.trials = trials
        self._running = running
        self.exploits = []

    def live_trials(self):
        return [t for t in self.trials if t.status == self._running]

    def request_exploit(self, victim, donor, new_config):
        self.exploits.append((victim, donor, new_config))


def _run_scheduler(sched, experiment, stream, mode="max"):
    """Feed ``stream`` to ``sched`` step by step, in trial order; apply
    each STOP and each exploit's new config as the runner would.  Returns
    the log of every decision, exploit and completion."""
    trial_mod = experiment.trial
    sched.set_search_properties("score", mode)
    trials = [experiment.Trial({"lr": 0.1 * (i + 1), "momentum": 0.9,
                                "tag": f"t{i}"}, trial_id=f"{i:05d}")
              for i in range(N_TRIALS)]
    runner = _StubRunner(trials, trial_mod.RUNNING)
    for t in trials:
        sched.on_trial_add(runner, t)
        t.status = trial_mod.RUNNING
    log = []
    for step in range(1, N_STEPS + 1):
        for i, t in enumerate(trials):
            if t.status != trial_mod.RUNNING:
                continue
            result = {"score": stream[i][step - 1],
                      "training_iteration": step, "trial_id": t.trial_id}
            decision = sched.on_trial_result(runner, t, result)
            log.append(("result", t.trial_id, step, decision))
            if decision == "STOP":
                t.status = trial_mod.TERMINATED
                sched.on_trial_complete(runner, t, result)
        for victim, donor, cfg in runner.exploits:
            log.append(("exploit", step, victim.trial_id, donor.trial_id,
                        cfg))
            victim.config = cfg
        runner.exploits.clear()
    log.append(("final", [(t.trial_id, t.status, t.config)
                          for t in trials]))
    return log


SCHEDULERS = {
    "asha": lambda tune, s: s.ASHAScheduler(
        max_t=N_STEPS, grace_period=1, reduction_factor=2),
    "hyperband": lambda tune, s: s.HyperBandScheduler(
        max_t=9, reduction_factor=3),
    "median": lambda tune, s: s.MedianStoppingRule(
        grace_period=2, min_samples_required=2),
    "pbt": lambda tune, s: s.PopulationBasedTraining(
        perturbation_interval=3, quantile_fraction=0.34,
        resample_probability=0.3,
        hyperparam_mutations={"lr": tune.uniform(0.01, 1.0),
                              "momentum": [0.8, 0.9, 0.99],
                              "tag": tune.choice(["a", "b"])},
        seed=3),
    "pb2": lambda tune, s: s.PB2(
        perturbation_interval=2, quantile_fraction=0.34,
        hyperparam_mutations={"lr": tune.uniform(0.01, 1.0),
                              "momentum": tune.loguniform(0.5, 0.999)},
        min_observations=4, seed=0),
}


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_schedulers_match(name, mode):
    stream = _stream()
    want, got = _both(lambda tune, search, schedulers, experiment:
                      _run_scheduler(SCHEDULERS[name](tune, schedulers),
                                     experiment, stream, mode))
    assert got == want
    kinds = {entry[0] for entry in got}
    decisions = {entry[3] for entry in got if entry[0] == "result"}
    if name in ("pbt", "pb2"):
        assert "exploit" in kinds, got      # the stream reaches exploits
    else:
        assert "STOP" in decisions, got     # ... and stops

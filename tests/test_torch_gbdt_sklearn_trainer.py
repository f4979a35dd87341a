"""GBDT / sklearn trainers: Dataset ingest, per-round reporting,
checkpoint round-trip, mid-boost resume, on the port's cluster:
``test_gbdt_sklearn_trainer.py``'s cases, one for one.  This module
imports no JAX: the cluster's workers import it.

Reference shape: python/ray/train/tests/test_gbdt_trainer.py +
test_sklearn_trainer.py (fit on ray Datasets, resume from checkpoint).
"""

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.data as rtd
from ray_tpu_torch.train import GBDTTrainer, SklearnTrainer, load_estimator


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _make_datasets(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4))
    y = ((X[:, 0] + 0.5 * X[:, 1] - X[:, 2] * X[:, 3]) > 0).astype(int)
    rows = [{"f0": float(a), "f1": float(b), "f2": float(c),
             "f3": float(d), "label": int(t)}
            for (a, b, c, d), t in zip(X, y)]
    return (rtd.from_items(rows[: int(n * 0.8)]),
            rtd.from_items(rows[int(n * 0.8):]))


def test_sklearn_trainer_fits_and_checkpoints(cluster):
    from sklearn.linear_model import LogisticRegression
    train_ds, valid_ds = _make_datasets()
    trainer = SklearnTrainer(
        estimator=LogisticRegression(max_iter=200),
        label_column="label",
        datasets={"train": train_ds, "valid": valid_ds})
    result = trainer.fit()
    assert result.metrics["train_score"] > 0.7
    assert result.metrics["valid_score"] > 0.6
    est = load_estimator(result.checkpoint)
    pred = est.predict(np.zeros((2, 4)))
    assert pred.shape == (2,)


def test_gbdt_trainer_reports_rounds_and_learns(cluster):
    train_ds, valid_ds = _make_datasets()
    trainer = GBDTTrainer(
        label_column="label",
        params={"learning_rate": 0.2, "max_depth": 3},
        num_boost_round=16, rounds_per_report=4,
        datasets={"train": train_ds, "valid": valid_ds})
    result = trainer.fit()
    # 16 rounds / 4 per report = 4 reports, metrics from the last.
    assert result.metrics["boost_round"] == 16
    assert result.metrics["valid_score"] > 0.8, result.metrics
    est = load_estimator(result.checkpoint)
    assert est.n_iter_ == 16


def test_gbdt_trainer_resumes_mid_boost(cluster):
    """A booster checkpointed at round 8 must CONTINUE to 16, not refit
    from scratch (exactly-once boosting rounds across the resume)."""
    train_ds, valid_ds = _make_datasets()
    first = GBDTTrainer(
        label_column="label", params={"learning_rate": 0.2},
        num_boost_round=8, rounds_per_report=4,
        datasets={"train": train_ds, "valid": valid_ds})
    r1 = first.fit()
    assert load_estimator(r1.checkpoint).n_iter_ == 8

    resumed = GBDTTrainer(
        label_column="label", params={"learning_rate": 0.2},
        num_boost_round=16, rounds_per_report=4,
        datasets={"train": train_ds, "valid": valid_ds},
        resume_from_checkpoint=r1.checkpoint)
    r2 = resumed.fit()
    est = load_estimator(r2.checkpoint)
    assert est.n_iter_ == 16
    # Resume trained 8 more rounds: exactly 2 further reports (12, 16).
    rounds = [m["boost_round"] for m in r2.metrics_history]
    assert rounds == [12, 16], rounds

    # Degenerate resume (target already reached): still reports once
    # with the loaded estimator instead of returning an empty Result.
    again = GBDTTrainer(
        label_column="label", params={"learning_rate": 0.2},
        num_boost_round=16, rounds_per_report=4,
        datasets={"train": train_ds, "valid": valid_ds},
        resume_from_checkpoint=r2.checkpoint)
    r3 = again.fit()
    assert r3.metrics["boost_round"] == 16
    assert load_estimator(r3.checkpoint).n_iter_ == 16


def test_gbdt_regression_objective(cluster):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((300, 3))
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.standard_normal(300)
    rows = [{"a": float(r[0]), "b": float(r[1]), "c": float(r[2]),
             "target": float(t)} for r, t in zip(X, y)]
    trainer = GBDTTrainer(
        label_column="target", objective="regression",
        num_boost_round=24, rounds_per_report=8,
        datasets={"train": rtd.from_items(rows)})
    result = trainer.fit()
    assert result.metrics["train_score"] > 0.8   # R^2

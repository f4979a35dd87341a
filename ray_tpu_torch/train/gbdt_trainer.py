"""GBDT + sklearn trainers over the AIR trainer contract.

Port of ``ray_tpu/train/gbdt_trainer.py`` (scikit-learn only; nothing
of torch).  Design analog: reference ``python/ray/train/gbdt_trainer.py:105``
(GBDTTrainer: xgboost/lightgbm over actor gangs with Dataset ingest) and
``python/ray/train/sklearn/sklearn_trainer.py`` (SklearnTrainer: one
actor, joblib parallelism inside the estimator).  The package does not
depend on xgboost, so GBDTTrainer's booster is sklearn's native
HistGradientBoosting* — a real histogram gradient booster — trained
round-by-round via ``warm_start`` so every boosting round reports
metrics through ``session.report`` and checkpoints the booster
(resumable mid-boost, the reference's checkpoint-per-iteration
behavior).

Both trainers ride the existing BackendExecutor gang machinery
(DataParallelTrainer): ingest is a ray_tpu_torch Dataset materialized on the
training worker; extra gang members (if scaled) hold dataset shards for
parallel ingest and rank 0 fits — matching the reference's centralized
sklearn path.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer

_ESTIMATOR_KEY = "estimator_pkl"


def _dataset_to_xy(ds, label_column: str):
    """Materialize a ray_tpu_torch Dataset (of dict rows or a table) into
    (X, y) numpy arrays."""
    try:
        table = ds.to_arrow()
        cols = {name: np.asarray(table[name]) for name in table.column_names}
    except Exception:
        rows = ds.take_all()
        if not rows:
            raise ValueError("empty dataset")
        cols = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    y = cols.pop(label_column)
    X = np.column_stack([cols[k] for k in sorted(cols)])
    return X, y


def _estimator_checkpoint(est) -> Checkpoint:
    buf = io.BytesIO()
    pickle.dump(est, buf)
    return Checkpoint.from_dict({_ESTIMATOR_KEY: buf.getvalue()})


def load_estimator(checkpoint: Checkpoint):
    """Recover the fitted estimator from a trainer checkpoint (reference:
    ``SklearnCheckpoint.get_estimator``)."""
    return pickle.loads(checkpoint.to_dict()[_ESTIMATOR_KEY])


class SklearnTrainer(DataParallelTrainer):
    """Fit any sklearn estimator on a ray_tpu_torch Dataset.

    ``datasets={"train": ds[, "valid": ds]}``; reports train/valid scores
    via session.report and checkpoints the pickled estimator.
    Parallelism comes from the estimator itself (n_jobs) — the gang has
    one training member, like the reference's sklearn trainer.
    """

    def __init__(self, *, estimator, label_column: str,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):

        def loop(config=None):
            from ray_tpu_torch.air import session
            from ray_tpu_torch.train.data_parallel_trainer import \
                get_dataset_shard
            est = pickle.loads(config["estimator_pkl"])
            ckpt = session.get_checkpoint()
            if ckpt is not None:
                est = load_estimator(ckpt)
            X, y = _dataset_to_xy(get_dataset_shard("train"),
                                  config["label_column"])
            if not _is_fitted(est):
                est.fit(X, y)
            metrics = {"train_score": float(est.score(X, y))}
            try:
                vds = get_dataset_shard("valid")
            except KeyError:
                vds = None
            if vds is not None:
                Xv, yv = _dataset_to_xy(vds, config["label_column"])
                metrics["valid_score"] = float(est.score(Xv, yv))
            session.report(metrics, checkpoint=_estimator_checkpoint(est))

        super().__init__(
            loop,
            train_loop_config={
                "estimator_pkl": pickle.dumps(estimator),
                "label_column": label_column,
            },
            scaling_config=scaling_config or ScalingConfig(num_workers=1),
            run_config=run_config, datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)


def _is_fitted(est) -> bool:
    from sklearn.exceptions import NotFittedError
    from sklearn.utils.validation import check_is_fitted
    try:
        check_is_fitted(est)
        return True
    except NotFittedError:
        return False


class GBDTTrainer(DataParallelTrainer):
    """Gradient-boosted trees with per-round reporting and resumable
    checkpoints (reference GBDTTrainer shape, xgboost-free).

    ``params`` follow sklearn's HistGradientBoosting{Classifier,
    Regressor} (learning_rate, max_depth, ...); ``num_boost_round`` maps
    to trees.  Each round extends the booster via warm_start, reports
    train/valid scores, and checkpoints — resume_from_checkpoint picks
    up mid-boost exactly where it stopped.
    """

    def __init__(self, *, label_column: str,
                 params: Optional[Dict[str, Any]] = None,
                 num_boost_round: int = 32,
                 objective: str = "classification",
                 rounds_per_report: int = 4,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):

        def loop(config=None):
            from ray_tpu_torch.air import session
            if config["objective"] == "classification":
                from sklearn.ensemble import HistGradientBoostingClassifier \
                    as Booster
            else:
                from sklearn.ensemble import HistGradientBoostingRegressor \
                    as Booster
            from ray_tpu_torch.train.data_parallel_trainer import \
                get_dataset_shard
            total = config["num_boost_round"]
            chunk = max(1, config["rounds_per_report"])
            ckpt = session.get_checkpoint()
            if ckpt is not None:
                est = load_estimator(ckpt)
                est.set_params(warm_start=True)
                done = est.max_iter
            else:
                est = None          # built on the first chunk (sklearn
                done = 0            # rejects max_iter=0)
            X, y = _dataset_to_xy(get_dataset_shard("train"),
                                  config["label_column"])
            try:
                vds = get_dataset_shard("valid")
            except KeyError:
                vds = None
            Xv = yv = None
            if vds is not None:
                Xv, yv = _dataset_to_xy(vds, config["label_column"])
            if est is not None and done >= total:
                # Checkpoint already covers the requested rounds: still
                # report once, or fit() returns an empty Result and the
                # caller's load_estimator(result.checkpoint) breaks.
                metrics = {"boost_round": done,
                           "train_score": float(est.score(X, y))}
                if Xv is not None:
                    metrics["valid_score"] = float(est.score(Xv, yv))
                session.report(metrics,
                               checkpoint=_estimator_checkpoint(est))
            while done < total:
                done = min(done + chunk, total)
                if est is None:
                    est = Booster(**config["params"], warm_start=True,
                                  max_iter=done, early_stopping=False)
                else:
                    est.set_params(max_iter=done)
                est.fit(X, y)
                metrics = {"boost_round": done,
                           "train_score": float(est.score(X, y))}
                if Xv is not None:
                    metrics["valid_score"] = float(est.score(Xv, yv))
                session.report(metrics,
                               checkpoint=_estimator_checkpoint(est))

        super().__init__(
            loop,
            train_loop_config={
                "label_column": label_column,
                "params": dict(params or {}),
                "num_boost_round": num_boost_round,
                "objective": objective,
                "rounds_per_report": rounds_per_report,
            },
            scaling_config=scaling_config or ScalingConfig(num_workers=1),
            run_config=run_config, datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)

"""BatchPredictor: offline batch inference of a Checkpoint over a Dataset.

Port of ``ray_tpu/train/batch_predictor.py``.  Design analog: reference
``python/ray/train/batch_predictor.py`` — wraps a Predictor class in a
callable "scoring wrapper" mapped over the dataset with an actor pool, so
each scoring actor loads the model once and scores many blocks.  The
scoring actors hold no card (``ActorPoolStrategy`` asks for no resources,
as in the reference), so a ``TorchPredictor`` scores on the CPU: pass
``device="cpu"`` among the predictor's kwargs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type, Union

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.data.dataset import ActorPoolStrategy, Dataset
from ray_tpu_torch.train.predictor import Predictor


class _ScoringWrapper:
    """Callable class instantiated once per scoring actor; holds the
    restored predictor (reference batch_predictor.py ScoringWrapper)."""

    def __init__(self, predictor_cls, checkpoint_data: Dict,
                 predictor_kwargs: Dict, feature_columns, keep_columns,
                 prediction_column: str):
        self._predictor = predictor_cls.from_checkpoint(
            Checkpoint.from_dict(checkpoint_data), **predictor_kwargs)
        self._feature_columns = feature_columns
        self._keep_columns = keep_columns
        self._prediction_column = prediction_column

    def __call__(self, batch):
        if isinstance(batch, dict):
            if self._feature_columns:
                if len(self._feature_columns) == 1:
                    feats = batch[self._feature_columns[0]]
                else:
                    feats = np.stack(
                        [batch[c] for c in self._feature_columns], axis=-1)
            elif len(batch) == 1:
                feats = next(iter(batch.values()))
            else:
                feats = batch
        else:
            feats = batch
        pred = self._predictor.predict(feats)
        out = {self._prediction_column: np.asarray(pred)}
        if self._keep_columns and isinstance(batch, dict):
            for c in self._keep_columns:
                out[c] = batch[c]
        return out


class BatchPredictor:
    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset: Dataset, *,
                batch_size: int = 4096,
                min_scoring_workers: int = 1,
                max_scoring_workers: int = 4,
                feature_columns: Optional[list] = None,
                keep_columns: Optional[list] = None,
                prediction_column: str = "predictions") -> Dataset:
        """Score every row; returns a Dataset of prediction batches."""
        # Ship the checkpoint by value: a directory checkpoint's local path
        # does not exist on remote nodes, so materialize it to a dict
        # (to_dict handles both forms).
        return dataset.map_batches(
            _ScoringWrapper,
            batch_size=batch_size,
            compute=ActorPoolStrategy(min_size=min_scoring_workers,
                                      max_size=max_scoring_workers),
            fn_constructor_args=(self._predictor_cls,
                                 self._checkpoint.to_dict(),
                                 self._predictor_kwargs, feature_columns,
                                 keep_columns, prediction_column),
        )

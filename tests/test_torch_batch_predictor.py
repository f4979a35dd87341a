"""Predictor + BatchPredictor batch inference on the port's cluster:
``test_batch_predictor.py``'s cases, one for one, with ``TorchPredictor``
(``device="cpu"``: the scoring actors hold no card) where the reference
has ``JaxPredictor``.  This module imports no JAX: the cluster's workers
import it.

Reference analogs: python/ray/train/tests/test_batch_predictor.py — score a
checkpointed model over a Dataset with a scoring actor pool.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rt_data
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.data.dataset import ActorPoolStrategy
from ray_tpu_torch.train import BatchPredictor, TorchPredictor


@pytest.fixture(scope="module")
def bp_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _linear_apply(params, x):
    return x @ params["w"] + params["b"]


def _make_checkpoint():
    # y = 2x + 1 elementwise on a single feature.
    return Checkpoint.from_dict({
        "params": {"w": np.array([[2.0]], np.float32),
                   "b": np.array([1.0], np.float32)}})


def test_torch_predictor_from_checkpoint():
    p = TorchPredictor.from_checkpoint(_make_checkpoint(),
                                       apply_fn=_linear_apply, device="cpu")
    out = p.predict(np.array([[0.0], [1.0], [2.0]], np.float32))
    np.testing.assert_allclose(out[:, 0], [1.0, 3.0, 5.0])


def test_batch_predictor_scores_dataset(bp_cluster):
    ds = rt_data.from_items(
        [{"value": float(i)} for i in range(32)], parallelism=4)
    bp = BatchPredictor.from_checkpoint(
        _make_checkpoint(), TorchPredictor, apply_fn=_linear_apply,
        device="cpu")

    def reshape2d(batch):
        return {"value": batch["value"].reshape(-1, 1).astype(np.float32)}

    scored = bp.predict(ds.map_batches(reshape2d),
                        batch_size=8, max_scoring_workers=2,
                        feature_columns=["value"])
    rows = scored.take_all()
    got = sorted(float(np.ravel(r["predictions"])[0]) for r in rows)
    expect = sorted(2.0 * i + 1.0 for i in range(32))
    np.testing.assert_allclose(got, expect)


def test_callable_class_requires_actor_pool(bp_cluster):
    class Stateful:
        def __call__(self, b):
            return b

    ds = rt_data.range(4)
    with pytest.raises(ValueError, match="ActorPoolStrategy"):
        ds.map_batches(Stateful)


def test_callable_class_instantiated_once_per_actor(bp_cluster):
    class Counting:
        def __init__(self):
            import os
            self.pid = os.getpid()
            self.inits = 1

        def __call__(self, batch):
            # Return the actor pid for every row: rows from the same actor
            # must share one instance (same pid, init ran once).
            k = next(iter(batch))
            n = len(batch[k])
            return {"pid": np.full(n, self.pid, np.int64)}

    ds = rt_data.range(16, parallelism=8)
    out = ds.map_batches(Counting, compute=ActorPoolStrategy(size=2))
    pids = {int(r["pid"]) for r in out.take_all()}
    # 8 blocks over a 2-actor pool -> at most 2 distinct instances.
    assert 1 <= len(pids) <= 2

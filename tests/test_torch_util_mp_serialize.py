"""ray_tpu_torch.util.multiprocessing Pool + check_serialize
(VERDICT r2 §2.2 'ray.util misc' gaps).

The port's, case for case those of ``test_util_mp_serialize.py``; the
joblib backend is registered as ``ray_tpu_torch``.  This module imports
nothing of JAX: the cluster's workers import it.
"""

import threading

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.check_serialize import inspect_serializability
from ray_tpu_torch.util.multiprocessing import Pool


@pytest.fixture(scope="module")
def mp_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_pool_map_and_starmap(mp_cluster):
    with Pool(processes=2) as p:
        assert p.map(_sq, range(10)) == [x * x for x in range(10)]
        assert p.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]


def test_pool_apply_and_async(mp_cluster):
    with Pool(processes=2) as p:
        assert p.apply(_add, (2, 3)) == 5
        r = p.apply_async(_sq, (9,))
        assert r.get(timeout=30) == 81
        m = p.map_async(_sq, range(6))
        assert m.get(timeout=30) == [x * x for x in range(6)]


def test_pool_imap_orders(mp_cluster):
    with Pool(processes=2) as p:
        assert list(p.imap(_sq, range(8), chunksize=2)) == \
            [x * x for x in range(8)]
        assert sorted(p.imap_unordered(_sq, range(8), chunksize=2)) == \
            sorted(x * x for x in range(8))


def test_pool_initializer_runs_per_worker(mp_cluster):
    import os

    def init(tag):
        os.environ["POOL_TAG"] = tag

    def read(_):
        import os as _os
        return _os.environ.get("POOL_TAG")

    with Pool(processes=2, initializer=init, initargs=("hi",)) as p:
        assert p.map(read, range(4)) == ["hi"] * 4


def test_inspect_serializability_finds_inner_lock():
    lock = threading.Lock()

    def closure_fn():
        return lock

    ok, failures = inspect_serializability(closure_fn)
    assert not ok
    assert any(f.obj is lock for f in failures)

    class Holder:
        def __init__(self):
            self.fine = 42
            self.bad = threading.Lock()

    ok, failures = inspect_serializability(Holder())
    assert not ok
    assert any(f.name == "bad" for f in failures)

    ok, failures = inspect_serializability(lambda x: x + 1)
    assert ok and failures == []


def test_joblib_backend(mp_cluster):
    import math

    import joblib
    from joblib import Parallel, delayed

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu
    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch"):
        out = Parallel(n_jobs=2)(delayed(math.sqrt)(i) for i in range(12))
    assert out == [math.sqrt(i) for i in range(12)]


def test_joblib_backend_sklearn_style(mp_cluster):
    """A cross-validation-shaped workload: stateful fn + kwargs batches."""
    import joblib
    from joblib import Parallel, delayed

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu
    register_ray_tpu()

    def fit_score(fold, reg=1.0):
        return fold * reg

    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = Parallel()(delayed(fit_score)(f, reg=0.5) for f in range(8))
    assert out == [f * 0.5 for f in range(8)]

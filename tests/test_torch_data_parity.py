"""The port's Dataset against the JAX package's, on the same pipeline.

Each package runs it on its own cluster of 4 CPUs, one cluster after the
other (the push-based shuffle's merger count follows the cluster's CPUs,
so a seeded shuffle's order is the reference's only on a cluster of the
same size): ``from_numpy`` of 480 seeded rows in 16 blocks ->
``map_batches`` (a key and a float column from them) ->
``random_shuffle(seed=11)``, push-based at 16 blocks and the two-stage plan
at 4 -> ``sort`` -> ``groupby(key).aggregate(Count, Sum, Mean, Std)`` ->
``split(3, equal=True)`` -> ``iter_batches``.  The shuffled rows, their
order, the sorted rows, the aggregates and every split's batches are
equal, exactly.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

ROWS = np.random.default_rng(5).integers(0, 1000, (480, 3), dtype=np.int64)


def _pipeline(rd, blocks):
    """Everything the pipeline gives, as plain Python values."""
    def features(batch):
        d = batch["data"]
        return {"id": d[:, 0], "key": d[:, 1] % 7,
                "v": d[:, 2].astype(np.float64) / 8.0}

    ds = rd.from_numpy(ROWS, parallelism=blocks).map_batches(features)
    shuffled = ds.random_shuffle(seed=11)
    out = {"shuffled": [(int(r["id"]), int(r["key"]), float(r["v"]))
                        for r in shuffled.take_all()],
           "blocks": shuffled.num_blocks()}
    ordered = shuffled.sort("id")
    out["sorted"] = [int(r["id"]) for r in ordered.take_all()]
    agg = ordered.groupby("key").aggregate(
        rd.Count(), rd.Sum("v"), rd.Mean("v"), rd.Std("v"))
    out["aggregates"] = sorted(
        (int(r["key"]), int(r["count()"]), float(r["sum(v)"]),
         float(r["mean(v)"]), float(r["std(v)"])) for r in agg.take_all())
    out["splits"] = [
        [{k: v.tolist() for k, v in b.items()}
         for b in part.iter_batches(batch_size=32)]
        for part in shuffled.split(3, equal=True)]
    return out


def _run(package, blocks):
    package.init(num_cpus=4)
    try:
        from importlib import import_module
        return _pipeline(import_module(f"{package.__name__}.data"), blocks)
    finally:
        package.shutdown()


@pytest.mark.parametrize("blocks", [16, 4], ids=["push_based", "two_stage"])
def test_port_dataset_gives_the_reference_rows_order_and_aggregates(blocks):
    want = _run(ray_tpu, blocks)
    got = _run(ray_tpu_torch, blocks)
    assert got["blocks"] == want["blocks"] == blocks
    assert got["shuffled"] == want["shuffled"]
    assert [r[0] for r in got["shuffled"]] != sorted(ROWS[:, 0].tolist())
    assert got["sorted"] == want["sorted"] == sorted(ROWS[:, 0].tolist())
    assert got["aggregates"] == want["aggregates"]
    assert len(got["aggregates"]) == 7
    assert got["splits"] == want["splits"]
    assert sum(len(b["id"]) for part in got["splits"] for b in part) == 480

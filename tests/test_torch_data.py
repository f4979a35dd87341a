"""Data layer tests on the port's cluster: ``test_data.py``'s cases, one
for one.

Reference shape: python/ray/data/tests/test_dataset.py (range/from_items,
map/map_batches/filter, repartition, split for Train ingest, shuffle,
sort, zip, iter_batches, file IO round trips, pipeline windows).
``test_train_ingest_integration`` runs ``TorchTrainer`` where the JAX
package's runs ``JaxTrainer``.  This module imports no JAX: the cluster's
workers import it to run its functions.
"""

import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch import data as rd


def test_range_and_count(ray_start):  # noqa: F811
    ds = rd.range(100, parallelism=8)
    assert ds.count() == 100
    assert ds.num_blocks() == 8
    assert ds.take(5) == [0, 1, 2, 3, 4]


def test_from_items_map_filter(ray_start):  # noqa: F811
    ds = rd.from_items(list(range(20)), parallelism=4)
    out = ds.map(lambda x: x * 2).filter(lambda x: x % 4 == 0)
    vals = sorted(out.take_all())
    assert vals == [x * 2 for x in range(20) if (x * 2) % 4 == 0]


def test_flat_map(ray_start):  # noqa: F811
    ds = rd.from_items([1, 2, 3], parallelism=2)
    assert sorted(ds.flat_map(lambda x: [x, x]).take_all()) == \
        [1, 1, 2, 2, 3, 3]


def test_map_batches_numpy(ray_start):  # noqa: F811
    ds = rd.from_numpy(np.arange(32, dtype=np.float32), parallelism=4)

    def double(batch):
        return {"data": batch["data"] * 2}

    out = ds.map_batches(double, batch_size=8, batch_format="numpy")
    got = np.sort(np.concatenate(
        [np.atleast_1d(np.asarray(r["data"])) for r in out.take_all()]))
    np.testing.assert_array_equal(got, np.arange(32, dtype=np.float32) * 2)


def test_map_batches_pandas(ray_start):  # noqa: F811
    import pandas as pd
    df = pd.DataFrame({"a": range(10), "b": range(10)})
    ds = rd.from_pandas(df, parallelism=2)

    def add_col(batch):
        batch["c"] = batch["a"] + batch["b"]
        return batch

    out = ds.map_batches(add_col, batch_format="pandas")
    res = out.to_pandas().sort_values("a").reset_index(drop=True)
    assert (res["c"] == res["a"] + res["b"]).all()


def test_repartition_and_split(ray_start):  # noqa: F811
    ds = rd.range(100, parallelism=7)
    r = ds.repartition(4)
    assert r.num_blocks() == 4
    counts = [m.num_rows for m in r._meta()]
    assert sorted(counts) == [25, 25, 25, 25]
    assert sorted(r.take_all()) == list(range(100))

    shards = ds.split(4, equal=True)
    assert len(shards) == 4
    assert all(s.count() == 25 for s in shards)
    combined = sorted(sum((s.take_all() for s in shards), []))
    assert combined == list(range(100))


def test_random_shuffle(ray_start):  # noqa: F811
    ds = rd.range(50, parallelism=5)
    shuffled = ds.random_shuffle(seed=42)
    vals = shuffled.take_all()
    assert sorted(vals) == list(range(50))
    assert vals != list(range(50))


def test_sort(ray_start):  # noqa: F811
    import random
    items = list(range(40))
    random.Random(0).shuffle(items)
    ds = rd.from_items(items, parallelism=4)
    assert ds.sort().take_all() == list(range(40))
    assert ds.sort(descending=True).take_all() == list(range(39, -1, -1))

    recs = rd.from_items([{"k": i % 5, "v": i} for i in range(20)],
                         parallelism=3)
    out = recs.sort(key="k").take_all()
    assert [r["k"] for r in out] == sorted(i % 5 for i in range(20))


def test_zip_union_limit(ray_start):  # noqa: F811
    a = rd.from_items([{"x": i} for i in range(10)], parallelism=2)
    b = rd.from_items([{"y": i * 10} for i in range(10)], parallelism=2)
    z = a.zip(b)
    rows = z.take_all()
    assert all(r["y"] == r["x"] * 10 for r in rows)

    u = a.union(a)
    assert u.count() == 20
    assert a.limit(3).count() == 3


def test_aggregates(ray_start):  # noqa: F811
    ds = rd.range(10, parallelism=3)
    assert ds.sum() == 45
    assert ds.min() == 0
    assert ds.max() == 9
    assert ds.mean() == pytest.approx(4.5)
    recs = rd.from_items([{"v": float(i)} for i in range(5)], parallelism=2)
    assert recs.sum(on="v") == 10.0


def test_iter_batches_sizes(ray_start):  # noqa: F811
    ds = rd.range(25, parallelism=4)
    batches = list(ds.iter_batches(batch_size=10, batch_format="numpy"))
    sizes = [len(b["value"]) for b in batches]
    assert sum(sizes) == 25
    assert sizes[:-1] == [10, 10]
    # drop_last drops the remainder batch
    batches = list(ds.iter_batches(batch_size=10, drop_last=True))
    assert sum(len(b["value"]) for b in batches) == 20


def test_file_roundtrips(ray_start, tmp_path):  # noqa: F811
    import pandas as pd
    df = pd.DataFrame({"a": range(12), "b": [f"s{i}" for i in range(12)]})
    ds = rd.from_pandas(df, parallelism=3)

    pq_dir = str(tmp_path / "pq")
    ds.write_parquet(pq_dir)
    back = rd.read_parquet(pq_dir)
    assert back.count() == 12
    assert sorted(back.to_pandas()["a"].tolist()) == list(range(12))

    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    assert rd.read_csv(csv_dir).count() == 12

    json_dir = str(tmp_path / "json")
    ds.write_json(json_dir)
    assert rd.read_json(json_dir).count() == 12


def test_actor_pool_strategy(ray_start):  # noqa: F811
    ds = rd.range(16, parallelism=4)
    out = ds.map_batches(lambda b: {"value": b["value"] + 1},
                        compute=rd.ActorPoolStrategy(size=2))
    assert sorted(np.concatenate(
        [np.atleast_1d(np.asarray(r["value"])) for r in out.take_all()]
    ).tolist()) == list(range(1, 17))


def test_pipeline_windows_and_repeat(ray_start):  # noqa: F811
    ds = rd.range(12, parallelism=4)
    pipe = ds.window(blocks_per_window=2).map(lambda x: x + 1)
    vals = sorted(pipe.take(12))
    assert vals == list(range(1, 13))

    pipe2 = ds.repeat(2)
    assert len(list(pipe2.iter_rows())) == 24


def test_train_ingest_integration(ray_start):  # noqa: F811
    """Dataset -> TorchTrainer sharding (reference: Train DatasetSpec)."""
    from ray_tpu_torch.air import ScalingConfig, session
    from ray_tpu_torch.train import TorchConfig, TorchTrainer

    def loop(config):
        from ray_tpu_torch.train.data_parallel_trainer import \
            get_dataset_shard
        shard = get_dataset_shard("train")
        total = 0
        n = 0
        for batch in shard.iter_batches(batch_size=8):
            total += float(np.sum(batch["value"]))
            n += len(batch["value"])
        session.report({"total": total, "n": n})

    ds = rd.range(64, parallelism=8)
    trainer = TorchTrainer(
        loop,
        torch_config=TorchConfig(distributed=False),
        scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": ds},
    )
    result = trainer.fit()
    assert result.metrics["n"] == 32


def test_zip_misaligned_blocks(ray_start):  # noqa: F811
    a = rd.from_items([{"x": i} for i in range(4)], parallelism=1)
    a = rd.Dataset(a._blocks)  # 1 block of 4
    b1 = rd.from_items([{"y": i * 10} for i in range(2)], parallelism=1)
    b2 = rd.from_items([{"y": (i + 2) * 10} for i in range(2)], parallelism=1)
    b = b1.union(b2)  # 2 blocks of 2 (different layout, same total)
    rows = a.zip(b).take_all()
    assert all(r["y"] == r["x"] * 10 for r in rows)

    c = rd.from_items([{"y": 0}] * 3, parallelism=1)
    with pytest.raises(Exception):
        a.zip(c).take_all()


# ----------------------------------------- push shuffle + random access


def test_push_based_shuffle_preserves_rows(ray_start):  # noqa: F811
    ds = rd.from_items(list(range(200))).repartition(10)
    out = ds.random_shuffle(seed=7, push_based=True)
    rows = sorted(out.take_all())
    assert rows == list(range(200))
    # and it genuinely permuted
    assert out.take_all() != list(range(200))
    # block count preserved (one output partition per merger)
    assert len(out._blocks) == 10


def test_push_based_shuffle_auto_threshold(ray_start):  # noqa: F811
    small = rd.from_items(list(range(20))).repartition(2)
    assert sorted(small.random_shuffle(seed=1).take_all()) == list(range(20))
    big = rd.from_items(list(range(64))).repartition(8)  # auto push path
    assert sorted(big.random_shuffle(seed=1).take_all()) == list(range(64))


def test_random_access_dataset_point_lookups(ray_start):  # noqa: F811
    from ray_tpu_torch.data import RandomAccessDataset
    rows = [{"id": i, "val": i * i} for i in range(100)]
    ds = rd.from_items(rows).repartition(5)
    rad = RandomAccessDataset(ds, "id", num_workers=2)
    assert ray_tpu_torch.get(rad.get_async(17)) == {"id": 17, "val": 289}
    assert ray_tpu_torch.get(rad.get_async(0))["val"] == 0
    assert ray_tpu_torch.get(rad.get_async(1000)) is None
    got = rad.multiget([3, 99, 41, -5])
    assert [g["val"] if g else None for g in got] == [9, 9801, 1681, None]
    st = rad.stats()
    assert st["num_partitions"] == 2 and sum(st["rows_per_partition"]) == 100


def test_groupby_aggregations(ray_start):  # noqa: F811
    rows = [{"k": i % 3, "v": float(i)} for i in range(30)]
    ds = rd.from_items(rows).repartition(4)
    got = {r["k"]: r for r in ds.groupby("k").aggregate(
        rd.Count(), rd.Sum("v"), rd.Min("v"), rd.Max("v"),
        rd.Mean("v"), rd.Std("v")).take_all()}
    assert set(got) == {0, 1, 2}
    for k in range(3):
        vals = [float(i) for i in range(30) if i % 3 == k]
        r = got[k]
        assert r["count()"] == 10
        assert r["sum(v)"] == sum(vals)
        assert r["min(v)"] == min(vals) and r["max(v)"] == max(vals)
        assert abs(r["mean(v)"] - np.mean(vals)) < 1e-9
        assert abs(r["std(v)"] - np.std(vals, ddof=1)) < 1e-9


def test_groupby_callable_key_and_global_group(ray_start):  # noqa: F811
    ds = rd.from_items(list(range(20))).repartition(3)
    # Callable key: parity classes.
    out = {r["key"]: r["count()"] for r in
           ds.groupby(lambda x: x % 2).count().take_all()}
    assert out == {0: 10, 1: 10}
    # key=None: one global group.
    [row] = ds.groupby(None).sum().take_all()
    assert row["sum()"] == sum(range(20))


def test_groupby_map_groups(ray_start):  # noqa: F811
    rows = [{"g": "a" if i < 6 else "b", "v": i} for i in range(10)]
    ds = rd.from_items(rows).repartition(2)

    def top1(group_rows):
        best = max(group_rows, key=lambda r: r["v"])
        return [{"g": best["g"], "best": best["v"]}]

    got = sorted(ds.groupby("g").map_groups(top1).take_all(),
                 key=lambda r: r["g"])
    assert got == [{"g": "a", "best": 5}, {"g": "b", "best": 9}]


def test_groupby_custom_aggregate_fn(ray_start):  # noqa: F811
    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(8)])
    prod = rd.AggregateFn(
        init=lambda k: 1,
        accumulate=lambda a, r: a * (r["v"] + 1),
        name="prod(v+1)")
    got = {r["k"]: r["prod(v+1)"] for r in
           ds.groupby("k").aggregate(prod).take_all()}
    assert got[0] == 1 * 3 * 5 * 7 and got[1] == 2 * 4 * 6 * 8


def test_iter_torch_batches_and_to_torch(ray_start):  # noqa: F811
    import torch
    rows = [{"x": np.arange(4, dtype=np.float32) + i, "y": float(i)}
            for i in range(10)]
    ds = rd.from_items(rows).repartition(2)
    batches = list(ds.iter_torch_batches(batch_size=4))
    assert all(isinstance(b["x"], torch.Tensor) for b in batches)
    assert sum(b["y"].shape[0] for b in batches) == 10
    # dtype override
    b0 = next(iter(ds.iter_torch_batches(batch_size=4,
                                         dtypes={"y": torch.float64})))
    assert b0["y"].dtype == torch.float64
    # IterableDataset with label split
    it_ds = ds.to_torch(label_column="y", batch_size=5)
    feats, label = next(iter(it_ds))
    assert set(feats) == {"x"} and label.shape[0] == 5


def test_dataset_aggregate_global(ray_start):  # noqa: F811
    ds = rd.from_items([{"v": float(i)} for i in range(10)]).repartition(3)
    row = ds.aggregate(rd.Count(), rd.Mean("v"), rd.Max("v"))
    assert row["count()"] == 10
    assert abs(row["mean(v)"] - 4.5) < 1e-9 and row["max(v)"] == 9.0


def test_read_binary_files(ray_start, tmp_path):  # noqa: F811
    (tmp_path / "a.bin").write_bytes(b"\x00\x01\x02")
    (tmp_path / "b.bin").write_bytes(b"hello")
    ds = rd.read_binary_files(str(tmp_path), include_paths=True)
    rows = sorted(ds.take_all(), key=lambda r: r["path"])
    assert [r["bytes"] for r in rows] == [b"\x00\x01\x02", b"hello"]
    assert rows[0]["path"].endswith("a.bin")


def test_column_operations(ray_start):  # noqa: F811
    rows = [{"a": i, "b": 2 * i, "c": 3 * i} for i in range(8)]
    ds = rd.from_items(rows).repartition(2)
    assert set(ds.select_columns(["a", "c"]).take(1)[0]) == {"a", "c"}
    assert set(ds.drop_columns(["b"]).take(1)[0]) == {"a", "c"}
    with_sum = ds.add_column("s", lambda b: b["a"] + b["b"])
    assert [r["s"] for r in with_sum.take(3)] == [0, 3, 6]
    ren = ds.rename_columns({"a": "x"})
    assert set(ren.take(1)[0]) == {"x", "b", "c"}


def test_split_at_indices_and_train_test_split(ray_start):  # noqa: F811
    ds = rd.range(20, parallelism=3)
    a, b, c = ds.split_at_indices([5, 12])
    assert a.take_all() == list(range(5))
    assert b.take_all() == list(range(5, 12))
    assert c.take_all() == list(range(12, 20))
    # Degenerate cuts at block boundaries and 0.
    x, y = ds.split_at_indices([0])
    assert x.take_all() == [] and y.count() == 20
    train, test = ds.train_test_split(0.25)
    assert train.count() == 15 and test.count() == 5
    tr2, te2 = ds.train_test_split(0.3, shuffle=True, seed=5)
    assert sorted(tr2.take_all() + te2.take_all()) == list(range(20))
    assert te2.count() == 6


def test_push_shuffle_preserves_block_count_when_mergers_capped(ray_start):  # noqa: F811
    """With more blocks than 2*CPUs, mergers are capped but the output
    must still have len(blocks) blocks (zip/split alignment contracts).
    CPU count is patched small so the cap engages without spawning a
    32-actor gang on the 1-core CI box."""
    import unittest.mock as um

    import ray_tpu_torch as _rt
    ds = rd.range(60, parallelism=12)
    with um.patch.object(_rt, "cluster_resources",
                         return_value={"CPU": 2.0}):
        out = ds.random_shuffle(seed=3)   # mergers capped at 4
    assert out.num_blocks() == 12
    assert sorted(out.take_all()) == list(range(60))


def test_dataset_stats_fused_pipeline(ray_start):  # noqa: F811
    """ds.stats() reports per-stage wall/rows for a fused multi-stage
    pipeline plus barrier records (reference: data/_internal/stats.py)."""
    import ray_tpu_torch.data as rd
    ds = (rd.range(200, parallelism=4)
          .map(lambda x: x + 1)
          .filter(lambda x: x % 2 == 0)
          .random_shuffle(seed=0, push_based=True)
          .map(lambda x: x * 2))
    assert ds.count() == 100
    s = ds.stats()
    assert "push_based_shuffle" in s
    assert "map" in s and "filter" not in s.split("map")[0]
    # the final map stage ran on the shuffled blocks: rows 100 -> 100
    assert "rows 100 -> 100" in s
    # a streaming-executor consumption also collects stats
    ds2 = rd.range(100, parallelism=5).map(lambda x: x + 1)
    list(ds2.iter_batches(batch_size=50))
    assert "blocks" in ds2.stats()

"""Lazy execution plan, stage fusion, prefetched + device-put ingest, on
the port's cluster: ``test_data_lazy.py``'s cases, one for one.
``test_iter_device_batches`` takes ``device="cpu"`` and checks for
``torch.Tensor`` where the reference checks for ``jax.Array``; the card's
cases are in ``test_torch_data_gpu.py``.  This module imports no JAX: the
cluster's workers import it.

Reference analogs: _internal/plan.py (lazy ExecutionPlan + stage fusion),
the iter_batches prefetching path, and SURVEY §7 hard part (d) — ingest
must keep a step function unstarved.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch import data as rt_data


def test_transforms_are_lazy(ray_start):  # noqa: F811
    """map/filter append plan stages without launching tasks."""
    ds = rt_data.range(100, parallelism=4)
    mapped = ds.map(lambda x: x * 2).filter(lambda x: x % 4 == 0)
    assert mapped._executed is None
    assert len(mapped._stages) == 2
    # Consumption executes the plan.
    vals = sorted(mapped.take_all())
    assert vals == sorted(x * 2 for x in range(100) if (x * 2) % 4 == 0)
    assert mapped._executed is not None


def test_stage_fusion_single_task_per_block(ray_start):  # noqa: F811
    """Three chained maps must execute as ONE task per block, not three."""
    ds = rt_data.range(40, parallelism=4)
    out = ds.map(lambda x: x + 1).map(lambda x: x * 10).map(lambda x: x - 5)
    assert len(out._stages) == 3
    blocks = out._execute()
    assert len(blocks) == 4  # one fused task per input block
    assert sorted(out.take_all()) == sorted((x + 1) * 10 - 5
                                            for x in range(40))


def test_lazy_then_eager_chain(ray_start):  # noqa: F811
    """A transform on an executed dataset starts a fresh plan."""
    ds = rt_data.range(20, parallelism=2).map(lambda x: x + 1)
    assert ds.count() == 20          # executes
    out = ds.map(lambda x: x * 2)    # new stage on executed blocks
    assert out._executed is None
    assert sorted(out.take_all()) == [(x + 1) * 2 for x in range(20)]


def test_iter_batches_with_prefetch(ray_start):  # noqa: F811
    ds = rt_data.range(1000, parallelism=8)
    seen = []
    for b in ds.iter_batches(batch_size=100, prefetch_blocks=3):
        seen.extend(int(x) for x in b["value"])
    assert sorted(seen) == list(range(1000))


def test_iter_device_batches(ray_start):  # noqa: F811
    import torch
    ds = rt_data.from_numpy(np.arange(256, dtype=np.float32))
    total = 0.0
    count = 0
    for batch in ds.iter_device_batches(batch_size=64, drop_last=True,
                                        device="cpu"):
        assert isinstance(batch["data"], torch.Tensor)
        total += float(batch["data"].sum())
        count += 1
    assert count == 4
    assert total == float(np.arange(256).sum())


def test_ingest_not_starved(ray_start):  # noqa: F811
    """SURVEY hard part (d): with eager stage launch + block prefetch, the
    consumer's wall time approaches max(fetch, step), not fetch + step."""
    fetch_s = 0.15
    step_s = 0.15
    n_blocks = 8

    def slow_identity(batch):
        time.sleep(fetch_s)  # simulated read/decode latency in the stage
        return batch

    def run(prefetch):
        ds = rt_data.range_tensor(n_blocks * 10, shape=(4,),
                                  parallelism=n_blocks)
        ds = ds.map_batches(slow_identity, batch_size=None)
        t0 = time.monotonic()
        steps = 0
        for _ in ds.iter_batches(batch_size=10, prefetch_blocks=prefetch):
            time.sleep(step_s)  # simulated train step
            steps += 1
        assert steps == n_blocks
        return time.monotonic() - t0

    run(prefetch=3)  # warm-up: spawn and cache the task workers
    overlapped = run(prefetch=3)
    serial_bound = n_blocks * (fetch_s + step_s)
    # Overlapped ingest must beat the strictly serial bound by a clear
    # margin (perfect overlap would approach n_blocks * step_s).
    assert overlapped < serial_bound * 0.85, (
        f"ingest starved: {overlapped:.2f}s vs serial {serial_bound:.2f}s")


def test_parquet_roundtrip(ray_start, tmp_path):  # noqa: F811
    import pandas as pd
    df = pd.DataFrame({"a": np.arange(50), "b": np.arange(50) * 0.5})
    rt_data.from_pandas(df, parallelism=3).write_parquet(str(tmp_path / "p"))
    back = rt_data.read_parquet(str(tmp_path / "p")).to_pandas()
    back = back.sort_values("a").reset_index(drop=True)
    pd.testing.assert_frame_equal(back, df)

"""The port's device ingest (``Dataset.iter_device_batches``) and its block
rules, on the CPU.

* Without a card the entry point raises when it is called, before a batch
  is read, for ``device=None`` and for ``"cuda"``: it never falls back to
  the CPU.
* ``device="cpu"`` yields CPU tensors equal to the host batches, never
  pinned, each its own copy: a consumer that writes into the batch it
  holds changes neither the next batch nor the dataset.
* The next batch's copy is started before the current one is handed over
  (``copies_submitted`` runs one ahead of ``batches``).
* ``sharding=(mesh, spec)`` yields DTensors on the mesh whose local shard
  is the rank's slice of the host batch (a 4-rank gloo gang, dp=2 x tp=2).
* ``batch_to_block``: a CPU tensor returned by a ``map_batches`` fn
  becomes numpy; a tensor on another device (a ``meta`` tensor stands in
  for a card) raises.
* A column with no torch dtype raises naming the column.

The card's cases are in ``test_torch_data_gpu.py``.  This module imports
no JAX: the cluster's workers import it.
"""

import numpy as np
import pytest
import torch

import _torch_gang as gang
from _torch_runtime import ray_start  # noqa: F401
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.block import batch_to_block

ROWS = np.random.default_rng(0).integers(0, 1000, (40, 5), dtype=np.int64)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_raises_without_a_card_when_called(ray_start, device):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    ds = rd.from_numpy(ROWS, parallelism=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.iter_device_batches(batch_size=8, device=device)


def test_cpu_batches_equal_host_batches_and_are_copies(ray_start):  # noqa: F811
    ds = rd.from_numpy(ROWS, parallelism=4).random_shuffle(seed=3)
    host = [b["data"].copy() for b in ds.iter_batches(batch_size=8)]
    it = ds.iter_device_batches(batch_size=8, device="cpu")
    got = []
    for b in it:
        x = b["data"]
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert not x.is_pinned()
        got.append(x.numpy().copy())
        x.add_(10_000)                     # the consumer writes into it
    assert len(got) == len(host) == 5
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)
    again = [b["data"] for b in ds.iter_batches(batch_size=8)]
    for a, h in zip(again, host):
        np.testing.assert_array_equal(a, h)
    assert it.bytes_copied == ROWS.nbytes


def test_next_copy_is_started_before_the_batch_is_handed_over(
        ray_start):  # noqa: F811
    ds = rd.from_numpy(ROWS, parallelism=4)
    it = ds.iter_device_batches(batch_size=8, device="cpu", drop_last=False)
    seen = []
    for _ in it:
        seen.append((it.batches, it.copies_submitted))
    assert seen == [(1, 2), (2, 3), (3, 4), (4, 5), (5, 5)]


def test_sharded_batches_land_on_the_mesh():
    specs = {"dp": ("dp",), "dp_tp": ("dp", "tp")}
    out = gang.run(gang.data_sharded_ingest, 4, (ROWS, specs),
                   timeout_s=120)[0]
    host = [ROWS[i:i + 8] for i in range(0, 40, 8)]
    for name, batches in out.items():
        assert len(batches) == len(host), name
        for b, h in zip(batches, host):
            assert b["type"] == "DTensor"
            np.testing.assert_array_equal(b["full"], h)
    # rank 0 is (dp 0, tp 0): the first half of the rows; all five
    # columns when only dp splits, the first three when tp splits them too
    assert out["dp"][0]["placements"] == [("Shard", 0), ("Replicate", None)]
    np.testing.assert_array_equal(out["dp"][0]["local"], host[0][:4])
    assert out["dp_tp"][0]["placements"] == [("Shard", 0), ("Shard", 1)]
    np.testing.assert_array_equal(out["dp_tp"][0]["local"], host[0][:4, :3])


def test_batch_to_block_takes_cpu_tensors_and_refuses_others():
    block = batch_to_block({"x": torch.arange(4), "y": np.ones(4)})
    assert isinstance(block["x"], np.ndarray)
    np.testing.assert_array_equal(block["x"], np.arange(4))
    assert isinstance(batch_to_block(torch.zeros(3))["value"], np.ndarray)
    with pytest.raises(TypeError, match="meta"):
        batch_to_block({"x": torch.zeros(3, device="meta")})
    with pytest.raises(TypeError, match="meta"):
        batch_to_block(torch.zeros(3, device="meta"))


def test_map_batches_may_return_cpu_tensors(ray_start):  # noqa: F811
    ds = rd.from_numpy(ROWS, parallelism=4)

    def double(batch):
        import torch
        return {"data": torch.from_numpy(batch["data"]) * 2}

    got = np.concatenate([b["data"] for b in
                          ds.map_batches(double).iter_batches(batch_size=8)])
    np.testing.assert_array_equal(got, ROWS * 2)


def test_a_column_without_a_torch_dtype_raises(ray_start):  # noqa: F811
    ds = rd.from_items([{"name": "a", "v": 1}, {"name": "b", "v": 2}])
    with pytest.raises(TypeError, match="'name'"):
        list(ds.iter_device_batches(batch_size=2, device="cpu"))

"""``Dataset.iter_device_batches`` on the card: pinned staging buffers, a
side stream, the next batch's copy in flight during the consumer's step.

* The batches equal the host batches, bit for bit, in three dtypes and a
  ragged last batch, with two pinned buffers a column in all: also when
  the consumer holds every batch and reads them only at the end (a
  staging buffer reused before its copy had finished would show here).
* A consumer that writes into the batch it holds, on its own stream,
  changes neither the next batch nor the dataset.
* The next batch's copy runs during the consumer's step: it was submitted
  before the batch was handed over, on a stream that is not the
  consumer's, and on the card it starts before the step's work ends.
* Without a card (``CUDA_VISIBLE_DEVICES=""``) the entry point raises.

The tests need a CUDA card and skip without one.  This module imports
nothing of JAX, so on the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_data_gpu.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def card_cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run `python -m pytest "
                    "--noconftest -m gpu tests/test_torch_data_gpu.py`")
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _dataset(rows=1000, width=4096):
    rng = np.random.default_rng(0)
    items = {"x": rng.standard_normal((rows, width)).astype(np.float32),
             "ids": rng.integers(0, 1 << 40, (rows, 64), dtype=np.int64),
             "mask": rng.random((rows, 16)) < 0.5}
    refs = [ray_tpu_torch.put({k: v[i:i + 100] for k, v in items.items()})
            for i in range(0, rows, 100)]
    return rd.Dataset(refs)


def test_batches_equal_host_batches(card_cluster):
    ds = _dataset()
    host = list(ds.iter_batches(batch_size=96))
    it = ds.iter_device_batches(batch_size=96, drop_last=False)
    held = list(it)                         # every batch held to the end
    torch.cuda.synchronize()
    assert len(held) == len(host) == 11     # the last one ragged (40 rows)
    for got, want in zip(held, host):
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    assert it.pinned_allocs == 2 * 3
    assert it.bytes_copied == sum(v.nbytes for b in host for v in b.values())


def test_writes_into_the_held_batch_leave_the_next_one(card_cluster):
    ds = _dataset()
    host = list(ds.iter_batches(batch_size=100))
    step = torch.cuda.Stream()
    for got, want in zip(ds.iter_device_batches(batch_size=100), host):
        np.testing.assert_array_equal(got["x"].cpu().numpy(), want["x"])
        step.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(step):
            got["x"].mul_(-3.0).add_(7.0)
            got["ids"].zero_()
            got["x"].record_stream(step)
            got["ids"].record_stream(step)
    torch.cuda.synchronize()
    for got, want in zip(ds.iter_batches(batch_size=100), host):
        np.testing.assert_array_equal(got["x"], want["x"])


def test_next_copy_runs_during_the_step(card_cluster):
    ds = _dataset(rows=600)
    it = ds.iter_device_batches(batch_size=100)
    a = torch.randn(4096, 4096, device="cuda")
    overlaps = []
    for i, batch in enumerate(it):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):                 # the step: ~tens of ms of matmul
            a = (a @ a) / 64.0
        float(batch["x"].sum())
        end.record()
        if i + 1 < 6:
            assert it.copies_submitted == i + 2
            nxt_start, _ = it.copier._timing[i + 1]
            assert it.copier.stream != torch.cuda.current_stream()
            overlaps.append((nxt_start, end))
        torch.cuda.synchronize()
    # each next copy started on the card before the step on the current
    # batch had finished
    assert all(s.elapsed_time(e) > 0 for s, e in overlaps), [
        s.elapsed_time(e) for s, e in overlaps]


def test_raises_without_a_card(card_cluster):
    code = """
import numpy as np
import ray_tpu_torch
from ray_tpu_torch import data as rd
ray_tpu_torch.init(local_mode=True)
ds = rd.from_numpy(np.arange(64, dtype=np.float32))
try:
    ds.iter_device_batches(batch_size=8)
except RuntimeError as e:
    print("RAISED", e)
ray_tpu_torch.shutdown()
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True, check=True).stdout
    assert "RAISED" in out and "CUDA" in out

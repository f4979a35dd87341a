"""Object spilling under memory pressure + OOM worker-killing policy.

Reference analogs: python/ray/tests/test_object_spilling.py (fill the store
past capacity, everything stays readable via disk) and
raylet/worker_killing_policy.h (retriable-LIFO kill selection).

The port's runtime under ``test_spilling.py``'s cases, one for one.
"""

import glob
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

_SPILL_GLOB = os.path.join(tempfile.gettempdir(), "rtt_spill_*", "*.bin")

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state


@pytest.fixture()
def small_store_cluster():
    # 64MB store; the workload below puts ~100MB of primary copies.
    ray_tpu_torch.init(num_cpus=2, object_store_memory=64 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


def test_put_beyond_capacity_spills_and_restores(small_store_cluster):
    """Primary copies never get silently LRU-evicted: overflowing puts spill
    cold objects to disk, and gets transparently restore them."""
    mb8 = 8 * 1024 * 1024 // 8  # float64 count for an 8MB array
    refs = [ray_tpu_torch.put(np.full(mb8, float(i))) for i in range(12)]  # ~96MB
    # Every object is still readable, including the spilled cold ones.
    for i, ref in enumerate(refs):
        arr = ray_tpu_torch.get(ref, timeout=120)
        assert float(arr[0]) == float(i) and arr.shape == (mb8,)


def test_spill_updates_object_directory(small_store_cluster):
    mb8 = 8 * 1024 * 1024 // 8
    refs = [ray_tpu_torch.put(np.full(mb8, float(i))) for i in range(12)]
    objs = state.list_objects()
    spilled = [o for o in objs if o.get("spilled")]
    assert spilled, "overflow puts should have spilled something"
    # Restore one spilled object; its directory entry gets a node back.
    target = spilled[0]["object_id"]
    ref = next(r for r in refs if r.id.hex() == target)
    assert ray_tpu_torch.get(ref, timeout=120) is not None
    entry = next(o for o in state.list_objects()
                 if o["object_id"] == target)
    assert entry["locations"], "restored object should be back in memory"


def test_task_returns_spill_too(small_store_cluster):
    @ray_tpu_torch.remote
    def make(i):
        return np.full(8 * 1024 * 1024 // 8, float(i))

    refs = [make.remote(i) for i in range(12)]
    for i, ref in enumerate(refs):
        assert float(ray_tpu_torch.get(ref, timeout=180)[0]) == float(i)


def test_freed_spilled_objects_release_disk(small_store_cluster):
    """Dropping the last reference to a spilled object deletes its spill
    file and directory entry (no unbounded disk growth)."""
    mb8 = 8 * 1024 * 1024 // 8
    refs = [ray_tpu_torch.put(np.full(mb8, float(i))) for i in range(12)]
    assert any(o.get("spilled") for o in state.list_objects())
    n_files_before = len(glob.glob(_SPILL_GLOB))
    assert n_files_before > 0
    del refs
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        files = len(glob.glob(_SPILL_GLOB))
        entries = len(state.list_objects())
        if files == 0 and entries == 0:
            break
        time.sleep(0.5)
    assert len(glob.glob(_SPILL_GLOB)) == 0
    assert state.list_objects() == []


def test_spilled_bf16_tensor_restores_bit_identical(small_store_cluster):
    """A bf16 tensor (no numpy dtype of its own) spilled to disk comes
    back with its dtype and the same bits."""
    import torch
    gen = torch.Generator().manual_seed(0)
    cold = torch.randn(4 * 1024 * 1024, generator=gen).to(torch.bfloat16)
    ref = ray_tpu_torch.put(cold)                      # 8MB, put first
    mb8 = 8 * 1024 * 1024 // 8
    others = [ray_tpu_torch.put(np.full(mb8, float(i))) for i in range(11)]
    entry = next(o for o in state.list_objects()
                 if o["object_id"] == ref.id.hex())
    assert entry.get("spilled"), "the coldest object should have spilled"
    back = ray_tpu_torch.get(ref, timeout=120)
    assert back.dtype == torch.bfloat16 and back.shape == cold.shape
    assert torch.equal(back.view(torch.int16), cold.view(torch.int16))
    del others


# --------------------------------------------------------------- OOM policy


@dataclass
class _FakeProc:
    killed: bool = False
    rc: Optional[int] = None

    def poll(self):
        return self.rc

    def kill(self):
        self.killed = True
        self.rc = -9


def _fake_worker(actor_id=None, lease_id=None, busy=False, busy_since=0.0):
    from ray_tpu_torch._private.ids import WorkerID
    from ray_tpu_torch._private.raylet import WorkerHandle
    return WorkerHandle(worker_id=WorkerID.from_random(), proc=_FakeProc(),
                        actor_id=actor_id, lease_id=lease_id, busy=busy,
                        busy_since=busy_since)


def _policy_pick(workers):
    from ray_tpu_torch._private.raylet import Raylet
    dummy = object.__new__(Raylet)  # policy only reads .workers
    dummy.workers = {w.worker_id: w for w in workers}
    return Raylet._pick_worker_to_kill(dummy)


def test_oom_policy_prefers_newest_leased_task_worker():
    old = _fake_worker(lease_id="a", busy=True, busy_since=1.0)
    new = _fake_worker(lease_id="b", busy=True, busy_since=2.0)
    actor = _fake_worker(actor_id="act", busy=True, busy_since=3.0)
    idle = _fake_worker()
    assert _policy_pick([old, new, actor, idle]) is new


def test_oom_policy_never_kills_actors_or_idle():
    actor = _fake_worker(actor_id="act", busy=True, busy_since=3.0)
    idle = _fake_worker()
    assert _policy_pick([actor, idle]) is None

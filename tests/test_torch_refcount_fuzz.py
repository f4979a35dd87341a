"""Randomized ownership/borrowing stress.

Design analog: the reference's huge edge-case surface in
``src/ray/core_worker/reference_count.cc`` +
``test/reference_count_test.cc``.  Instead of enumerating cases, drive a
seeded random DAG of tasks that pass refs (top-level AND nested in
containers), drop driver handles mid-flight, and spawn borrower chains —
then assert (a) every surviving ref still resolves to the right value,
(b) nothing leaks after all handles die.

The port's runtime under ``test_refcount_fuzz.py``'s cases, one for one.
"""

import gc
import random

import numpy as np
from _torch_runtime import ray_start  # noqa: F401

import ray_tpu_torch


@ray_tpu_torch.remote
def make_blob(seed: int, kb: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, kb * 1024, dtype=np.uint8)


@ray_tpu_torch.remote
def digest(arr):
    return int(np.asarray(arr, dtype=np.uint64).sum())


@ray_tpu_torch.remote
def digest_nested(container):
    """Borrows refs nested inside a container and resolves them."""
    refs = container["refs"]
    vals = ray_tpu_torch.get(list(refs))
    return [int(np.asarray(v, dtype=np.uint64).sum()) for v in vals]


@ray_tpu_torch.remote
def chain(container, depth: int):
    """Borrower chain: re-ships the same nested refs through more tasks."""
    if depth <= 0:
        return ray_tpu_torch.get(digest_nested.remote(container))
    return ray_tpu_torch.get(chain.remote(container, depth - 1))


def test_random_borrow_graph_resolves_correctly(ray_start):
    rng = random.Random(7)
    blobs = {}          # seed -> ref
    expected = {}       # seed -> digest value
    for seed in range(12):
        kb = rng.choice([1, 4, 64, 300])   # inline AND plasma objects
        blobs[seed] = make_blob.remote(seed, kb)
        arr = np.random.default_rng(seed).integers(
            0, 256, kb * 1024, dtype=np.uint8)
        expected[seed] = int(arr.astype(np.uint64).sum())

    pending = []
    for i in range(30):
        seeds = rng.sample(sorted(blobs), k=rng.randint(1, 4))
        container = {"refs": [blobs[s] for s in seeds]}
        if rng.random() < 0.5:
            pending.append((seeds,
                            chain.remote(container, rng.randint(0, 2))))
        else:
            pending.append((seeds, digest_nested.remote(container)))
        # Randomly drop some driver handles mid-flight: in-flight
        # borrowers must keep the blobs alive regardless.
        if rng.random() < 0.3 and len(blobs) > 4:
            victim = rng.choice(sorted(blobs))
            del blobs[victim]
            gc.collect()

    for seeds, ref in pending:
        got = ray_tpu_torch.get(ref, timeout=120)
        assert got == [expected[s] for s in seeds], seeds


def test_no_leak_after_all_handles_die(ray_start):
    """After dropping every handle, the driver's owned/lineage tables
    shrink back — no unbounded growth from the fuzz workload."""
    from ray_tpu_torch._private.worker import get_core
    core = get_core()
    gc.collect()
    base_owned = len(core.owned)

    refs = [make_blob.remote(s, 2) for s in range(20)]
    outs = [digest.remote(r) for r in refs]
    assert all(isinstance(v, int) for v in ray_tpu_torch.get(outs, timeout=60))
    del refs, outs
    gc.collect()
    # Release notifications flow through the loop; poll briefly.
    import time
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and \
            len(core.owned) > base_owned + 2:
        time.sleep(0.25)
        gc.collect()
    assert len(core.owned) <= base_owned + 2, (
        f"owned grew {base_owned} -> {len(core.owned)}")

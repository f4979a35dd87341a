"""Data-plane chaos: corrupt holders, torn spill files, and flaky fetch
replies on REAL multi-node clusters.

The contract under test (ISSUE: self-healing object data plane): a node
serving corrupted bytes or holding a torn spill file is *quarantined* —
its directory location invalidated, the corruption counted — while every
``ray_tpu_torch.get`` is still served from a healthy copy or reconstructed from
lineage.  Corrupted bytes must never be sealed into any plasma store.

Run via ``scripts/run_chaos.sh data-chaos`` (3x under CPU load).

The port's runtime under ``test_data_chaos.py``'s cases, one for one.
"""

import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import fault_injection, state

pytestmark = [pytest.mark.slow, pytest.mark.chaos, pytest.mark.data_chaos]

MB = 1024 * 1024


def _locations(oid_hex):
    from ray_tpu_torch._private.worker import get_core
    return get_core().gcs_request(
        {"type": "object_locations_get", "object_id": oid_hex}) or {}


def _wait_spilled(ref, node_id, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if node_id in _locations(ref.id.hex()).get("spilled", {}):
            return
        time.sleep(0.2)
    raise TimeoutError(
        f"object {ref.id.hex()[:16]} not spilled on {node_id[:12]} "
        f"within {timeout}s: {_locations(ref.id.hex())}")


def _wait_totals(predicate, timeout=30):
    """Node-stats pushes lag live counters by up to one heartbeat period;
    poll the rollup instead of sleeping a magic number."""
    deadline = time.monotonic() + timeout
    totals = {}
    while time.monotonic() < deadline:
        totals = state.data_plane_totals()
        if predicate(totals):
            return totals
        time.sleep(0.3)
    raise AssertionError(f"data-plane totals never converged: {totals}")


@ray_tpu_torch.remote
def _first(arr):
    return float(arr[0])


@ray_tpu_torch.remote
def _make(value, mb=8):
    return np.full(mb * MB // 8, float(value))


def test_corrupt_holder_quarantined_object_still_served():
    """One of three nodes bit-flips every chunk it serves.  The puller
    detects the mismatch against the creator's seal-time crc32, strikes
    the corrupt holder out of the object directory, and seals the healthy
    copy from the remaining holder — every get returns correct bytes."""
    cluster = Cluster(head_node_args={"num_cpus": 1,
                                      "object_store_memory": 32 * MB})
    bad = cluster.add_node(
        num_cpus=1, resources={"bad": 1.0},
        env=fault_injection.env_for(corrupt_chunk={"every": 1}))
    cluster.add_node(num_cpus=1, resources={"good": 1.0})
    try:
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes()
        head_id = cluster.head_node.node_id

        # Overflow the head's store so the object's only healthy copy is
        # the head's SPILL file (in-memory candidates are tried before
        # spilled ones, so the corrupt holder goes first deterministically).
        ref = ray_tpu_torch.put(np.full(8 * MB // 8, 7.0))
        fillers = [ray_tpu_torch.put(np.full(8 * MB // 8, float(i)))
                   for i in range(3)]
        _wait_spilled(ref, head_id)

        # Warm the bad node: it pulls the (healthy) spill copy and becomes
        # the object's only in-memory holder.
        assert ray_tpu_torch.get(
            _first.options(resources={"bad": 1.0}).remote(ref),
            timeout=120) == 7.0
        loc = _locations(ref.id.hex())
        assert bad.node_id in loc["nodes"], loc

        # The consumer's pull tries the bad node's memory copy first,
        # catches the crc mismatch, quarantines it, and falls through to
        # the head's spill copy — the get is still served, correctly.
        assert ray_tpu_torch.get(
            _first.options(resources={"good": 1.0}).remote(ref),
            timeout=120) == 7.0
        loc = _locations(ref.id.hex())
        assert bad.node_id not in loc["nodes"], loc
        assert bad.node_id not in loc.get("spilled", {}), loc

        # The driver still reads it too (restore from the head's spill).
        assert float(ray_tpu_torch.get(ref, timeout=120)[0]) == 7.0
        for i, f in enumerate(fillers):
            assert float(ray_tpu_torch.get(f, timeout=120)[0]) == float(i)

        totals = _wait_totals(
            lambda t: t["objects_corrupted"] >= 1
            and t["invalidations_by_node"].get(bad.node_id, 0) >= 1)

        # The corruption is visible on the dashboard scrape.
        dash = cluster.head_node.info["dashboard_address"]
        body = urllib.request.urlopen(
            f"http://{dash}/api/metrics", timeout=10).read().decode()
        assert "ray_tpu_objects_corrupted" in body
        assert "ray_tpu_object_location_invalidations" in body
        assert bad.node_id in body, \
            f"no per-node invalidation series for {bad.node_id[:12]}"
        assert totals["invalidations_by_node"][bad.node_id] >= 1
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_torn_spill_quarantined_object_reconstructed():
    """Every spill on the bad node is truncated post-write (a torn write
    that survived a crash).  The restore detects it via the spill header,
    quarantines the file, and the consumer's get is served anyway through
    lineage reconstruction of the producing task."""
    cluster = Cluster(head_node_args={"num_cpus": 1})
    bad = cluster.add_node(
        num_cpus=1, resources={"bad": 1.0}, object_store_memory=32 * MB,
        env=fault_injection.env_for(truncate_spill={"every": 1}))
    cluster.add_node(num_cpus=1, resources={"good": 1.0})
    try:
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes()

        # X first, then fillers: the spill sweep walks directory insertion
        # order, so X's spill file is the one that gets torn.
        x = _make.options(resources={"bad": 1.0}).remote(3.0)
        fillers = [_make.options(resources={"bad": 1.0}).remote(float(i))
                   for i in range(3)]
        _wait_spilled(x, bad.node_id)

        # The consumer runs ON the torn-file node: its raylet's restore
        # fails crc verification, unlinks the file, strikes itself in the
        # directory — and the owner reconstructs X from lineage.
        assert ray_tpu_torch.get(
            _first.options(resources={"bad": 1.0}).remote(x),
            timeout=180) == 3.0
        del fillers

        totals = _wait_totals(
            lambda t: t["objects_corrupted"] >= 1
            and t["invalidations_by_node"].get(bad.node_id, 0) >= 1)
        assert totals["invalidations_by_node"][bad.node_id] >= 1
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_dropped_fetch_replies_absorbed_by_pull_retry():
    """A holder failing every second fetch request is latency, not data
    loss: the puller's bounded retry rounds re-ask the GCS and try again,
    and every get succeeds without touching lineage."""
    cluster = Cluster(head_node_args={"num_cpus": 1})
    cluster.add_node(
        num_cpus=1, resources={"bad": 1.0},
        env=fault_injection.env_for(drop_fetch_reply={"every": 2}))
    cluster.add_node(num_cpus=1, resources={"good": 1.0})
    try:
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes()

        # Single-chunk objects (>inline ceiling) held only on the flaky
        # node; half the pulls hit a dropped first fetch.
        refs = [_make.options(resources={"bad": 1.0}).remote(float(i), 1)
                for i in range(4)]
        got = ray_tpu_torch.get(
            [_first.options(resources={"good": 1.0}).remote(r)
             for r in refs], timeout=180)
        assert got == [0.0, 1.0, 2.0, 3.0]

        totals = _wait_totals(lambda t: t["pull_retries"] >= 1)
        assert totals["objects_corrupted"] == 0
        assert totals["invalidations_by_node"] == {}
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()

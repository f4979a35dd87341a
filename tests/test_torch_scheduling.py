"""Scheduling policies: SPREAD, node affinity, hybrid spillback, and
ICI-aware TPU bundle packing.

Reference analogs: python/ray/tests/test_scheduling.py and the policy suite
in src/ray/raylet/scheduling/policy/ (hybrid, spread, node-affinity,
scorer); the TPU slice-adjacency ordering is new capability (SURVEY hard
part (b)).

The port's runtime under ``test_scheduling.py``'s cases, one for one.
"""

import asyncio
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, SPREAD)


@pytest.fixture(scope="module")
def sched_cluster():
    cluster = Cluster(head_node_args={"num_cpus": 2})
    n1 = cluster.add_node(num_cpus=2)
    n2 = cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes()
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


@ray_tpu_torch.remote
def _where():
    return os.environ.get("RT_NODE_ID")


def test_spread_uses_multiple_nodes(sched_cluster):
    nodes = ray_tpu_torch.get(
        [_where.options(scheduling_strategy=SPREAD).remote()
         for _ in range(9)], timeout=120)
    assert len(set(nodes)) >= 2


def test_node_affinity_hard_pins_to_node(sched_cluster):
    target = sched_cluster.worker_nodes[0].node_id
    got = ray_tpu_torch.get(
        [_where.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=target)).remote() for _ in range(3)], timeout=120)
    assert set(got) == {target}


def test_node_affinity_to_dead_node_raises(sched_cluster):
    with pytest.raises(ray_tpu_torch.exceptions.SchedulingError):
        ray_tpu_torch.get(_where.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id="deadbeef" * 4)).remote(), timeout=60)


def test_hybrid_spillback_uses_idle_capacity(sched_cluster):
    """A saturated node forwards leases to nodes with free capacity instead
    of queueing everything locally (hybrid policy)."""
    @ray_tpu_torch.remote(num_cpus=2)
    def hog():
        time.sleep(1.0)
        return os.environ.get("RT_NODE_ID")

    # Space the submissions past one heartbeat period: the hybrid policy
    # scores spill targets from the GCS availability view, which refreshes
    # every 0.5s — simultaneous submissions race on stale views (the
    # reference has the same property; its mitigation is backlog gossip).
    refs = []
    for _ in range(3):
        refs.append(hog.remote())
        time.sleep(0.8)
    nodes = ray_tpu_torch.get(refs, timeout=120)
    # Without the hybrid policy all three queue serially on the head
    # (single node in the result); with it, a saturated node forwards.
    assert len(set(nodes)) >= 2, nodes


def test_pg_packs_tpu_bundles_within_one_slice():
    """ICI adjacency: with two half-full slices, a 2-bundle TPU placement
    group lands entirely inside one slice, not across both."""
    from ray_tpu_torch._private.gcs import (GcsServer, NodeInfo,
                                            PlacementGroupInfo)
    from ray_tpu_torch._private.ids import NodeID, PlacementGroupID

    class FakeConn:
        async def request(self, msg, timeout=None):
            return {"ok": True}

        async def notify(self, msg):
            return None

    async def run():
        gcs = GcsServer()
        slices = {}
        for s in ("alpha", "beta"):
            for h in range(2):
                nid = NodeID.from_random()
                # Asymmetric CPU: a raw free-resource-sum ordering would
                # interleave slices; the ICI ordering must not.
                cpu = 8.0 if s == "alpha" else 64.0
                res = {"CPU": cpu, "TPU": 4.0, f"tpu-slice:{s}": 1.0}
                gcs.nodes[nid] = NodeInfo(
                    node_id=nid, address=f"{s}-{h}", store_name="x",
                    resources_total=dict(res),
                    resources_available=dict(res), conn=FakeConn())
                slices.setdefault(s, []).append(nid)
        pg = PlacementGroupInfo(
            pg_id=PlacementGroupID.from_random(),
            bundles=[{"TPU": 4.0}, {"TPU": 4.0}], strategy="SPREAD")
        gcs.placement_groups[pg.pg_id] = pg
        await gcs._schedule_pg(pg)
        assert pg.state == "CREATED"
        placed = set(pg.allocations.values())
        in_alpha = placed <= set(slices["alpha"])
        in_beta = placed <= set(slices["beta"])
        assert in_alpha or in_beta, (
            f"bundles split across slices: {pg.allocations}")

    asyncio.run(run())


def test_recursive_tasks_deeper_than_cpu_count():
    """Recursive task trees must not deadlock when every CPU slot holds a
    parent blocked in get() (blocked-worker resource release; reference:
    NotifyDirectCallTaskBlocked).  depth 5 > num_cpus=2."""
    import ray_tpu_torch
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def rec(depth):
            if depth <= 0:
                return 1
            return 1 + ray_tpu_torch.get(rec.remote(depth - 1))

        assert ray_tpu_torch.get(rec.remote(5), timeout=120) == 6
    finally:
        ray_tpu_torch.shutdown()


def test_accelerator_type_constraint():
    """@remote(accelerator_type=...) schedules only onto nodes
    advertising that TPU generation (reference: ray.util.accelerators)."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(head_node_args={
        "num_cpus": 1,
        "resources": {"accelerator_type:v5e": 4.0}})
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(accelerator_type="v5e", num_cpus=0.1)
        def where():
            import os
            return os.environ.get("RT_NODE_ID")

        assert ray_tpu_torch.get(where.remote(), timeout=60)

        # A generation nobody advertises fails fast (this runtime's
        # designed infeasible-forever semantics) with a clear error.
        @ray_tpu_torch.remote(accelerator_type="v9x", num_cpus=0.1)
        def nope():
            return 1

        with pytest.raises(Exception):
            ray_tpu_torch.get(nope.remote(), timeout=30)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()

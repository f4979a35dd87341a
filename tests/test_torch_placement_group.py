"""Placement group tests of the port's runtime over its
``cluster_utils.Cluster``, case for case those of
``test_placement_group.py`` (reference analog:
tests/test_placement_group*.py)."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)


def _wait_available(want, timeout=60.0):
    import time
    deadline = time.monotonic() + timeout
    while True:
        got = {k: ray_tpu_torch.available_resources().get(k) for k in want}
        if got == want or time.monotonic() > deadline:
            return got
        time.sleep(0.1)


def test_task_of_a_removed_group_returns_its_card_once(tmp_path):
    """ROADMAP C11: a num_gpus=1 task leased from a one-bundle group whose
    group is removed while it runs.  return_bundle gives the node the
    bundle's whole shape back, so the task's end must return its resources
    to no pool (the node would read GPU 3.0, CPU 9.0) and its card id
    once.  Runs before the module's cluster starts: it needs its own node
    of 2 fake cards and 8 CPUs."""
    import os
    import time
    release = tmp_path / "release"
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 2})
    try:
        pg = placement_group([{"GPU": 1, "CPU": 1}], strategy="PACK")
        assert pg.ready(timeout=30)

        @ray_tpu_torch.remote(num_gpus=1, num_cpus=1)
        def held(path):
            while not os.path.exists(path):
                time.sleep(0.05)
            return os.environ["CUDA_VISIBLE_DEVICES"]

        ref = held.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=0)).remote(
                    str(release))
        assert _wait_available({"GPU": 1.0, "CPU": 7.0}) == \
            {"GPU": 1.0, "CPU": 7.0}
        remove_placement_group(pg)
        release.touch()
        assert ray_tpu_torch.get(ref, timeout=60) in ("0", "1")
        time.sleep(1.0)
        assert _wait_available({"GPU": 2.0, "CPU": 8.0}) == \
            {"GPU": 2.0, "CPU": 8.0}
        ids = ray_tpu_torch.get([held.remote(str(release)),
                                 held.remote(str(release))], timeout=60)
        assert sorted(ids) == ["0", "1"], ids
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def pg_cluster():
    c = Cluster(head_node_args={"num_cpus": 4})
    c.add_node(num_cpus=4)
    c.add_node(num_cpus=4)
    ray_tpu_torch.init(address=c.address)
    c.wait_for_nodes()
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


def test_pack_pg_ready(pg_cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    allocs = pg.allocations()
    assert len(allocs) == 2
    # PACK prefers one node for all bundles
    assert len(set(allocs.values())) == 1
    remove_placement_group(pg)


def test_strict_spread_distinct_nodes(pg_cluster):
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)
    allocs = pg.allocations()
    assert len(set(allocs.values())) == 3
    remove_placement_group(pg)


def test_task_in_pg_bundle(pg_cluster):
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.ready(timeout=30)
    target = pg.allocations()[0]

    @ray_tpu_torch.remote(num_cpus=1, scheduling_strategy=PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0))
    def where():
        import os
        return os.environ["RT_NODE_ID"]

    assert ray_tpu_torch.get(where.remote()) == target
    remove_placement_group(pg)


def test_actor_gang_in_pg(pg_cluster):
    """Gang of actors, one per bundle, STRICT_SPREAD -- the Train worker-group
    pattern (one actor per host)."""
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)

    @ray_tpu_torch.remote(num_cpus=1)
    class HostWorker:
        def node(self):
            import os
            return os.environ["RT_NODE_ID"]

    actors = [
        HostWorker.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(3)
    ]
    nodes = ray_tpu_torch.get([a.node.remote() for a in actors])
    assert len(set(nodes)) == 3
    for a in actors:
        ray_tpu_torch.kill(a)
    remove_placement_group(pg)

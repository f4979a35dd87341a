"""Multi-node tests using the simulated cluster
(reference analog: tests using ray.cluster_utils.Cluster + test_failure*.py).

The port's runtime under ``test_cluster.py``'s cases, one for one, but for
its two per-node serve ingress cases, which come with serve.
"""

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


def test_two_nodes_registered(cluster):
    alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
    assert len(alive) == 2
    assert ray_tpu_torch.cluster_resources().get("CPU") == 4.0


def test_task_spillback_to_remote_node(cluster):
    """A task needing a resource only on the worker node spills over."""

    @ray_tpu_torch.remote(resources={"worker_node": 1.0}, num_cpus=1)
    def where():
        import os
        return os.environ["RT_NODE_ID"]

    node_id = ray_tpu_torch.get(where.remote())
    worker_node = cluster.worker_nodes[0]
    assert node_id == worker_node.node_id


def test_cross_node_object_transfer(cluster):
    """Large object produced on one node, consumed on another -> pull path."""

    @ray_tpu_torch.remote(resources={"worker_node": 1.0})
    def produce():
        return np.arange(500_000, dtype=np.float64)  # 4MB, plasma on worker node

    @ray_tpu_torch.remote(num_cpus=1)
    def consume(arr):
        return float(arr.sum())

    ref = produce.remote()
    expect = float(np.arange(500_000, dtype=np.float64).sum())
    # Driver-side get pulls to head node plasma.
    arr = ray_tpu_torch.get(ref)
    assert float(arr.sum()) == expect
    # Task on head node also resolves it.
    assert ray_tpu_torch.get(consume.remote(ref)) == expect


def test_actor_node_death_restart(cluster):
    """Actor restarts on another node when its node dies
    (reference analog: test_actor_failures / gcs actor reconstruction)."""
    n2 = cluster.add_node(num_cpus=2, resources={"doomed": 1.0})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(max_restarts=1, resources={"doomed": 0.001})
    class A:
        def node(self):
            import os
            return os.environ["RT_NODE_ID"]

    a = A.remote()  # lands on the doomed node via its custom resource
    assert ray_tpu_torch.get(a.node.remote()) == n2.node_id

    cluster.remove_node(n2)  # hard kill; "doomed" now exists nowhere
    # Recovery gate: wait for the GCS to record the death.  The killed
    # node's actor worker lingers up to ~1s (it self-exits when it
    # notices its raylet is gone), and a call in that window succeeds
    # against the OLD incarnation — a stale read, not a restart.
    from ray_tpu_torch.util import fault_injection
    fault_injection.wait_node_dead(n2.node_id, timeout=60)
    n3 = cluster.add_node(num_cpus=2, resources={"doomed": 1.0})
    deadline = time.monotonic() + 60
    while True:
        try:
            nid = ray_tpu_torch.get(a.node.remote(), timeout=10)
            if nid == n3.node_id:
                break   # served by the restarted incarnation
        except Exception:
            pass
        assert time.monotonic() < deadline, \
            f"actor never recovered onto {n3.node_id[:12]}"
        time.sleep(0.5)
    assert nid == n3.node_id


def test_gpu_actor_restarts_on_a_node_with_a_card(cluster):
    """A ``num_gpus=1`` actor whose node dies restarts only where a card
    is: the two nodes of the fixture have none, so the restart waits for
    the new node that advertises one, and gets its card there."""
    from ray_tpu_torch.util import fault_injection
    n2 = cluster.add_node(num_cpus=1, resources={"GPU": 1.0})
    cluster.wait_for_nodes()

    @ray_tpu_torch.remote(num_gpus=1, max_restarts=1)
    class OnCard:
        def where(self):
            import os
            return os.environ["RT_NODE_ID"], os.environ["CUDA_VISIBLE_DEVICES"]

    a = OnCard.remote()
    assert ray_tpu_torch.get(a.where.remote(), timeout=120) == (n2.node_id,
                                                                 "0")
    cluster.remove_node(n2)
    fault_injection.wait_node_dead(n2.node_id, timeout=60)
    n3 = cluster.add_node(num_cpus=1, resources={"GPU": 1.0})
    deadline = time.monotonic() + 120
    while True:
        try:
            got = ray_tpu_torch.get(a.where.remote(), timeout=10)
            if got[0] == n3.node_id:
                break
        except Exception:
            pass
        assert time.monotonic() < deadline, \
            f"actor never recovered onto {n3.node_id[:12]}"
        time.sleep(0.5)
    assert got == (n3.node_id, "0")
    ray_tpu_torch.kill(a)

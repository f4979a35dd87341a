"""Ray Client mode: a driver connected purely over TCP (ray:// address).

Reference analogs: python/ray/util/client/ (ray://host:10001 remote
drivers).  The client driver has NO local shared-memory attach — tasks,
actors, and object bytes all travel over the socket protocol.

The port's, case for case those of ``test_ray_client.py``.  This module
imports nothing of JAX: the cluster's workers import it.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def client_cluster():
    cluster = Cluster(head_node_args={"num_cpus": 4})
    ray_tpu_torch.init(address=f"ray://{cluster.address}")
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_client_mode_has_no_plasma(client_cluster):
    from ray_tpu_torch._private.worker import get_core
    assert get_core().plasma is None


def test_client_tasks_and_actors(client_cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(20, 22), timeout=120) == 42

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert ray_tpu_torch.get([c.inc.remote() for _ in range(3)],
                       timeout=120) == [1, 2, 3]


def test_client_large_objects_roundtrip(client_cluster):
    """Multi-MB values flow over the socket in both directions (worker
    stores them in ITS node's plasma; the client fetches bytes from the
    owner/raylet path)."""
    @ray_tpu_torch.remote
    def big():
        return np.ones(500_000, np.float64)  # 4MB

    arr = ray_tpu_torch.get(big.remote(), timeout=120)
    assert float(arr.sum()) == 500_000.0

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    ref = ray_tpu_torch.put(np.full(300_000, 2.0))
    assert ray_tpu_torch.get(total.remote(ref), timeout=120) == 600_000.0

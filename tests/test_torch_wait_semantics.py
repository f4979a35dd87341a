"""wait() semantics: metadata-only readiness + fetch_local prefetch.

Reference analogs: python/ray/tests/test_wait.py and the fetch_local
contract of ray.wait (wait never moves value bytes; fetch_local pulls
ready objects in the background).

The port's runtime under ``test_wait_semantics.py``'s cases, one for one.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def wait_cluster():
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, resources={"remote_node": 1.0})
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes()
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def _core():
    from ray_tpu_torch._private.worker import get_core
    return get_core()


@ray_tpu_torch.remote(resources={"remote_node": 0.001})
def _make_remote_blob():
    return np.ones(2_000_000, np.float64)  # 16MB, plasma on remote node


def test_wait_does_not_move_bytes(wait_cluster):
    ref = _make_remote_blob.remote()
    ready, not_ready = ray_tpu_torch.wait([ref], num_returns=1, timeout=120,
                                          fetch_local=False)
    assert ready == [ref] and not_ready == []
    # Readiness was metadata-only: the 16MB value is NOT in local plasma.
    assert not _core().plasma.contains(ref.id)
    # And the value is still retrievable afterwards.
    assert float(ray_tpu_torch.get(ref, timeout=120)[0]) == 1.0


def test_wait_fetch_local_prefetches(wait_cluster):
    ref = _make_remote_blob.remote()
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=120,
                                  fetch_local=True)
    assert ready == [ref]
    deadline = time.monotonic() + 60
    while not _core().plasma.contains(ref.id):
        assert time.monotonic() < deadline, "fetch_local never pulled"
        time.sleep(0.2)


def test_wait_timeout_returns_not_ready(wait_cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return 1

    ref = slow.remote()
    ready, not_ready = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.5)
    assert ready == [] and not_ready == [ref]
    assert ray_tpu_torch.get(ref, timeout=60) == 1

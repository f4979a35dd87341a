"""Locality-aware leasing: tasks consuming large objects run on the node
holding them.

Reference analog: src/ray/core_worker/lease_policy.h
(LocalityAwareLeasePolicy backed by the LocalityData from the object
directory).

The port's runtime under ``test_locality_scheduling.py``'s cases, one for one.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def loc_cluster():
    cluster = Cluster(head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2, resources={"producer": 1.0})
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes()
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_consumer_follows_large_arg(loc_cluster):
    @ray_tpu_torch.remote(resources={"producer": 0.001})
    def produce():
        return np.ones(2_000_000, np.float64), os.environ["RT_NODE_ID"]

    @ray_tpu_torch.remote
    def consume(pair):
        arr, producer_node = pair
        return float(arr[0]), producer_node, os.environ["RT_NODE_ID"]

    ref = produce.remote()
    # Wait until the large result is registered on the producer node.
    ray_tpu_torch.wait([ref], num_returns=1, timeout=120, fetch_local=False)
    first, producer_node, consumer_node = ray_tpu_torch.get(
        consume.remote(ref), timeout=120)
    assert first == 1.0
    assert consumer_node == producer_node, (
        "consumer should lease on the node holding its 16MB argument")


def test_small_args_stay_local(loc_cluster):
    """Inline-sized args carry no locality signal; the task leases from
    the local (driver) raylet as before."""
    @ray_tpu_torch.remote
    def echo(x):
        return x, os.environ["RT_NODE_ID"]

    _, node = ray_tpu_torch.get(echo.remote(7), timeout=60)
    head = loc_cluster.head_node.node_id
    assert node == head

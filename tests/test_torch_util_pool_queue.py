"""ActorPool and distributed Queue on the port's cluster:
``test_util_pool_queue.py``'s cases, one for one.  This module imports no
JAX: the cluster's workers import it.

Reference analogs: python/ray/tests/test_actor_pool.py and
test_queue.py.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module")
def pool_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Doubler:
    def double(self, v):
        return 2 * v

    def slow_double(self, v):
        time.sleep(0.1 * (v % 3))
        return 2 * v


def test_actor_pool_map_ordered(pool_cluster):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    assert list(pool.map(lambda a, v: a.double.remote(v), range(8))) == \
        [0, 2, 4, 6, 8, 10, 12, 14]


def test_actor_pool_map_unordered(pool_cluster):
    pool = ActorPool([_Doubler.remote() for _ in range(2)])
    got = sorted(pool.map_unordered(
        lambda a, v: a.slow_double.remote(v), range(6)))
    assert got == [0, 2, 4, 6, 8, 10]


def test_actor_pool_submit_get_next(pool_cluster):
    pool = ActorPool([_Doubler.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 20)
    assert pool.has_next()
    assert pool.get_next() == 20
    assert pool.get_next() == 40
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()


def test_queue_fifo_and_nowait(pool_cluster):
    q = Queue(maxsize=2)
    q.put("a")
    q.put("b")
    with pytest.raises(Full):
        q.put("c", block=False)
    assert q.qsize() == 2
    assert q.get() == "a"
    assert q.get() == "b"
    with pytest.raises(Empty):
        q.get(block=False)


def test_queue_blocking_get_across_processes(pool_cluster):
    q = Queue()

    @ray_tpu_torch.remote
    def producer(queue, n):
        for i in range(n):
            queue.put(i)
        return True

    ref = producer.remote(q, 5)
    got = [q.get(timeout=60) for _ in range(5)]
    assert got == [0, 1, 2, 3, 4]
    assert ray_tpu_torch.get(ref)


def test_queue_batch(pool_cluster):
    q = Queue()
    for i in range(4):
        q.put(i)
    assert q.get_nowait_batch(10) == [0, 1, 2, 3]

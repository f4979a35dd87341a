"""ray_tpu_torch.util.collective — host-driven named collective groups.

The port's mirror of tests/test_collective.py (reference analog:
python/ray/util/collective tests: allreduce/allgather/broadcast/barrier/
send-recv across actor members via the Gloo CPU path), plus torch tensors
through the same groups.  This module imports no JAX: the cluster's
workers import it to build the members.
"""

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_cluster():
    ray_tpu_torch.init(num_cpus=16)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_cpus=0.5)
class Member:
    def __init__(self, world, rank, group):
        from ray_tpu_torch.util import collective
        self.c = collective
        self.rank = rank
        self.c.init_collective_group(world, rank, group_name=group)
        self.group = group

    def allreduce(self, arr, op="sum"):
        return self.c.allreduce(np.asarray(arr), op=op,
                                group_name=self.group)

    def allgather(self, arr):
        return self.c.allgather(np.asarray(arr), group_name=self.group)

    def reducescatter(self, arr):
        return self.c.reducescatter(np.asarray(arr), group_name=self.group)

    def broadcast(self, arr, src):
        return self.c.broadcast(np.asarray(arr), src_rank=src,
                                group_name=self.group)

    def barrier_then_rank(self):
        self.c.barrier(group_name=self.group)
        return self.rank

    def send(self, arr, dst):
        return self.c.send(np.asarray(arr), dst, group_name=self.group)

    def recv(self, src):
        return self.c.recv(src, group_name=self.group)

    def allreduce_tensor(self, values, dtype):
        import torch
        out = self.c.allreduce(torch.tensor(values, dtype=getattr(
            torch, dtype)), group_name=self.group)
        return str(out.dtype), out.float().tolist()


def _members(n, group):
    return [Member.remote(n, r, group) for r in range(n)]


def test_allreduce_sum_and_mean(ray_cluster):
    ms = _members(4, "g_ar")
    outs = ray_tpu_torch.get([m.allreduce.remote([float(i)] * 3)
                        for i, m in enumerate(ms)])
    for o in outs:
        np.testing.assert_allclose(o, [6.0, 6.0, 6.0])
    outs = ray_tpu_torch.get([m.allreduce.remote([float(i)] * 3, "mean")
                        for i, m in enumerate(ms)])
    for o in outs:
        np.testing.assert_allclose(o, [1.5, 1.5, 1.5])


def test_allgather_ordered(ray_cluster):
    ms = _members(3, "g_ag")
    outs = ray_tpu_torch.get([m.allgather.remote([i * 10]) for i, m in
                        enumerate(ms)])
    for o in outs:
        assert [int(x[0]) for x in o] == [0, 10, 20]


def test_reducescatter_chunks(ray_cluster):
    ms = _members(2, "g_rs")
    outs = ray_tpu_torch.get([m.reducescatter.remote(np.arange(4.0))
                        for m in ms])
    np.testing.assert_allclose(outs[0], [0.0, 2.0])
    np.testing.assert_allclose(outs[1], [4.0, 6.0])


def test_broadcast_from_src(ray_cluster):
    ms = _members(3, "g_bc")
    outs = ray_tpu_torch.get([m.broadcast.remote([100 + i], 1)
                        for i, m in enumerate(ms)])
    for o in outs:
        assert int(o[0]) == 101


def test_barrier(ray_cluster):
    ms = _members(3, "g_ba")
    assert sorted(ray_tpu_torch.get([m.barrier_then_rank.remote()
                               for m in ms])) == [0, 1, 2]


def test_send_recv(ray_cluster):
    ms = _members(2, "g_p2p")
    r = ms[1].recv.remote(0)
    ray_tpu_torch.get(ms[0].send.remote([7.5], 1))
    np.testing.assert_allclose(ray_tpu_torch.get(r), [7.5])


def test_allreduce_torch_tensors(ray_cluster):
    """Tensors go through the coordinator as tensors: bf16 stays bf16 (a
    numpy round trip would lose it)."""
    ms = _members(2, "g_ar_t")
    outs = ray_tpu_torch.get([m.allreduce_tensor.remote([1.0 + i, 2.0],
                                                         "bfloat16")
                              for i, m in enumerate(ms)])
    assert outs == [("torch.bfloat16", [3.0, 4.0])] * 2

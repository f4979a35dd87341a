"""Core task/object API tests of the port's runtime, case for case those of
``test_core_basic.py`` (reference analog: python/ray/tests/test_basic*.py).
"""

import numpy as np
import pytest
from _torch_runtime import ray_start  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError, TaskError


@ray_tpu_torch.remote
def f_add(a, b):
    return a + b


@ray_tpu_torch.remote
def f_identity(x):
    return x


@ray_tpu_torch.remote
def f_fail():
    raise ValueError("boom")


def test_simple_task(ray_start):
    assert ray_tpu_torch.get(f_add.remote(1, 2)) == 3


def test_kwargs_and_options(ray_start):
    @ray_tpu_torch.remote
    def g(a, b=10):
        return a * b

    assert ray_tpu_torch.get(g.remote(3)) == 30
    assert ray_tpu_torch.get(g.options(num_cpus=0.5).remote(3, b=2)) == 6


def test_multiple_returns(ray_start):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_put_get_roundtrip(ray_start):
    for value in [42, "hello", {"k": [1, 2]}, None, (1, "x")]:
        assert ray_tpu_torch.get(ray_tpu_torch.put(value)) == value


def test_large_object_plasma(ray_start):
    arr = np.random.rand(500_000).astype(np.float32)  # ~2MB -> plasma
    out = ray_tpu_torch.get(ray_tpu_torch.put(arr))
    np.testing.assert_array_equal(out, arr)


def test_task_arg_by_ref(ray_start):
    big = np.arange(300_000, dtype=np.int64)  # > inline threshold
    ref = ray_tpu_torch.put(big)
    out = ray_tpu_torch.get(f_identity.remote(ref))
    np.testing.assert_array_equal(out, big)


def test_task_dependency_chain(ray_start):
    r1 = f_add.remote(1, 1)
    r2 = f_add.remote(r1, 1)
    r3 = f_add.remote(r2, r1)
    assert ray_tpu_torch.get(r3) == 5


def test_task_error_propagates(ray_start):
    with pytest.raises(TaskError) as exc_info:
        ray_tpu_torch.get(f_fail.remote())
    assert "boom" in str(exc_info.value)
    assert isinstance(exc_info.value.cause, ValueError)


def test_get_timeout(ray_start):
    @ray_tpu_torch.remote
    def slow():
        import time
        time.sleep(30)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.5)


def test_wait(ray_start):
    import time

    @ray_tpu_torch.remote
    def sleeper(t):
        time.sleep(t)
        return t

    fast = sleeper.remote(0.01)
    slow = sleeper.remote(5.0)
    ready, not_ready = ray_tpu_torch.wait([fast, slow], num_returns=1, timeout=10)
    assert ready == [fast]
    assert not_ready == [slow]


def test_nested_tasks(ray_start):
    @ray_tpu_torch.remote
    def outer(n):
        refs = [f_add.remote(i, i) for i in range(n)]
        return sum(ray_tpu_torch.get(refs))

    assert ray_tpu_torch.get(outer.options(num_cpus=0.5).remote(3)) == 6


def test_nested_ref_in_container(ray_start):
    inner = ray_tpu_torch.put(np.arange(200_000))  # plasma object

    @ray_tpu_torch.remote
    def consume(d):
        return int(ray_tpu_torch.get(d["ref"]).sum())

    assert ray_tpu_torch.get(consume.remote({"ref": inner})) == \
        int(np.arange(200_000).sum())


def test_cluster_resources(ray_start):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 16.0


def test_torch_tensor_roundtrip(ray_start):
    import torch

    x = torch.arange(32, dtype=torch.float32)
    out = ray_tpu_torch.get(ray_tpu_torch.put(x))
    assert isinstance(out, torch.Tensor) and torch.equal(out, x)


def test_dynamic_num_returns_generator_task(ray_start):
    """num_returns="dynamic" (reference: generator tasks): the task
    yields a data-dependent number of values; get(ref) returns an
    ObjectRefGenerator of per-yield refs."""
    @ray_tpu_torch.remote(num_returns="dynamic")
    def splat(n):
        for i in range(n):
            yield i * i

    gen = ray_tpu_torch.get(splat.remote(5))
    from ray_tpu_torch import ObjectRefGenerator
    assert isinstance(gen, ObjectRefGenerator)
    assert len(gen) == 5
    assert ray_tpu_torch.get(list(gen)) == [0, 1, 4, 9, 16]
    # Works with zero yields too.
    assert len(ray_tpu_torch.get(splat.remote(0))) == 0
    # Refs remain gettable individually (ownership registered).
    g2 = ray_tpu_torch.get(splat.remote(3))
    assert ray_tpu_torch.get(g2[2]) == 4


def test_get_runtime_context(ray_start):
    """ray.get_runtime_context() analog: driver vs task vs actor views."""
    ctx = ray_tpu_torch.get_runtime_context()
    assert ctx.worker_mode == "driver"
    assert ctx.get_task_id() is None and ctx.get_actor_id() is None
    assert len(ctx.get_node_id()) > 8

    @ray_tpu_torch.remote
    def probe():
        c = ray_tpu_torch.get_runtime_context()
        return c.get()

    d = ray_tpu_torch.get(probe.remote())
    assert d["worker_mode"] == "worker"
    assert d["task_id"] and d["actor_id"] is None
    assert d["node_id"] == ctx.get_node_id()   # single-node cluster

    @ray_tpu_torch.remote
    class A:
        def who(self):
            return ray_tpu_torch.get_runtime_context().get()

    a = A.remote()
    d = ray_tpu_torch.get(a.who.remote())
    assert d["actor_id"]


def test_local_mode_inline_execution():
    """ray.init(local_mode=True) analog: tasks/actors run inline, errors
    surface at get(), dynamic returns work, named actors resolve."""
    import ray_tpu_torch as rt
    rt.shutdown()
    info = rt.init(local_mode=True)
    try:
        assert info.get("local_mode") is True

        calls = []

        @rt.remote
        def f(x):
            calls.append(x)     # proof of in-process execution
            return x + 1

        r = f.remote(1)
        assert calls == [1]     # ran synchronously at .remote()
        assert rt.get(r) == 2
        assert rt.get(f.remote(rt.put(10))) == 11

        @rt.remote
        def boom():
            raise ValueError("inline boom")

        ref = boom.remote()
        with pytest.raises(ValueError, match="inline boom"):
            rt.get(ref)

        @rt.remote(num_returns="dynamic")
        def gen(n):
            yield from range(n)

        assert rt.get(list(rt.get(gen.remote(3)))) == [0, 1, 2]

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.options(name="cnt").remote()
        assert rt.get(c.inc.remote()) == 1
        c2 = rt.get_actor("cnt")
        assert rt.get(c2.inc.remote()) == 2
        ready, rest = rt.wait([rt.put(1), rt.put(2)])
        assert len(ready) == 1 and len(rest) == 1

        @rt.remote(num_returns=2)
        def boom2():
            raise ValueError("boom2")

        a, b = boom2.remote()   # must unpack, same as cluster mode
        for r in (a, b):
            with pytest.raises(ValueError, match="boom2"):
                rt.get(r)
    finally:
        rt.shutdown()

"""Actor tests of the port's runtime, case for case those of
``test_actors.py`` (reference analog: python/ray/tests/test_actor*.py)."""

import time

import pytest
from _torch_runtime import ray_start  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, TaskError


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, k=1):
        self.n += k
        return self.n

    def get(self):
        return self.n

    def fail(self):
        raise RuntimeError("actor method failure")

    def get_pid(self):
        import os
        return os.getpid()


def test_actor_basic(ray_start):
    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.incr.remote()) == 11
    assert ray_tpu_torch.get(c.incr.remote(5)) == 16
    assert ray_tpu_torch.get(c.get.remote()) == 16


def test_actor_ordering(ray_start):
    c = Counter.remote()
    refs = [c.incr.remote() for _ in range(50)]
    assert ray_tpu_torch.get(refs) == list(range(1, 51))


def test_actor_method_error(ray_start):
    c = Counter.remote()
    with pytest.raises(TaskError):
        ray_tpu_torch.get(c.fail.remote())
    # actor still alive afterwards
    assert ray_tpu_torch.get(c.incr.remote()) == 1


def test_named_actor(ray_start):
    Counter.options(name="global_counter").remote(100)
    h = ray_tpu_torch.get_actor("global_counter")
    assert ray_tpu_torch.get(h.get.remote()) == 100
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("nonexistent_actor")


def test_get_if_exists(ray_start):
    a = Counter.options(name="gie", get_if_exists=True).remote(1)
    b = Counter.options(name="gie", get_if_exists=True).remote(1)
    ray_tpu_torch.get(a.incr.remote())
    assert ray_tpu_torch.get(b.get.remote()) == 2  # same actor


def test_kill_actor(ray_start):
    c = Counter.remote()
    ray_tpu_torch.get(c.incr.remote())
    ray_tpu_torch.kill(c)
    time.sleep(0.2)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(c.incr.remote())


def test_actor_restart(ray_start):
    @ray_tpu_torch.remote(max_restarts=2)
    class Flaky:
        def __init__(self):
            self.n = 0

        def pid(self):
            import os
            return os.getpid()

        def die(self):
            import os
            os._exit(1)

        def ping(self):
            self.n += 1
            return self.n

    a = Flaky.remote()
    pid1 = ray_tpu_torch.get(a.pid.remote())
    try:
        ray_tpu_torch.get(a.die.remote())
    except Exception:
        pass
    # restarted actor: state reset, new pid
    deadline = time.monotonic() + 20
    while True:
        try:
            pid2 = ray_tpu_torch.get(a.pid.remote())
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    assert pid2 != pid1
    assert ray_tpu_torch.get(a.ping.remote()) == 1


def test_actor_no_restart_dies(ray_start):
    @ray_tpu_torch.remote(max_restarts=0)
    class Mortal:
        def die(self):
            import os
            os._exit(1)

        def ping(self):
            return "pong"

    a = Mortal.remote()
    try:
        ray_tpu_torch.get(a.die.remote())
    except Exception:
        pass
    time.sleep(0.5)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(a.ping.remote())


def test_async_actor_concurrency(ray_start):
    @ray_tpu_torch.remote(max_concurrency=8)
    class AsyncActor:
        async def slow(self):
            import asyncio
            await asyncio.sleep(0.3)
            return 1

    a = AsyncActor.remote()
    ray_tpu_torch.get(a.slow.remote())  # warm-up: actor created, conn established
    t0 = time.monotonic()
    refs = [a.slow.remote() for _ in range(8)]
    assert sum(ray_tpu_torch.get(refs)) == 8
    # 8 concurrent 0.3s sleeps should take ~0.3s, not 2.4s
    assert time.monotonic() - t0 < 2.0


def test_exit_actor(ray_start):
    @ray_tpu_torch.remote
    class Quitter:
        def quit(self):
            from ray_tpu_torch.actor import exit_actor
            exit_actor()

        def ping(self):
            return "pong"

    a = Quitter.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"  # ensure alive first
    a.quit.remote()
    deadline = time.monotonic() + 20
    while True:
        try:
            ray_tpu_torch.get(a.ping.remote(), timeout=5)
        except ActorDiedError:
            break
        except Exception:
            pass
        assert time.monotonic() < deadline, "actor never died"
        time.sleep(0.2)


def test_actor_handle_passing(ray_start):
    c = Counter.remote()

    @ray_tpu_torch.remote
    def bump(handle):
        return ray_tpu_torch.get(handle.incr.remote())

    assert ray_tpu_torch.get(bump.remote(c)) == 1
    assert ray_tpu_torch.get(c.get.remote()) == 1


def test_actor_dynamic_num_returns(ray_start):
    """Actor methods support num_returns="dynamic" like normal tasks."""
    @ray_tpu_torch.remote
    class Gen:
        def chunks(self, n):
            for i in range(n):
                yield [i] * 2

    a = Gen.remote()
    gen = ray_tpu_torch.get(a.chunks.options(num_returns="dynamic").remote(3))
    assert len(gen) == 3
    assert ray_tpu_torch.get(list(gen)) == [[0, 0], [1, 1], [2, 2]]


def test_concurrency_groups_isolate_slots(ray_start):
    """Named concurrency groups (reference: concurrency_group_manager.h):
    a saturated "io" group must not block "compute" calls, and unknown
    groups fail loudly."""
    import time as _time

    @ray_tpu_torch.remote(max_concurrency=4,
                    concurrency_groups={"io": 1, "compute": 2})
    class Worker:
        @ray_tpu_torch.method(concurrency_group="io")
        async def slow_io(self):
            import asyncio
            await asyncio.sleep(2.0)
            return "io"

        @ray_tpu_torch.method(concurrency_group="compute")
        async def quick(self):
            return "ok"

        async def default_group(self):
            return "default"

    w = Worker.remote()
    ray_tpu_torch.get(w.quick.remote(), timeout=60)   # warm up (worker spawn)
    blockers = [w.slow_io.remote() for _ in range(3)]   # io has 1 slot
    t0 = _time.monotonic()
    # compute + default calls must complete while io is saturated.
    assert ray_tpu_torch.get(w.quick.remote(), timeout=10) == "ok"
    assert ray_tpu_torch.get(w.default_group.remote(), timeout=10) == "default"
    assert _time.monotonic() - t0 < 2.0, "io group starved other groups"
    # Per-call group override routes through the io semaphore.
    assert ray_tpu_torch.get(
        w.quick.options(concurrency_group="compute").remote(),
        timeout=10) == "ok"
    with pytest.raises(Exception, match="unknown concurrency group"):
        ray_tpu_torch.get(w.quick.options(concurrency_group="nope").remote(),
                    timeout=10)
    ray_tpu_torch.get(blockers, timeout=30)


def test_method_num_returns_decorator(ray_start):
    """@ray_tpu_torch.method(num_returns=2) must yield two refs from the plain
    handle call — not one ref holding the tuple (ADVICE r4).  Metadata
    survives handle serialization (pass-to-task)."""
    @ray_tpu_torch.remote
    class Splitter:
        @ray_tpu_torch.method(num_returns=2)
        def pair(self):
            return "a", "b"

        def single(self):
            return "s"

    s = Splitter.remote()
    a, b = s.pair.remote()
    assert ray_tpu_torch.get(a, timeout=60) == "a"
    assert ray_tpu_torch.get(b, timeout=30) == "b"
    assert ray_tpu_torch.get(s.single.remote(), timeout=30) == "s"

    @ray_tpu_torch.remote
    def via_task(handle):
        x, y = handle.pair.remote()
        return ray_tpu_torch.get(x), ray_tpu_torch.get(y)

    assert ray_tpu_torch.get(via_task.remote(s), timeout=60) == ("a", "b")

    # get_actor() handles must carry the metadata too (served by GCS)
    named = Splitter.options(name="splitter-meta").remote()
    ray_tpu_torch.get(named.single.remote(), timeout=60)
    h = ray_tpu_torch.get_actor("splitter-meta")
    x, y = h.pair.remote()
    assert ray_tpu_torch.get(x, timeout=30) == "a"
    assert ray_tpu_torch.get(y, timeout=30) == "b"


def test_kill_with_restart_restarts_once(ray_start):
    """``kill(no_restart=False)`` restarts the actor when the GCS asks for
    the kill; the raylet's later report of the old process's death must
    not restart it a second time, which would leave two live processes
    serving one actor."""
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote(max_restarts=-1)
    class Phoenix:
        def pid(self):
            import os
            return os.getpid()

    a = Phoenix.remote()
    first = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    ray_tpu_torch.kill(a, no_restart=False)
    deadline = time.monotonic() + 60
    while True:
        try:
            second = ray_tpu_torch.get(a.pid.remote(), timeout=10)
            if second != first:
                break
        except Exception:
            pass
        assert time.monotonic() < deadline, "actor never restarted"
        time.sleep(0.2)
    time.sleep(2.0)       # the raylet reaps the old process in ~0.2 s
    aid = a._actor_id
    (rec,) = [r for r in state.list_actors() if r["actor_id"] == aid]
    assert rec["num_restarts"] == 1, rec
    # The node's worker table (reported with its stats) names one live
    # process for the actor.
    deadline = time.monotonic() + 30
    while True:
        pids = {w["pid"] for w in state.list_workers()
                if w.get("actor_id") == aid}
        if second in pids:
            break
        assert time.monotonic() < deadline, (pids, second)
        time.sleep(0.5)
    assert pids == {second}, (pids, second)
    assert ray_tpu_torch.get(a.pid.remote(), timeout=10) == second
    ray_tpu_torch.kill(a)

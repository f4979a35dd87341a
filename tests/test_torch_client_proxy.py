"""Client proxy: per-client isolated sessions, reconnect, cleanup.

Reference analog: python/ray/util/client/server/proxier.py tests —
each ray:// client gets its own server process; reconnects reuse it.

The port's, case for case those of ``test_client_proxy.py``.  This module
imports nothing of JAX: the cluster's workers import it.
"""

import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.client import connect, start_proxy


@pytest.fixture(scope="module")
def proxy_cluster():
    info = ray_tpu_torch.init(num_cpus=4)
    proxy, address = start_proxy(info["gcs_address"],
                                 session_idle_grace_s=8.0)
    yield address, proxy
    ray_tpu_torch.shutdown()


def test_client_roundtrip_tasks_actors(proxy_cluster):
    address, _ = proxy_cluster
    c = connect(address)
    try:
        ref = c.put({"x": 41})
        assert c.get(ref) == {"x": 41}

        @c.remote
        def double(v):
            return v * 2

        assert c.get(double.remote(21)) == 42
        # refs as args resolve server-side (ref chaining)
        r2 = double.remote(3)
        r4 = double.remote(r2)
        assert c.get(r4) == 12

        @c.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def inc(self):
                self.n += 1
                return self.n

        a = Counter.remote(10)
        assert c.get(a.inc.remote()) == 11
        assert c.get(a.inc.remote()) == 12
        c.kill(a)
    finally:
        c.disconnect(end_session=True)


def test_clients_get_isolated_sessions(proxy_cluster):
    address, proxy = proxy_cluster
    c1 = connect(address)
    c2 = connect(address)
    try:
        p1 = c1.ping()["pid"]
        p2 = c2.ping()["pid"]
        assert p1 != p2 != os.getpid()
        # each session is its own OS process registered at the proxy
        assert len(proxy.sessions) >= 2
    finally:
        c1.disconnect(end_session=True)
        c2.disconnect(end_session=True)


def test_reconnect_preserves_refs(proxy_cluster):
    """Kill the client's TCP connection; the next op re-handshakes onto
    the SAME session and previously created refs still resolve."""
    address, _ = proxy_cluster
    c = connect(address)
    try:
        ref = c.put("survives")
        pid_before = c.ping()["pid"]
        # Simulate a network drop: close the session connection only.
        import asyncio
        fut = asyncio.run_coroutine_threadsafe(c._conn.close(), c._loop)
        fut.result(10)
        assert c.get(ref) == "survives"      # transparent reconnect
        assert c.ping()["pid"] == pid_before  # same session process
    finally:
        c.disconnect(end_session=True)


def test_session_reaped_after_grace(proxy_cluster):
    address, proxy = proxy_cluster
    c = connect(address)
    pid = c.ping()["pid"]
    cid = c.client_id
    c.disconnect()                 # no end_session: rely on idle grace
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(1.0)
    else:
        pytest.fail("session process survived the idle grace period")
    # the proxy reaper forgets it too
    deadline = time.time() + 15
    while cid in proxy.sessions and time.time() < deadline:
        time.sleep(1.0)
    assert cid not in proxy.sessions

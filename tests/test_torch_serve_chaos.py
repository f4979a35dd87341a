"""Serve ingress chaos: connection storms, slow clients, stalled streams.

Run via ``scripts/run_chaos.sh serve-chaos`` (3x under CPU burners).

Each test owns its cluster: the faults and limits ride in via
``_worker_env`` so the ingress / replica worker processes pick them up
from their environment (``RT_SERVE_*`` knobs, ``RT_FAULT_INJECTION``).

The port's runtime under ``test_serve_chaos.py``'s cases, one for one.
"""

import contextlib
import json
import socket
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.util import fault_injection

pytestmark = [pytest.mark.slow, pytest.mark.chaos, pytest.mark.serve_chaos]


@contextlib.contextmanager
def _cluster(extra_env):
    env = dict(extra_env)
    ray_tpu_torch.init(num_cpus=8, _worker_env=env)
    try:
        yield
    finally:
        with contextlib.suppress(Exception):
            serve.shutdown()
        ray_tpu_torch.shutdown()


def _connect(url, timeout=30):
    host, port = url.split("//")[1].split(":")
    return socket.create_connection((host, int(port)), timeout=timeout)


def _get(sock, path):
    sock.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())


def _read_response(sock):
    resp = b""
    while True:
        if b"\r\n\r\n" in resp:
            head, rest = resp.split(b"\r\n\r\n", 1)
            n = int([h for h in head.split(b"\r\n")
                     if h.lower().startswith(b"content-length")][0]
                    .split(b":")[1])
            if len(rest) >= n:
                return head, rest[:n]
        c = sock.recv(65536)
        if not c:
            return resp.split(b"\r\n\r\n", 1)[0], b""
        resp += c


def test_connection_storm_sheds_with_retry_after():
    """A storm beyond max_connections is shed at accept time with
    429 + Retry-After while established connections keep serving; once
    the storm drains, new connections are admitted again."""
    with _cluster({"RT_SERVE_MAX_CONNECTIONS": "8"}):
        url = serve.start_http()

        storm = [_connect(url) for _ in range(8)]
        try:
            # Prove all 8 handlers are live (and keep-alive parked):
            # each serves a healthz round-trip.
            for s in storm:
                _get(s, "/-/healthz")
                head, body = _read_response(s)
                assert b"200" in head.split(b"\r\n")[0]

            # The 9th connection is shed with an explicit retry hint.
            extra = _connect(url)
            _get(extra, "/-/healthz")
            head, body = _read_response(extra)
            assert b"429" in head.split(b"\r\n")[0], head
            assert b"retry-after" in head.lower(), head
            extra.close()

            # Established connections still serve under the storm.
            _get(storm[0], "/-/healthz")
            head, body = _read_response(storm[0])
            assert b"200" in head.split(b"\r\n")[0]
            assert body == b"ok"
        finally:
            for s in storm:
                with contextlib.suppress(Exception):
                    s.close()

        # Storm gone: the server notices the EOFs and admits new
        # connections (poll — the handlers wake as their reads fail).
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            s = _connect(url)
            try:
                _get(s, "/-/healthz")
                head, _ = _read_response(s)
                if b"200" in head.split(b"\r\n")[0]:
                    return
            finally:
                s.close()
            time.sleep(0.2)
        raise AssertionError("connections never admitted after storm")


def test_slow_client_bounded_by_write_timeout():
    """A client draining at fault-injected slow-client speed must be cut
    off by the write timeout — the ingress aborts the connection within
    the timeout bound instead of parking a slot for the fault's full
    stretch (or forever on a zero-window peer)."""
    env = fault_injection.env_for(slow_client={"delay_s": 5})
    env["RT_SERVE_WRITE_TIMEOUT_S"] = "0.5"
    with _cluster(env):
        url = serve.start_http()
        s = _connect(url)
        t0 = time.monotonic()
        try:
            _get(s, "/-/healthz")
            # The drain stalls 5s; the 0.5s write timeout fires first and
            # the handler aborts the (normally keep-alive) connection:
            # recv sees EOF quickly.  Without the abort this recv loop
            # would park on the open keep-alive conn until the socket
            # timeout below.
            s.settimeout(10)
            while True:
                c = s.recv(4096)
                if not c:
                    break
            elapsed = time.monotonic() - t0
            assert elapsed < 4.0, (
                f"abort took {elapsed:.1f}s: bounded by the 5s fault, "
                f"not the 0.5s write timeout")
        finally:
            s.close()


def test_stalled_stream_trips_idle_timeout():
    """A replica stream that stalls mid-generation (fault: 3rd item
    stalls 30s) must not park the ingress forever: the stream-idle
    timeout cancels the replica generator and the client gets the
    already-produced tokens plus an explicit error event."""
    env = fault_injection.env_for(stall_stream={"after": 3, "stall_s": 30})
    env["RT_SERVE_STREAM_IDLE_S"] = "0.5"
    with _cluster(env):
        @serve.deployment(name="staller", ray_actor_options={"num_cpus": 0.1})
        class Staller:
            async def __call__(self, payload):
                for i in range(10):
                    yield i

        serve.run(Staller.bind())
        url = serve.start_http()
        s = _connect(url)
        try:
            body = json.dumps({"stream": True}).encode()
            s.sendall(b"POST /staller HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: %d\r\n\r\n" % len(body) + body)
            buf = b""
            s.settimeout(30)
            t0 = time.monotonic()
            while b"event: error" not in buf and b"event: end" not in buf:
                c = s.recv(4096)
                assert c, f"connection closed without terminal event: {buf!r}"
                buf += c
            elapsed = time.monotonic() - t0
            assert b"event: error" in buf, buf
            assert b"stream idle" in buf, buf
            # The pre-stall tokens made it out before the error event.
            events = [l for l in buf.replace(b"\r\n", b"\n").split(b"\n")
                      if l.startswith(b"data: ")]
            data = [json.loads(e[6:]) for e in events]
            assert 0 in data and 1 in data, data
            # Tripped by the 0.5s idle timeout, not the 30s stall.
            assert elapsed < 10, elapsed
        finally:
            s.close()

"""Client proxy: one endpoint, one isolated session process per client.

Port of ``ray_tpu/util/client/proxy.py``.

Reference analog: ``util/client/server/proxier.py`` (``proxy_manager``
spawning SpecificServers, health-checked, reaped on disconnect).

Neither the proxy nor a session holds a card.  The proxy never unpickles a
value (hellos and byes only), and it starts every session with
``CUDA_VISIBLE_DEVICES=""``: a session calls ``get`` and pickles what it
got, so a tensor that left a GPU actor's card reaches the session, and from
there the client, on the CPU.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch._private.async_utils import spawn
import logging
import os
import secrets
import subprocess
import sys
import time
from typing import Dict, Optional

from ray_tpu_torch._private.protocol import RpcServer

logger = logging.getLogger(__name__)


class _Session:
    def __init__(self, proc: subprocess.Popen, address: str, token: str):
        self.proc = proc
        self.address = address
        self.token = token
        self.created_at = time.time()


class ClientProxyServer:
    """Accepts client hellos, spawns/reuses per-client session processes.

    The proxy is control-plane only: after the hello handshake the client
    talks to its session directly, so proxy load is O(connects), not
    O(traffic).  Reconnect: the same ``client_id`` + token returns the
    LIVE session's address — its refs and actors are untouched.
    """

    def __init__(self, head_address: str, *,
                 session_idle_grace_s: float = 60.0):
        self.head_address = head_address
        self.grace_s = session_idle_grace_s
        self.sessions: Dict[str, _Session] = {}
        # Per-client hello serialization: a retried hello racing the
        # original must not spawn a second session (the loser's refs
        # would live in an untracked process).
        self._hello_locks: Dict[str, asyncio.Lock] = {}
        self.server = RpcServer(self._make_handler)
        self._reaper: Optional[asyncio.Task] = None

    async def start(self, port: int = 0) -> int:
        port = await self.server.start(port)
        self._reaper = asyncio.get_running_loop().create_task(
            self._reap_loop())
        return port

    @property
    def address(self) -> str:
        return self.server.address

    def _make_handler(self, conn):
        async def handle(msg: dict):
            mtype = msg["type"]
            if mtype == "client_hello":
                return await self._hello(msg)
            if mtype == "client_bye":
                return self._bye(msg)
            if mtype == "proxy_stats":
                return {"sessions": {cid: {"pid": s.proc.pid,
                                           "address": s.address}
                                     for cid, s in self.sessions.items()}}
            raise ValueError(f"client proxy: unknown message {mtype}")
        return handle

    async def _hello(self, msg: dict) -> dict:
        client_id = msg["client_id"]
        lock = self._hello_locks.setdefault(client_id, asyncio.Lock())
        async with lock:
            return await self._hello_locked(client_id, msg)

    async def _hello_locked(self, client_id: str, msg: dict) -> dict:
        sess = self.sessions.get(client_id)
        if sess is not None and sess.proc.poll() is None:
            if msg.get("token") != sess.token:
                return {"ok": False, "error": "bad reconnect token"}
            return {"ok": True, "session_address": sess.address,
                    "token": sess.token, "reconnected": True}
        token = secrets.token_hex(16)
        # fork+exec blocks for milliseconds — run it on the executor so a
        # session spawn never stalls other clients' RPCs on this loop.
        proc = await asyncio.get_running_loop().run_in_executor(
            None, lambda: subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.util.client.session"],
            env={**os.environ,
                 # A session is a driver that unpickles what it gets: a
                 # session that saw the card would put a GPU actor's
                 # tensors on it, outside every lease.
                 "CUDA_VISIBLE_DEVICES": "",
                 "RT_CLIENT_SESSION_GCS": self.head_address,
                 "RT_CLIENT_SESSION_GRACE_S": str(self.grace_s),
                 "RT_CLIENT_SESSION_ID": client_id},
            stdout=subprocess.PIPE, text=True))
        loop = asyncio.get_running_loop()
        try:
            line = await asyncio.wait_for(
                loop.run_in_executor(None, proc.stdout.readline), timeout=60)
        except asyncio.TimeoutError:
            # Kill the stalled child or it lives forever (its idle-grace
            # loop never starts before SESSION_READY) and the executor
            # thread stays stuck in readline until EOF.
            proc.kill()
            return {"ok": False, "error": "session spawn timed out"}
        if not line.startswith("SESSION_READY "):
            proc.kill()
            return {"ok": False,
                    "error": f"session failed to start: {line!r}"}
        address = line.split(" ", 1)[1].strip()
        self.sessions[client_id] = _Session(proc, address, token)
        logger.info("client %s -> session pid=%s at %s",
                    client_id[:8], proc.pid, address)
        return {"ok": True, "session_address": address, "token": token,
                "reconnected": False}

    def _bye(self, msg: dict) -> dict:
        # Validate BEFORE removing: a bad/missing token must not orphan
        # a live session's mapping (its refs would be unreachable).
        sess = self.sessions.get(msg["client_id"])
        if sess is not None and msg.get("token") == sess.token:
            del self.sessions[msg["client_id"]]
            sess.proc.terminate()
            return {"ok": True}
        return {"ok": False}

    async def _reap_loop(self):
        while True:
            await asyncio.sleep(5.0)
            for cid, sess in list(self.sessions.items()):
                if sess.proc.poll() is not None:   # idled out or crashed
                    del self.sessions[cid]

    async def close(self):
        if self._reaper is not None:
            self._reaper.cancel()
        for sess in self.sessions.values():
            sess.proc.terminate()
        self.sessions.clear()
        await self.server.close()


def start_proxy(head_address: str, port: int = 0, **kwargs):
    """Run a proxy on a fresh event loop thread; returns (proxy, address).
    Convenience for embedding in the head process or tests."""
    import threading

    proxy = ClientProxyServer(head_address, **kwargs)
    started = threading.Event()
    holder = {}

    def main():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def boot():
            await proxy.start(port)
            holder["address"] = proxy.address
            started.set()
        spawn(boot(), name="client-proxy-boot", loop=loop)
        loop.run_forever()

    t = threading.Thread(target=main, daemon=True, name="client-proxy")
    t.start()
    started.wait(30)
    return proxy, holder["address"]

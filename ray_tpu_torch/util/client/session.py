"""Per-client session process: a real in-cluster driver serving the
client op protocol.

Port of ``ray_tpu/util/client/session.py``.

Reference analog: the "SpecificServer" the proxier spawns per client
(``util/client/server/server.py``): object ownership, task submission
and actor handles all live HERE, so a client TCP drop loses nothing —
reconnecting within the grace window finds every ref still owned by
this process.  No client connection for ``grace_s`` seconds -> clean
shutdown (refs die with their owner, like the reference's session
termination).
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
import time
from typing import Any, Dict

from ray_tpu_torch._private import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private.protocol import RpcServer


class SessionServer:
    def __init__(self, grace_s: float):
        self.grace_s = grace_s
        self.refs: Dict[str, Any] = {}       # ref id -> ObjectRef
        self.actors: Dict[str, Any] = {}     # actor id -> handle
        self.fns: Dict[str, Any] = {}        # fn id -> remote function
        self._clients = 0
        self._last_disconnect = time.monotonic()
        # req_id -> result: replies lost to a connection drop must not
        # re-execute their op on retry (duplicate tasks/puts/actors).
        from collections import OrderedDict
        self._dedup: "OrderedDict[str, Any]" = OrderedDict()
        self.server = RpcServer(self._make_handler)

    # ------------------------------------------------------------ protocol

    def _make_handler(self, conn):
        self._clients += 1
        conn.on_close = self._on_close

        async def handle(msg: dict):
            return await self._handle(msg)
        return handle

    def _on_close(self, conn):
        self._clients -= 1
        self._last_disconnect = time.monotonic()

    def _track(self, ref) -> str:
        rid = ref.id.hex()
        self.refs[rid] = ref
        return rid

    async def _handle(self, msg: dict):
        req_id = msg.get("req_id")
        if req_id is not None and req_id in self._dedup:
            return self._dedup[req_id]
        result = await self._execute(msg)
        if req_id is not None:
            self._dedup[req_id] = result
            while len(self._dedup) > 2048:
                self._dedup.popitem(last=False)
        return result

    async def _execute(self, msg: dict):
        op = msg["op"]
        if op == "put":
            return self._track(
                ray_tpu_torch.put(cloudpickle.loads(msg["data"])))
        if op == "get":
            refs = [self.refs[r] for r in msg["ref_ids"]]
            loop = asyncio.get_running_loop()
            vals = await loop.run_in_executor(
                None, lambda: ray_tpu_torch.get(refs,
                                          timeout=msg.get("timeout")))
            return cloudpickle.dumps(vals)
        if op == "reg_fn":
            fid = msg["fn_id"]
            fn = cloudpickle.loads(msg["fn"])
            self.fns[fid] = ray_tpu_torch.remote(**msg["options"])(fn) \
                if msg.get("options") else ray_tpu_torch.remote(fn)
            return {"ok": True}
        if op == "task":
            args, kwargs = self._decode_args(msg)
            ref = self.fns[msg["fn_id"]].remote(*args, **kwargs)
            return self._track(ref)
        if op == "create_actor":
            cls = cloudpickle.loads(msg["cls"])
            args, kwargs = self._decode_args(msg)
            opts = msg.get("options") or {}
            handle = (ray_tpu_torch.remote(**opts)(cls) if opts
                      else ray_tpu_torch.remote(cls)).remote(*args, **kwargs)
            aid = handle._actor_id
            self.actors[aid] = handle
            return aid
        if op == "actor_call":
            handle = self.actors[msg["actor_id"]]
            args, kwargs = self._decode_args(msg)
            ref = getattr(handle, msg["method"]).remote(*args, **kwargs)
            return self._track(ref)
        if op == "kill_actor":
            handle = self.actors.pop(msg["actor_id"], None)
            if handle is not None:
                ray_tpu_torch.kill(handle)
            return {"ok": True}
        if op == "free":
            for r in msg["ref_ids"]:
                self.refs.pop(r, None)
            return {"ok": True}
        if op == "ping":
            return {"ok": True, "pid": os.getpid()}
        raise ValueError(f"client session: unknown op {op}")

    def _decode_args(self, msg):
        def resolve(x):
            if isinstance(x, dict) and x.get("__client_ref__"):
                return self.refs[x["id"]]
            return x
        args = [resolve(a) for a in cloudpickle.loads(msg["args"])]
        kwargs = {k: resolve(v)
                  for k, v in cloudpickle.loads(msg["kwargs"]).items()}
        return args, kwargs

    # ------------------------------------------------------------ lifetime

    async def run(self):
        port = await self.server.start(0)
        print(f"SESSION_READY {self.server.address}", flush=True)
        sys.stdout.close()
        while True:
            await asyncio.sleep(2.0)
            idle = (self._clients <= 0
                    and time.monotonic() - self._last_disconnect
                    > self.grace_s)
            ppid_gone = os.getppid() == 1   # proxy died
            if idle or ppid_gone:
                break
        await self.server.close()


def main():
    gcs = os.environ["RT_CLIENT_SESSION_GCS"]
    grace = float(os.environ.get("RT_CLIENT_SESSION_GRACE_S", "60"))
    # The session runs next to the head: join as a full driver (shared
    # memory attach) — it owns every ref the client creates.
    ray_tpu_torch.init(address=gcs)

    sess = SessionServer(grace)

    def runner():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(sess.run())

    t = threading.Thread(target=runner, daemon=False)
    t.start()
    t.join()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()

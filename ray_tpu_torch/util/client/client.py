"""Client-side API for proxy-mediated remote drivers.

Port of ``ray_tpu/util/client/client.py``.

Reference analog: ``util/client/__init__.py`` (ClientContext) +
``worker.py``: the client holds lightweight refs; every operation is an
RPC to the per-client session server, which owns the real ObjectRefs.
Reconnect (``util/client/worker.py`` reconnect support): on connection
loss, the next operation re-handshakes with the proxy using the saved
client_id + token and lands on the SAME session — refs stay valid.
"""

from __future__ import annotations

import asyncio
import threading
import uuid
from typing import Any, List, Optional

from ray_tpu_torch._private import cloudpickle

from ray_tpu_torch._private.protocol import connect as rpc_connect


class ClientObjectRef:
    """Opaque handle to an object owned by the session process."""

    __slots__ = ("id", "_ctx")

    def __init__(self, rid: str, ctx: "ClientContext"):
        self.id = rid
        self._ctx = ctx

    def _wire(self) -> dict:
        return {"__client_ref__": True, "id": self.id}

    def __repr__(self):
        return f"ClientObjectRef({self.id[:16]})"


class ClientActorHandle:
    __slots__ = ("actor_id", "_ctx")

    def __init__(self, actor_id: str, ctx: "ClientContext"):
        self.actor_id = actor_id
        self._ctx = ctx

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        ctx = object.__getattribute__(self, "_ctx")
        aid = object.__getattribute__(self, "actor_id")

        class _Method:
            def remote(_self, *args, **kwargs):
                rid = ctx._call({"op": "actor_call", "actor_id": aid,
                                 "method": name,
                                 **ctx._encode_args(args, kwargs)})
                return ClientObjectRef(rid, ctx)
        return _Method()


class _RemoteFn:
    def __init__(self, ctx: "ClientContext", fn, options: Optional[dict]):
        self._ctx = ctx
        self._fn_id = uuid.uuid4().hex
        self._registered = False
        self._fn = fn
        self._options = options

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        if not self._registered:
            self._ctx._call({"op": "reg_fn", "fn_id": self._fn_id,
                             "fn": cloudpickle.dumps(self._fn),
                             "options": self._options})
            self._registered = True
        rid = self._ctx._call({"op": "task", "fn_id": self._fn_id,
                               **self._ctx._encode_args(args, kwargs)})
        return ClientObjectRef(rid, self._ctx)


class ClientContext:
    """A remote driver session reached through the proxy."""

    def __init__(self, proxy_address: str, *, client_id: Optional[str] = None,
                 timeout: float = 60.0):
        self.proxy_address = proxy_address
        self.client_id = client_id or uuid.uuid4().hex
        self._token: Optional[str] = None
        self._timeout = timeout
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop_main,
                                        name="rt-client", daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()
        self._conn = None
        self.session_address: Optional[str] = None
        self._handshake()

    # ------------------------------------------------------------ plumbing

    def _loop_main(self):
        asyncio.set_event_loop(self._loop)
        self._started.set()
        self._loop.run_forever()

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(self._timeout)

    def _handshake(self):
        async def hs():
            proxy = await rpc_connect(self.proxy_address, _null_handler,
                                      name="client->proxy")
            try:
                reply = await proxy.request(
                    {"type": "client_hello", "client_id": self.client_id,
                     "token": self._token}, timeout=90)
            finally:
                await proxy.close()
            if not reply.get("ok"):
                raise ConnectionError(
                    f"proxy refused session: {reply.get('error')}")
            self._token = reply["token"]
            self.session_address = reply["session_address"]
            self._conn = await rpc_connect(self.session_address,
                                           _null_handler,
                                           name="client->session")
        self._run(hs())

    def _call(self, msg: dict):
        from ray_tpu_torch._private.protocol import ConnectionLost
        # Stable per-op id: if the reply is lost to a connection drop, the
        # retry is deduplicated server-side instead of re-executing the op
        # (a double-submitted task would run its side effects twice).
        msg = {**msg, "req_id": uuid.uuid4().hex}

        async def do():
            return await self._conn.request(msg, timeout=self._timeout)
        try:
            return self._run(do())
        except ConnectionLost:
            # Transparent reconnect: same client_id + token lands on the
            # same session; the op is retried once.
            self._handshake()
            return self._run(do())

    def _encode_args(self, args, kwargs) -> dict:
        def enc(x):
            return x._wire() if isinstance(x, ClientObjectRef) else x
        return {"args": cloudpickle.dumps([enc(a) for a in args]),
                "kwargs": cloudpickle.dumps(
                    {k: enc(v) for k, v in kwargs.items()})}

    # ------------------------------------------------------------- api

    def put(self, value: Any) -> ClientObjectRef:
        return ClientObjectRef(
            self._call({"op": "put", "data": cloudpickle.dumps(value)}),
            self)

    def get(self, refs, timeout: Optional[float] = None):
        one = isinstance(refs, ClientObjectRef)
        if one:
            refs = [refs]
        data = self._call({"op": "get", "ref_ids": [r.id for r in refs],
                           "timeout": timeout})
        vals = cloudpickle.loads(data)
        return vals[0] if one else vals

    def remote(self, fn_or_cls=None, **options):
        """Decorator parity with ray_tpu_torch.remote, executing remotely."""
        def wrap(target):
            if isinstance(target, type):
                return _RemoteCls(self, target, options or None)
            return _RemoteFn(self, target, options or None)
        if fn_or_cls is None:
            return wrap
        return wrap(fn_or_cls)

    def kill(self, actor: ClientActorHandle) -> None:
        self._call({"op": "kill_actor", "actor_id": actor.actor_id})

    def free(self, refs: List[ClientObjectRef]) -> None:
        self._call({"op": "free", "ref_ids": [r.id for r in refs]})

    def ping(self) -> dict:
        return self._call({"op": "ping"})

    def disconnect(self, *, end_session: bool = False):
        async def bye():
            if self._conn is not None:
                await self._conn.close()
            if end_session:
                proxy = await rpc_connect(self.proxy_address, _null_handler,
                                          name="client->proxy")
                try:
                    await proxy.request(
                        {"type": "client_bye", "client_id": self.client_id,
                         "token": self._token}, timeout=30)
                finally:
                    await proxy.close()
        try:
            self._run(bye())
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
            if not self._loop.is_running():
                self._loop.close()


class _RemoteCls:
    def __init__(self, ctx: ClientContext, cls, options: Optional[dict]):
        self._ctx = ctx
        self._cls = cls
        self._options = options

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        aid = self._ctx._call({
            "op": "create_actor", "cls": cloudpickle.dumps(self._cls),
            "options": self._options,
            **self._ctx._encode_args(args, kwargs)})
        return ClientActorHandle(aid, self._ctx)


async def _null_handler(msg):
    return None


def connect(proxy_address: str, **kwargs) -> ClientContext:
    """Connect to a cluster through its client proxy."""
    return ClientContext(proxy_address, **kwargs)

"""Asyncio message transport used by every cross-process hop in the runtime.

Design analog: reference ``src/ray/rpc/`` (GrpcServer/GrpcClient, client_call.h /
server_call.h).  The reference wraps async gRPC; we use persistent length-prefixed
pickle frames over TCP/unix sockets, which keeps the dependency surface tiny and
is plenty for a control plane (bulk array data never rides these sockets -- it
goes through the shared-memory object store, or chunked transfer frames).

Every connection is symmetric: either side can issue requests (correlated by a
request id) and receive one-way notifications.  This mirrors how the reference's
workers both serve (PushTask) and call (RequestWorkerLease) RPCs.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import random
import struct
import time
from typing import Any, Awaitable, Callable, Dict, Optional

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.async_utils import spawn

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<I")
MAX_FRAME = 1 << 31

_REQUEST = 0
_REPLY = 1
_NOTIFY = 2
_BATCH = 3   # payload: [(kind, rid, msg), ...] — transport-level coalescing

# v2 outbox flush bounds: cut a mixed batch frame once this many body
# bytes have accumulated, and flush the outbox early (without waiting for
# the call_soon tick) once this many messages are queued.
_V2_BATCH_CUT_BYTES = 256 * 1024
_OUTBOX_FLUSH_ITEMS = 512


class ConnectionLost(Exception):
    pass


# Fault-injection shim (chaos testing; see util/fault_injection.py):
# when installed, the filter sees every outgoing frame BEFORE it reaches
# the transport and returning True silently drops it — modeling a lossy
# or half-partitioned link deterministically.  Module-level so one
# install covers every connection in the process; activated either
# directly by tests (set_frame_fault) or via the RT_FAULT_INJECTION env
# "drop_rpc" spec on daemon startup.
_frame_fault: Optional[Callable[["RpcConnection", bytes], bool]] = None
_env_fault_checked = False


def set_frame_fault(
        fn: Optional[Callable[["RpcConnection", bytes], bool]]) -> None:
    """Install (or clear, with None) the outgoing-frame drop filter."""
    global _frame_fault
    _frame_fault = fn


def _maybe_install_env_fault() -> None:
    global _env_fault_checked, _frame_fault
    if _env_fault_checked:
        return
    _env_fault_checked = True
    import os
    if "RT_FAULT_INJECTION" not in os.environ:
        return
    from ray_tpu_torch.util import fault_injection
    drop = fault_injection.spec().drop_rpc
    if drop:
        _frame_fault = fault_injection.make_drop_filter(
            drop.get("conn", ""), int(drop.get("every", 0)))


def _partition_window(name: str):
    """(start, end) monotonic partition window for this conn name, or
    None.  Consulted via util.fault_injection so in-process set_spec()
    and the RT_FAULT_INJECTION env both take effect."""
    try:
        from ray_tpu_torch.util import fault_injection
    except Exception:
        return None
    if fault_injection.spec().partition is None:
        return None
    return fault_injection.partition_window(name)


def _partition_active(name: str) -> bool:
    win = _partition_window(name)
    if win is None:
        return False
    start, end = win
    now = time.monotonic()
    return now >= start and (end is None or now < end)


class RpcConnection:
    """A duplex request/reply + notify channel over one stream.

    handler(msg: dict) -> Awaitable[Any] serves incoming requests; the returned
    value is pickled back as the reply.  Raising inside the handler sends the
    exception to the peer, where it re-raises at the call site.
    """

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        handler: Optional[Callable[[dict], Awaitable[Any]]] = None,
        name: str = "",
    ):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        # Optional synchronous request dispatcher tried BEFORE spawning a
        # per-request asyncio task: fast_handler(rid, msg) -> bool.  True
        # means the request was fully taken over (the callee replies later
        # via reply_soon); False routes it down the normal handler task.
        # The actor hot path uses this to skip the Task machinery.
        self.fast_handler: Optional[Callable[[int, Any], bool]] = None
        self.name = name
        self._req_counter = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._send_lock = asyncio.Lock()
        self._undrained = 0
        self._closed = False
        self.on_close: Optional[Callable[["RpcConnection"], None]] = None
        self._serve_task: Optional[asyncio.Task] = None
        self._partition_task: Optional[asyncio.Task] = None
        # Outbox: small control messages queued within one loop tick leave
        # as a single _BATCH frame (one pickle, one write, one syscall)
        # instead of a frame each.  Bulk payloads (chunk transfer) bypass
        # it via _send_frame so megabytes never sit in a Python list.
        self._outbox: list = []
        # Wire negotiation state: we always ACCEPT both framings; what we
        # SEND upgrades to v2 only after the peer's hello proves it can
        # read it (and shares our marshal format — see wire.py).  Until
        # then everything rides legacy pickle frames, so mixed-version
        # links (including mid-redial ReconnectingConnection heals)
        # degrade instead of desyncing.
        self._wire_v2 = wire.enabled()
        self.peer_wire_version = 1
        self._peer_fast = False
        _maybe_install_env_fault()

    def start(self):
        # The hello is the first queued message; the first flush always
        # runs before negotiation completes, so it rides a legacy frame
        # any peer can read.  Old peers log one unknown-notify error and
        # keep the connection.
        if self._wire_v2:
            self._send_soon(_NOTIFY, 0, wire.hello_message())
        self._serve_task = asyncio.get_running_loop().create_task(self._serve())
        self._maybe_schedule_partition()
        return self._serve_task

    def _maybe_schedule_partition(self) -> None:
        """Chaos hook: when a ``partition`` fault matches this connection's
        name, abort the transport when the window opens (immediately if it
        is already open).  A connection established after the window has
        healed is left alone."""
        win = _partition_window(self.name)
        if win is None:
            return
        start, end = win
        now = time.monotonic()
        if end is not None and now >= end:
            return  # window already healed
        delay = max(0.0, start - now)

        async def _abort():
            if delay:
                await asyncio.sleep(delay)
            if self._closed:
                return
            logger.warning(
                "fault injection: partitioning connection %s", self.name)
            try:
                self.writer.transport.abort()
            except Exception:
                try:
                    self.writer.close()
                except Exception:
                    pass

        self._partition_task = asyncio.get_running_loop().create_task(_abort())

    @property
    def closed(self) -> bool:
        return self._closed

    async def _send_frame(self, payload: bytes):
        # No await between the two writes, so no interleaving is possible
        # and no send lock is needed — and draining every frame costs an
        # extra suspension per message on the hot actor-call path.  Small
        # frames fold the header in (one syscall-side buffer append); bulk
        # frames write separately to avoid copying megabytes per frame.
        # Backpressure still applies: drain once >=1MB is outstanding since
        # the last drain (bulk chunk transfers hit this every frame).
        if _frame_fault is not None and _frame_fault(self, payload):
            return
        if len(payload) < 65536:
            self.writer.write(_HEADER.pack(len(payload)) + payload)
        else:
            self.writer.write(_HEADER.pack(len(payload)))
            self.writer.write(payload)
        self._undrained += _HEADER.size + len(payload)
        if self._undrained >= 1 << 20:
            self._undrained = 0
            async with self._send_lock:   # serialize concurrent drains
                await self.writer.drain()

    def _write_frame_nowait(self, payload: bytes) -> None:
        """Synchronous frame write for loop-thread callers that must not
        suspend (batch send / inline replies).  Same coalescing as
        _send_frame; over the backpressure threshold it schedules a drain
        task instead of awaiting one."""
        if _frame_fault is not None and _frame_fault(self, payload):
            return
        if len(payload) < 65536:
            self.writer.write(_HEADER.pack(len(payload)) + payload)
        else:
            self.writer.write(_HEADER.pack(len(payload)))
            self.writer.write(payload)
        self._undrained += _HEADER.size + len(payload)
        if self._undrained >= 1 << 20:
            self._undrained = 0
            spawn(self._drain(), name="rpc-drain", log=logger)

    async def _drain(self):
        async with self._send_lock:
            try:
                await self.writer.drain()
            except Exception:
                pass   # transport errors surface on the serve loop

    # Suspend producers once this many bytes sit in the asyncio transport
    # buffer (the kernel socket buffer is beyond asyncio's sight).  The
    # outbox path never blocks by itself, so async producers must check in
    # via maybe_drain() or a stalled peer lets buffers grow without bound.
    _BACKPRESSURE_BYTES = 4 << 20

    async def maybe_drain(self) -> None:
        """Await the transport drain when the write buffer is over the
        backpressure threshold; cheap no-op otherwise."""
        try:
            size = self.writer.transport.get_write_buffer_size()
        except Exception:
            return
        if size > self._BACKPRESSURE_BYTES:
            await self._drain()

    def _send_soon(self, kind: int, rid: int, msg) -> None:
        """Queue one control message; the whole outbox flushes as a single
        frame via call_soon (still this loop tick, after currently-ready
        callbacks) — so replies are never held behind other calls'
        completion, only coalesced with already-completed ones."""
        self._outbox.append((kind, rid, msg))
        n = len(self._outbox)
        if n == 1:
            asyncio.get_running_loop().call_soon(self._flush_outbox)
        elif n >= _OUTBOX_FLUSH_ITEMS:
            # Size bound: a burst bigger than the batch budget flushes
            # now; the already-scheduled call_soon then sees an empty
            # outbox and no-ops.
            self._flush_outbox()

    def _flush_outbox(self) -> None:
        ob = self._outbox
        if not ob or self._closed:
            self._outbox = []
            return
        self._outbox = []
        if self._wire_v2 and self.peer_wire_version >= 2 and self._peer_fast:
            self._flush_outbox_v2(ob)
            return
        try:
            if len(ob) == 1:
                payload = pickle.dumps(ob[0], protocol=5)
            else:
                payload = pickle.dumps((_BATCH, 0, ob), protocol=5)
            self._write_frame_nowait(payload)
        except Exception:
            # One unpicklable message must not poison the batch: retry
            # per-message.  A dropped REQUEST must fail its caller's
            # pending future (it would otherwise await forever on a live
            # connection); a dropped reply is logged, as before.
            for item in ob:
                try:
                    self._write_frame_nowait(pickle.dumps(item, protocol=5))
                except Exception as e:
                    self._fail_send(item, e)

    def _flush_outbox_v2(self, ob: list) -> None:
        """Binary-framed flush: one marshal call for a uniform batch, the
        mixed per-item form (PreEncoded splices, big buffers, pickle
        fallbacks) otherwise, cut into frames at _V2_BATCH_CUT_BYTES."""
        if len(ob) == 1:
            kind, rid, msg = ob[0]
            try:
                payload = wire.encode_frame(kind, rid, msg)
            except Exception as e:
                self._fail_send(ob[0], e)
                return
            self._write_frame_nowait(payload)
            return
        if not any(wire.has_big_buffer(m) or m.__class__ is wire.PreEncoded
                   for _k, _r, m in ob):
            payload = wire.encode_batch_frame_fast(ob)
            if payload is not None:
                self._write_frame_nowait(payload)
                return
        parts: list = []
        total = 0
        for item in ob:
            kind, rid, msg = item
            try:
                part = wire.encode_batch_item(kind, rid, msg)
            except Exception as e:
                self._fail_send(item, e)
                continue
            parts.append(part)
            total += len(part)
            if total >= _V2_BATCH_CUT_BYTES:
                self._write_frame_nowait(wire.encode_batch_frame(parts))
                parts, total = [], 0
        if parts:
            self._write_frame_nowait(wire.encode_batch_frame(parts))

    def _fail_send(self, item, e: Exception) -> None:
        # A message that cannot be encoded at all is dropped; a dropped
        # REQUEST must fail its caller's pending future (it would
        # otherwise await forever on a live connection).
        kind, rid, _msg = item
        if kind == _REQUEST:
            fut = self._pending.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_exception(e)
        else:
            logger.error(
                "dropping unencodable message on %s: %r", self.name, e)

    def reply_soon(self, rid: int, result, ok: bool = True) -> None:
        """Queue the reply for a request taken over by fast_handler; rides
        the outbox exactly like _handle's replies (same coalescing, same
        FIFO order with them)."""
        self._send_soon(_REPLY, rid, (ok, result))

    def request_batch(self, msgs) -> "list[asyncio.Future]":
        """Register N requests and queue them on the outbox; returns their
        reply futures (resolved individually as _REPLY/_BATCH frames come
        back).  Caller must be on the IO loop."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        loop = asyncio.get_running_loop()
        futs = []
        for m in msgs:
            rid = next(self._req_counter)
            fut = loop.create_future()
            self._pending[rid] = fut
            futs.append(fut)
            self._send_soon(_REQUEST, rid, m)
        return futs

    async def _read_frame(self) -> bytes:
        head = await self.reader.readexactly(_HEADER.size)
        (length,) = _HEADER.unpack(head)
        if length > MAX_FRAME:
            raise ConnectionLost(f"frame too large: {length}")
        return await self.reader.readexactly(length)

    async def request(self, msg: dict, timeout: Optional[float] = None) -> Any:
        """Send a request and await the peer's reply."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        rid = next(self._req_counter)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            self._send_soon(_REQUEST, rid, msg)
            await self.maybe_drain()
            if timeout is not None:
                return await asyncio.wait_for(fut, timeout)
            return await fut
        finally:
            self._pending.pop(rid, None)

    async def notify(self, msg: dict):
        """Fire-and-forget one-way message.  Rides the outbox so
        same-tick notifies (stream acks, blocked/unblocked transitions)
        coalesce with queued requests and replies into one frame, in
        FIFO order with them."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        self._send_soon(_NOTIFY, 0, msg)
        await self.maybe_drain()

    def _apply_hello(self, msg: dict) -> None:
        try:
            v = int(msg.get("v") or 1)
        except (TypeError, ValueError):
            v = 1
        self.peer_wire_version = min(wire.WIRE_VERSION, v)
        self._peer_fast = wire.peer_fast_ok(msg)

    async def _serve(self):
        try:
            while True:
                frame = await self._read_frame()
                # First payload byte routes the framing: v2 frames start
                # with the wire MAGIC, legacy pickle streams with the
                # 0x80 PROTO opcode.  Both are always accepted.
                if frame and frame[0] == wire.MAGIC:
                    kind, rid, msg = wire.decode_frame(frame)
                else:
                    kind, rid, msg = pickle.loads(frame)
                if kind == _REQUEST:
                    fh = self.fast_handler
                    if fh is None or not fh(rid, msg):
                        # per-request dispatch: _handle replies errors
                        # itself; skip the done-callback tax on this path
                        asyncio.get_running_loop().create_task(
                            self._handle(rid, msg))  # rtlint: disable=orphan-task
                elif kind == _REPLY:
                    fut = self._pending.pop(rid, None)
                    if fut is not None and not fut.done():
                        ok, value = msg
                        if ok:
                            fut.set_result(value)
                        else:
                            fut.set_exception(value)
                elif kind == _NOTIFY:
                    if msg.__class__ is dict and \
                            msg.get("type") == wire.HELLO_TYPE:
                        self._apply_hello(msg)
                        continue
                    asyncio.get_running_loop().create_task(
                        self._handle(None, msg))  # rtlint: disable=orphan-task
                elif kind == _BATCH:
                    self._dispatch_batch(msg)
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            ConnectionLost,
            OSError,
        ):
            pass
        except Exception:
            logger.exception("rpc serve loop error on %s", self.name)
        finally:
            await self._shutdown()

    def _dispatch_batch(self, items) -> None:
        # One frame, N messages: replies resolve inline; requests/notifies
        # each get their own task (per-call tasks keep the executor-thread
        # pipeline full — serving a batch in one task was measured ~2x
        # slower on the actor-call hot path).
        loop = asyncio.get_running_loop()
        for kind, rid, msg in items:
            if kind == _REPLY:
                fut = self._pending.pop(rid, None)
                if fut is not None and not fut.done():
                    ok, value = msg
                    if ok:
                        fut.set_result(value)
                    else:
                        fut.set_exception(value)
            elif kind == _REQUEST:
                fh = self.fast_handler
                if fh is None or not fh(rid, msg):
                    # same hot-dispatch exemption as _serve above
                    loop.create_task(self._handle(rid, msg))  # rtlint: disable=orphan-task
            elif kind == _NOTIFY:
                if msg.__class__ is dict and \
                        msg.get("type") == wire.HELLO_TYPE:
                    self._apply_hello(msg)
                    continue
                loop.create_task(self._handle(None, msg))  # rtlint: disable=orphan-task

    async def _handle(self, rid: Optional[int], msg: dict):
        try:
            result = await self.handler(msg)
            ok = True
        except Exception as e:  # noqa: BLE001 - forwarded to caller
            if rid is None:
                logger.exception("error handling notify %s", msg.get("type"))
                return
            result, ok = e, False
        if rid is None:
            return
        self._send_soon(_REPLY, rid, (ok, result))
        # Reply producers are handler tasks: suspend them here when the
        # peer stops reading so buffered replies stay bounded.
        await self.maybe_drain()

    async def _shutdown(self):
        if self._closed:
            return
        self._closed = True
        if self._partition_task is not None and not self._partition_task.done():
            self._partition_task.cancel()
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(ConnectionLost(f"peer {self.name} disconnected"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:
                logger.exception("on_close callback failed")

    async def close(self):
        if self._serve_task is not None:
            self._serve_task.cancel()
            try:
                # Await the cancellation so no pending _serve task is left
                # for the loop teardown to complain about.
                await self._serve_task
            except asyncio.CancelledError:
                # Distinguish "serve task cancelled" (expected) from
                # "close() itself is being cancelled" (must propagate).
                # Task.cancelling() exists only on 3.11+; on older
                # runtimes swallow the cancellation (pre-refinement
                # behavior) rather than crash every close().
                cur = asyncio.current_task()
                if cur is not None and \
                        getattr(cur, "cancelling", lambda: 0)() > 0:
                    raise
            except Exception:
                pass
        await self._shutdown()


class ReconnectingConnection:
    """A client connection that survives link loss by redialing.

    Wraps one live RpcConnection at a time.  When the inner connection
    drops, ``on_disconnect(self)`` fires synchronously and a background
    redial loop starts: exponential backoff with jitter
    (``backoff_base_s`` doubling to ``backoff_max_s``), every dial
    bounded by ``dial_timeout_s``.  Requests and notifies issued while
    the link is down fail fast with ConnectionLost — callers keep their
    own retry semantics, exactly as with a plain connection.  After each
    successful redial ``on_reconnect(self)`` runs (awaited when it
    returns a coroutine) so the owner can replay session state the peer
    keeps per-connection: re-register, re-subscribe, re-advertise object
    locations.  ``reconnects`` counts successful redials.

    Design analog: reference GcsRpcClient channel reconnection +
    GcsClient re-subscribe-on-reconnect (src/ray/gcs/gcs_client).
    """

    def __init__(
        self,
        addr: str,
        handler: Optional[Callable[[dict], Awaitable[Any]]] = None,
        name: str = "",
        dial_timeout_s: float = 5.0,
        backoff_base_s: float = 0.2,
        backoff_max_s: float = 5.0,
        on_reconnect: Optional[Callable[["ReconnectingConnection"], Any]] = None,
        on_disconnect: Optional[Callable[["ReconnectingConnection"], None]] = None,
    ):
        self.addr = addr
        self.handler = handler
        self.name = name
        self._dial_timeout_s = dial_timeout_s
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self.on_reconnect = on_reconnect
        self.on_disconnect = on_disconnect
        self.on_close: Optional[Callable[["ReconnectingConnection"], None]] = None
        self._conn: Optional[RpcConnection] = None
        self._closed = False
        self._redial_task: Optional[asyncio.Task] = None
        self.reconnects = 0

    # -- dialing --

    async def _dial_once(self) -> RpcConnection:
        if _partition_active(self.name):
            raise ConnectionLost(f"{self.name}: partition fault active")
        if self.addr.startswith("unix://"):
            dial = asyncio.open_unix_connection(self.addr[len("unix://"):])
        else:
            host, port = self.addr.rsplit(":", 1)
            dial = asyncio.open_connection(host, int(port))
        reader, writer = await asyncio.wait_for(dial, self._dial_timeout_s)
        conn = RpcConnection(reader, writer, self.handler, name=self.name)
        conn.on_close = self._on_inner_close
        conn.start()
        return conn

    async def dial(self) -> None:
        """Initial dial — strict (raises on failure) so a bad address or
        down peer stays loud at startup; redials are the forgiving path."""
        self._conn = await self._dial_once()

    def _on_inner_close(self, conn: RpcConnection) -> None:
        if self._conn is not conn:
            return
        self._conn = None
        if self._closed:
            return
        if self.on_disconnect is not None:
            try:
                self.on_disconnect(self)
            except Exception:
                logger.exception("on_disconnect callback failed (%s)", self.name)
        if self._redial_task is None or self._redial_task.done():
            self._redial_task = asyncio.get_running_loop().create_task(
                self._redial_loop())

    async def _redial_loop(self) -> None:
        backoff = self._backoff_base_s
        while not self._closed:
            # Jittered so a cluster's worth of raylets doesn't hammer a
            # freshly-restarted GCS in lockstep.
            await asyncio.sleep(backoff * (0.5 + random.random()))
            backoff = min(backoff * 2, self._backoff_max_s)
            if self._closed:
                return
            try:
                conn = await self._dial_once()
            except (OSError, ConnectionLost, asyncio.TimeoutError) as e:
                logger.debug("redial %s failed: %r", self.name, e)
                continue
            self.reconnects += 1
            self._conn = conn
            if self.on_reconnect is not None:
                try:
                    res = self.on_reconnect(self)
                    if asyncio.iscoroutine(res):
                        await res
                except Exception:
                    logger.exception(
                        "on_reconnect callback failed (%s)", self.name)
            if self._conn is conn and not conn.closed:
                logger.info("connection %s re-established (reconnect #%d)",
                            self.name, self.reconnects)
                return
            # Dropped again mid-resync (_on_inner_close saw this task
            # still running and spawned nothing) — keep dialing.

    # -- RpcConnection-compatible surface --

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def connected(self) -> bool:
        conn = self._conn
        return conn is not None and not conn.closed

    @property
    def peer_wire_version(self) -> int:
        """Wire version of the CURRENT link.  Every redial builds a fresh
        RpcConnection that renegotiates from scratch, so a heal onto an
        older (or newer) peer settles on whatever that link supports."""
        conn = self._conn
        if conn is None or conn.closed:
            return 1
        return conn.peer_wire_version

    def _live(self) -> RpcConnection:
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        conn = self._conn
        if conn is None or conn.closed:
            raise ConnectionLost(f"{self.name}: link down (reconnecting)")
        return conn

    async def request(self, msg: dict, timeout: Optional[float] = None) -> Any:
        return await self._live().request(msg, timeout)

    async def notify(self, msg: dict):
        await self._live().notify(msg)

    def request_batch(self, msgs) -> "list[asyncio.Future]":
        return self._live().request_batch(msgs)

    async def maybe_drain(self) -> None:
        conn = self._conn
        if conn is not None and not conn.closed:
            await conn.maybe_drain()

    async def close(self):
        self._closed = True
        if self._redial_task is not None and not self._redial_task.done():
            self._redial_task.cancel()
            try:
                await self._redial_task
            except asyncio.CancelledError:
                cur = asyncio.current_task()
                if cur is not None and \
                        getattr(cur, "cancelling", lambda: 0)() > 0:
                    raise
            except Exception:
                pass
        conn, self._conn = self._conn, None
        if conn is not None:
            await conn.close()
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:
                logger.exception("on_close callback failed")


async def connect(
    addr: str,
    handler: Callable[[dict], Awaitable[Any]],
    name: str = "",
    *,
    reconnect: bool = False,
    dial_timeout_s: float = 5.0,
    backoff_base_s: float = 0.2,
    backoff_max_s: float = 5.0,
    on_reconnect: Optional[Callable[["ReconnectingConnection"], Any]] = None,
    on_disconnect: Optional[Callable[["ReconnectingConnection"], None]] = None,
):
    """addr is "host:port" for TCP or "unix://path".

    With ``reconnect=True`` returns a ReconnectingConnection (same call
    surface) whose link self-heals after drops; the initial dial still
    raises on failure."""
    if reconnect:
        rc = ReconnectingConnection(
            addr, handler, name=name,
            dial_timeout_s=dial_timeout_s,
            backoff_base_s=backoff_base_s,
            backoff_max_s=backoff_max_s,
            on_reconnect=on_reconnect,
            on_disconnect=on_disconnect,
        )
        await rc.dial()
        return rc
    if addr.startswith("unix://"):
        reader, writer = await asyncio.open_unix_connection(addr[len("unix://"):])
    else:
        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
    conn = RpcConnection(reader, writer, handler, name=name)
    conn.start()
    return conn


class RpcServer:
    """Accepts connections and wires each to a per-connection handler factory."""

    def __init__(
        self,
        handler_factory: Callable[[RpcConnection], Callable[[dict], Awaitable[Any]]],
        host: str = "127.0.0.1",
    ):
        self._factory = handler_factory
        self._host = host
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self.connections: list[RpcConnection] = []

    async def start(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(self._on_client, self._host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    @property
    def address(self) -> str:
        return f"{self._host}:{self.port}"

    async def _on_client(self, reader, writer):
        conn = RpcConnection(reader, writer, None, name="server-peer")
        conn.handler = self._factory(conn)
        self.connections.append(conn)
        # The factory may have installed its own on_close (GCS node-loss
        # detection, client-session disconnect accounting) — chain it,
        # don't clobber it.
        factory_close = conn.on_close

        def _on_close(c):
            if c in self.connections:
                self.connections.remove(c)
            if factory_close is not None:
                factory_close(c)

        conn.on_close = _on_close
        conn.start()

    async def close(self):
        # Close live connections BEFORE wait_closed(): since 3.12
        # wait_closed waits for client transports too, and a stalled
        # (paused-read) connection never sees the peer's FIN — so the old
        # order could wedge server shutdown on one dead client.
        if self._server is not None:
            self._server.close()
        for conn in list(self.connections):
            await conn.close()
        if self._server is not None:
            await self._server.wait_closed()

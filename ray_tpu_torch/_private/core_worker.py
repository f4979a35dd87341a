"""CoreWorker: per-process runtime embedded in the driver and every worker.

Design analog: reference ``src/ray/core_worker/`` -- CoreWorker (submit +
execute), TaskManager (retries), ReferenceCounter (local refs), ActorManager /
CoreWorkerDirectActorTaskSubmitter (direct ordered actor calls),
CoreWorkerMemoryStore (small objects inline in the owner), and the Cython
driver glue in ``python/ray/_raylet.pyx`` (execute_task loop).

Threading model: one asyncio IO loop on a dedicated thread handles every
socket; task/actor-method execution runs on a single dedicated execution
thread (preserving actor serial semantics), with async actor methods running
as coroutines on the IO loop.  The public API is synchronous and bridges with
run_coroutine_threadsafe -- same shape as the reference's C++ io_service +
Python execution thread split.

Key protocol choices mirroring the reference:
  * Normal tasks: lease a worker from the local raylet (spillback honored),
    then push the task DIRECTLY to the leased worker (direct_task_transport.h).
  * Actor calls: resolve the actor address via GCS once, then push calls
    directly to the actor's worker with per-handle sequence numbers
    (direct_actor_task_submitter.h); on disconnect, re-resolve and either
    resubmit (restarting) or fail with ActorDiedError (dead).
  * Small objects (<= INLINE_MAX) live in the owner's memory store and are
    inlined into task specs / replies; large objects go through the node's
    shared-memory store with locations registered in the GCS directory.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import hashlib
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import cloudpickle

from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private.async_utils import spawn
from ray_tpu_torch._private import wire
from ray_tpu_torch._private import object_ref as object_ref_mod
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID, task_id_generator
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_transfer import (ChecksumError, crc32_segments,
                                              fetch_object_into)
from ray_tpu_torch._private.plasma import PlasmaClient
from ray_tpu_torch._private.protocol import ConnectionLost, RpcConnection, RpcServer, connect
from ray_tpu_torch._private.serialization import get_context

logger = logging.getLogger(__name__)

from ray_tpu_torch._private.config import config as _rt_config


def INLINE_MAX() -> int:
    # objects at or below this ride inline in the owner (reference: 100KB)
    return _rt_config().inline_max_bytes


class _NotInline(Exception):
    """Control-flow signal: an arg entry needs the async resolve path."""


_tracing = None


def _tracing_mod():
    """ray_tpu_torch.util.tracing, imported once on first use: a module-level
    import would be circular (ray_tpu_torch.util -> placement_group -> worker ->
    core_worker), and the per-call ``from ... import`` in the submit hot
    path cost ~5us/call in import machinery."""
    global _tracing
    if _tracing is None:
        from ray_tpu_torch.util import tracing
        _tracing = tracing
    return _tracing


def DEFAULT_MAX_RETRIES() -> int:
    return _rt_config().task_max_retries


def _dumps_exception(e: BaseException, tb: str) -> bytes:
    """Pickle an (exception, traceback-text) error payload.  Blocking and
    potentially unbounded (user exception state) — call it on an executor
    thread from loop code; see _serialize_exception_async."""
    try:
        payload = cloudpickle.dumps((e, tb))
    except Exception:
        payload = cloudpickle.dumps(
            (RuntimeError(f"{type(e).__name__}: {e} (original unpicklable)"), tb))
    return payload


def _serialize_exception(e: BaseException) -> bytes:
    """Sync error serialization — exec threads and other off-loop callers
    only; loop code awaits _serialize_exception_async instead."""
    return _dumps_exception(e, traceback.format_exc())


async def _serialize_exception_async(e: BaseException,
                                     tb: Optional[str] = None) -> bytes:
    """Error serialization for loop code: the traceback text is captured
    here (while the except context is live) but the pickling — unbounded,
    user-controlled work — runs on the default executor so heartbeats and
    replies sharing the loop never stall behind it."""
    if tb is None:
        tb = traceback.format_exc()
    return await asyncio.get_running_loop().run_in_executor(
        None, _dumps_exception, e, tb)


async def _dumps_off_loop(obj) -> bytes:
    """cloudpickle.dumps on the default executor (rare-path payloads
    built from loop code)."""
    return await asyncio.get_running_loop().run_in_executor(
        None, cloudpickle.dumps, obj)


async def _loads_off_loop(payload):
    """cloudpickle.loads on the default executor (rare-path payloads
    decoded on loop code)."""
    return await asyncio.get_running_loop().run_in_executor(
        None, cloudpickle.loads, payload)


class ExecChannel:
    """Single dedicated execution thread (actor serial semantics) with the
    minimum per-item machinery: a SimpleQueue hand-off in, one
    call_soon_threadsafe back.  Replaces ThreadPoolExecutor, whose
    submit() builds a concurrent Future (lock + condition) and a chained
    callback per item — ~40us/call of pure overhead on the actor hot path
    (reference analog: the dedicated task-execution thread in the
    Cython worker loop, ``_raylet.pyx execute_task``)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        import queue
        self._loop = loop
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._staged: list = []
        t = threading.Thread(target=self._main, daemon=True, name="rt-exec")
        self._threads = [t]          # same shape as ThreadPoolExecutor's
        t.start()

    def _main(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            # Results coalesce too: one call_soon_threadsafe (one
            # self-pipe write) delivers every finish from a burst of
            # short bodies.  A flush every _FINISH_FLUSH_S bounds the
            # extra latency a long body could add to earlier finishes.
            done: list = []
            deadline = time.monotonic() + self._FINISH_FLUSH_S
            for fut, fn in batch:
                if fut.cancelled():
                    # Cancelled while queued (ray_tpu_torch.cancel on a parked
                    # actor call): the body must not run.  Reading the flag
                    # off-loop is GIL-safe; a cancel landing after this
                    # check races the body exactly as ThreadPoolExecutor's
                    # did.
                    continue
                try:
                    ok, res = True, fn()
                # rtlint: disable=cancellation-safety - thread boundary:
                # the exception (incl. KeyboardInterrupt from force-cancel)
                # is forwarded to the awaiting future by _finish_batch, not
                # swallowed; raising here would kill the shared exec thread.
                except BaseException as e:  # noqa: BLE001
                    ok, res = False, e
                done.append((fut, ok, res))
                if time.monotonic() >= deadline:
                    if not self._flush_done(done):
                        return       # loop closed mid-shutdown
                    done = []
                    deadline = time.monotonic() + self._FINISH_FLUSH_S
            if not self._flush_done(done):
                return

    _FINISH_FLUSH_S = 0.001

    def _flush_done(self, done: list) -> bool:
        if not done:
            return True
        try:
            self._loop.call_soon_threadsafe(self._finish_batch, done)
            return True
        except RuntimeError:
            return False             # loop closed mid-shutdown

    @staticmethod
    def _finish_batch(done: list) -> None:
        for fut, ok, res in done:
            if fut.cancelled():
                continue
            if ok:
                fut.set_result(res)
            else:
                fut.set_exception(res)

    def run(self, fn) -> asyncio.Future:
        """Schedule fn on the exec thread; await the returned future.
        Loop-thread callers only (the future belongs to the loop).

        Hand-off is coalesced per loop tick: same-tick submissions (a
        batched actor-call burst) stage on a list and reach the queue as
        ONE put — one lock/wakeup per burst instead of per call, which
        the n:n fan-in profile showed as a top-3 loop cost.  Results
        still complete per item, so a long body doesn't hold earlier
        finishes hostage."""
        fut = self._loop.create_future()
        self._staged.append((fut, fn))
        if len(self._staged) == 1:
            self._loop.call_soon(self._flush_staged)
        return fut

    def _flush_staged(self) -> None:
        batch, self._staged = self._staged, []
        if batch:
            self._q.put(batch)

    def shutdown(self, wait: bool = False) -> None:
        self._flush_staged()
        self._q.put(None)
        if wait:
            self._threads[0].join(timeout=5)


class CoreWorker:
    def __init__(
        self,
        gcs_address: str,
        raylet_address: Optional[str],
        store_name: Optional[str],
        node_id_hex: Optional[str],
        job_id: str,
        is_worker: bool = False,
    ):
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.node_id_hex = node_id_hex
        self.job_id = job_id
        self.is_worker = is_worker
        self.ser = get_context()

        # object state (guarded by the IO loop: only touched from loop thread,
        # except refcounts which use their own lock)
        self.memory_store: Dict[str, Tuple[str, Any]] = {}
        self.object_events: Dict[str, asyncio.Event] = {}
        self.owned: set = set()
        self._ref_lock = threading.Lock()
        self._local_refs: Dict[str, int] = {}
        # Distributed refcounting + lineage (reference: reference_count.h,
        # task_manager.h, object_recovery_manager.h):
        self._borrowing: set = set()            # oids we borrow (owner != us)
        self._borrowers: Dict[str, set] = {}    # oid -> borrower addresses
        self._borrow_acks: list = []            # in-flight borrow_add futures
        self._lineage: Dict[str, dict] = {}     # oid -> producing task record
        self._reconstructing: Dict[str, asyncio.Future] = {}
        # Task profile events, flushed to the GCS in batches (reference:
        # TaskEventBuffer, task_event_buffer.h).
        self._task_events: list = []
        self._event_flusher_started = False
        self._pid = os.getpid()
        # task_id hex -> cancellation state (reference task_manager's
        # pending-task map feeding CancelTask); _cancel_refs maps the
        # first return-object id back to its task, popped together with
        # the state when the call resolves (bounded by in-flight calls).
        self._cancel_state: Dict[str, dict] = {}
        self._cancel_refs: Dict[str, str] = {}
        # Pubsub: channel -> callbacks (reference pubsub/subscriber.h).
        self._subscriptions: Dict[str, list] = {}
        # Streaming-generator consumer state (reference: ObjectRefStream
        # in task_manager.h): task_id hex -> {queue, event, ref0,
        # cancelled}.  Registered by the submit paths BEFORE scheduling so
        # the first stream_yield can never beat it; popped on terminal
        # (exhausted / error / cancel).
        self._streams: Dict[str, dict] = {}

        self.plasma: Optional[PlasmaClient] = None
        if store_name:
            self.plasma = PlasmaClient(store_name)

        # actor submission state: actor_id hex -> dict
        self.actor_state: Dict[str, dict] = {}
        # Lazily armed on the first actor dial: an "actors"-channel
        # subscription that fences cached connections to restarted
        # incarnations (split-brain: the old worker may still be alive
        # behind a partition, so conn.closed alone can't detect it).
        self._actor_events_subscribed = False
        self._function_cache: Dict[str, Any] = {}
        self._exported_functions: set = set()

        # executor hooks, set by worker_main on workers
        self.task_executor = None

        # Actor-call submission coalescing (one loop wakeup per burst).
        self._submit_queue: list = []
        self._submit_lock = threading.Lock()
        self._submit_scheduled = False
        # Zero-ref frees coalesce the same way: a burst of ObjectRef
        # __del__s (a drained get loop) costs one loop wakeup, not one
        # call_soon_threadsafe per object.  Guarded by _ref_lock.
        self._free_queue: list = []
        self._free_scheduled = False

        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(target=self._loop_main,
                                             name="rt-io", daemon=True)
        self._started = threading.Event()
        self._loop_thread.start()
        self._started.wait()

        self.exec_pool = ExecChannel(self.loop)
        self._run(self._async_init())
        object_ref_mod.set_refcount_sink(self)

    # ------------------------------------------------------------ plumbing

    def _loop_main(self):
        asyncio.set_event_loop(self.loop)
        self._started.set()
        self.loop.run_forever()

    def _run(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    async def _async_init(self):
        self.server = RpcServer(self._make_handler)
        await self.server.start(0)
        self.address = self.server.address
        cfg = _rt_config()
        # Reconnecting: a driver/worker must survive a GCS blip or head
        # restart.  Channel subscriptions are per-conn state on the GCS
        # side, so the reconnect callback replays them.
        self.gcs = await connect(
            self.gcs_address, self._handle_push, name="cw->gcs",
            reconnect=True,
            dial_timeout_s=cfg.gcs_dial_timeout_s,
            backoff_base_s=cfg.gcs_reconnect_backoff_base_s,
            backoff_max_s=cfg.gcs_reconnect_backoff_max_s,
            on_reconnect=self._on_gcs_reconnect)
        self.raylet = None
        if self.raylet_address:
            self.raylet = await connect(self.raylet_address, self._handle_push,
                                        name="cw->raylet")
        self._worker_conns: Dict[str, RpcConnection] = {}

    def shutdown(self):
        try:
            self._run(self._async_shutdown(), timeout=5)
        except Exception:
            pass
        # Detach the refcount sink BEFORE closing the loop: ObjectRef.__del__
        # runs from arbitrary GC context and its is_closed() guard is
        # check-then-act -- a ref collected mid-close would raise
        # "Event loop is closed".
        object_ref_mod.set_refcount_sink(None)
        self.loop.call_soon_threadsafe(self.loop.stop)
        # Close the loop deterministically.  Leaving it for GC means
        # BaseEventLoop.__del__ runs during interpreter teardown, after its
        # self-pipe socket is already dead -> "Invalid file descriptor: -1"
        # noise on every clean exit.
        self._loop_thread.join(timeout=5)
        if not self.loop.is_running():
            try:
                self.loop.close()
            except Exception:
                pass
        self.exec_pool.shutdown(wait=False)

    async def _async_shutdown(self):
        await self.server.close()
        for c in list(self._worker_conns.values()):
            await c.close()
        # Actor-handle connections are dialed lazily per actor; close them
        # too or their _serve tasks outlive the loop ("Task was destroyed
        # but it is pending" spam at every interpreter exit).
        for st in list(self.actor_state.values()):
            conn = st.get("conn")
            if conn is not None and not conn.closed:
                await conn.close()
        if self.raylet:
            await self.raylet.close()
        await self.gcs.close()
        if self.plasma:
            self.plasma.close()
            self.plasma = None

    async def _on_gcs_reconnect(self, conn) -> None:
        """The GCS link healed (blip or head restart): re-issue every
        channel subscription.  The GCS keeps subscriber lists per
        connection, so without this replay all pubsub (actor events, node
        events, worker logs) would silently stop after any drop."""
        channels = list(self._subscriptions)
        for channel in channels:
            try:
                await conn.request({"type": "subscribe", "channel": channel})
            except Exception:
                logger.warning("re-subscribe to %r after GCS reconnect "
                               "failed", channel, exc_info=True)
        if channels:
            logger.info("re-subscribed %d pubsub channels after GCS "
                        "reconnect", len(channels))

    async def _handle_push(self, msg: dict):
        if msg.get("type") == "pub":
            # Reference pubsub Subscriber (pubsub/subscriber.h): dispatch to
            # local channel callbacks; user callbacks must not block the IO
            # loop, so they run on the executor thread pool.
            def _log_cb_error(fut):
                if fut.exception() is not None:
                    logger.error("pubsub callback failed",
                                 exc_info=fut.exception())

            for cb in list(self._subscriptions.get(msg.get("channel"), [])):
                fut = self.loop.run_in_executor(None, cb, msg.get("data"))
                fut.add_done_callback(_log_cb_error)
            return None
        raise ValueError(f"unexpected push {msg.get('type')}")

    def subscribe(self, channel: str, callback) -> None:
        """Invoke callback(data) for every event published on channel
        ('nodes', 'actors', ...). Reference: GcsSubscriber channels
        (pubsub/publisher.h:298)."""
        first = channel not in self._subscriptions
        self._subscriptions.setdefault(channel, []).append(callback)
        if first:
            self.gcs_request({"type": "subscribe", "channel": channel})

    def unsubscribe(self, channel: str, callback=None) -> None:
        if callback is None:
            self._subscriptions.pop(channel, None)
        else:
            cbs = self._subscriptions.get(channel, [])
            if callback in cbs:
                cbs.remove(callback)
            if not cbs:
                self._subscriptions.pop(channel, None)
        if channel not in self._subscriptions:
            # Tell the GCS to stop pushing this channel at us.
            try:
                self.gcs_request({"type": "unsubscribe", "channel": channel})
            except Exception:
                pass

    def _fast_dispatch(self, conn, rid: int, msg) -> bool:
        """Per-connection fast_handler: give the task executor (when this
        process hosts one) a chance to serve an actor call without the
        per-request asyncio task.  task_executor is resolved per call —
        it is attached after the server starts accepting."""
        ex = self.task_executor
        if ex is None:
            return False
        return ex.fast_actor_call(conn, rid, msg)

    def _make_handler(self, conn: RpcConnection):
        conn.fast_handler = functools.partial(self._fast_dispatch, conn)

        async def handle(msg: dict):
            mtype = msg["type"]
            if mtype == "get_object":
                return await self._h_get_object(msg)
            if mtype == "wait_object":
                return await self._h_wait_object(msg)
            if mtype == "borrow_add":
                return await self._h_borrow_add(msg)
            if mtype == "borrow_remove":
                return await self._h_borrow_remove(msg)
            if mtype == "reconstruct_object":
                return await self._h_reconstruct_object(msg)
            if mtype == "stream_yield":
                return await self._h_stream_yield(msg)
            if self.task_executor is not None:
                return await self.task_executor.handle(conn, msg)
            raise ValueError(f"core worker: unknown message {mtype}")
        return handle

    async def _h_wait_object(self, msg: dict):
        """Metadata-only readiness long-poll (reference: wait is
        metadata-only with fetch_local control — no value bytes move)."""
        ready = await self._await_in_store(
            msg["object_id"], time.monotonic() + msg.get("timeout", 300.0))
        return {"ready": ready}

    async def _h_reconstruct_object(self, msg: dict):
        ok = await self._reconstruct(msg["object_id"])
        return {"ok": ok}

    # --------------------------------------------------------- task events

    def record_task_event(self, event: dict):
        """Buffer a task profile event; flushed to the GCS once a second
        (feeds the state API and `ray_tpu_torch.timeline`)."""
        if "pid" not in event:
            event["pid"] = self._pid
        if "node_id" not in event:
            event["node_id"] = self.node_id_hex
        self._task_events.append(event)
        if not self._event_flusher_started:
            self._event_flusher_started = True
            asyncio.run_coroutine_threadsafe(self._flush_events_loop(),
                                             self.loop)

    async def flush_task_events(self):
        if not self._task_events:
            return
        batch, self._task_events = self._task_events, []
        try:
            await self.gcs.request({"type": "task_events",
                                    "events": batch}, timeout=10)
        except Exception:
            pass  # observability is best-effort

    async def _flush_events_loop(self):
        while True:
            await asyncio.sleep(1.0)
            await self.flush_task_events()

    async def _await_in_store(self, oid: str, deadline: float) -> bool:
        """Long-poll until `oid` has a memory-store entry; False on timeout."""
        while oid not in self.memory_store:
            ev = self.object_events.setdefault(oid, asyncio.Event())
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                return False
        return True

    async def _h_get_object(self, msg: dict):
        """Owner-fetch: another process resolves an object we own."""
        oid = msg["object_id"]
        deadline = time.monotonic() + msg.get("timeout", 300.0)
        if not await self._await_in_store(oid, deadline):
            return {"status": "timeout"}
        kind, data = self.memory_store[oid]
        if kind == "val":
            return {"status": "inline", "data": data}
        if kind == "pval" or kind == "ndval":
            # Raw fast-lane return (zero-pickle): the value (or the
            # ndarray triple) itself rides the reply, no serialized
            # envelope to unwrap.
            return {"status": kind, "data": data}
        if kind == "err":
            return {"status": "error", "data": data}
        if kind == "cancel":
            # Pickle-free cancellation marker: the payload is just the
            # message text, rebuilt into TaskCancelledError by the reader.
            return {"status": "cancelled", "data": data}
        # "plasma" and "cval" (a client-mode byte cache layered over a
        # plasma object) both answer 'plasma': cluster workers must keep
        # pulling node-to-node instead of streaming through the client
        # driver's (possibly WAN) link.
        return {"status": "plasma"}

    # ---------------------------------------------------- streaming returns
    #
    # num_returns="streaming" protocol (reference: ObjectRefStream,
    # task_manager.h + ReportGeneratorItemReturns): the executor sends one
    # stream_yield RPC per yield and AWAITS the ack before stepping the
    # generator again — the ack is the backpressure (one yield in flight),
    # and a refused ack is the cancellation signal (the executor closes
    # the user generator so its finally blocks run).  The final task reply
    # still stores an ObjectRefGenerator at return-index 0, which doubles
    # as the stream's completion marker: every yield ack completes before
    # the final reply is sent, so ref0 appearing in the memory store
    # strictly follows the last yield.

    def register_stream(self, task_id_hex: str, ref0_hex: str) -> None:
        """Create consumer state for a streaming call.  Called from the
        submitting thread BEFORE the task is scheduled (dict assignment is
        atomic under the GIL; the Event binds its loop lazily on first
        wait, which happens on the IO loop)."""
        self._streams[task_id_hex] = {
            "queue": collections.deque(),
            "event": asyncio.Event(),
            "ref0": ref0_hex,
            "cancelled": False,
        }

    async def _h_stream_yield(self, msg: dict):
        """Owner-side adoption of one in-flight yield.  A missing or
        cancelled stream refuses the yield — and frees the executor-side
        copy, which nobody will ever reference — telling the producer to
        stop."""
        st = self._streams.get(msg["task_id"])
        oid_hex, kind, data = msg["entry"]
        if st is None or st["cancelled"]:
            if kind not in ("inline", "pval", "ndval"):
                spawn(self.gcs.notify(
                    {"type": "object_freed", "object_id": oid_hex}),
                    name="notify-object-freed", log=logger)
            return {"ok": False, "cancelled": True}
        self.owned.add(oid_hex)
        self._store_return_entry(oid_hex, kind, data)
        ref = ObjectRef(ObjectID.from_hex(oid_hex), self.address)
        st["queue"].append(ref)
        st["event"].set()
        return {"ok": True}

    async def stream_next_async(self, task_id_hex: str,
                                timeout: Optional[float] = None):
        """Next yielded ObjectRef of a streaming call; StopAsyncIteration
        when the producer finished (or the stream was cancelled), the
        task's error if it failed mid-stream.  Runs on the IO loop."""
        st = self._streams.get(task_id_hex)
        if st is None:
            raise StopAsyncIteration
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if st["queue"]:
                return st["queue"].popleft()
            if st["cancelled"]:
                raise StopAsyncIteration
            # Terminal check AFTER draining: the producer only stores ref0
            # once every yield has been acked, so a present ref0 with an
            # empty queue means the stream is fully consumed.
            entry = self.memory_store.get(st["ref0"])
            if entry is not None:
                self._streams.pop(task_id_hex, None)
                if entry[0] in ("err", "cancel"):
                    # raises the task's error (decode off-loop)
                    await self._materialize_async(entry)
                raise StopAsyncIteration
            st["event"].clear()
            ev0 = self.object_events.setdefault(st["ref0"], asyncio.Event())
            waiters = [asyncio.ensure_future(st["event"].wait()),
                       asyncio.ensure_future(ev0.wait())]
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            try:
                done, pending = await asyncio.wait(
                    waiters, timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED)
            finally:
                for w in waiters:
                    if not w.done():
                        w.cancel()
            if not done:
                raise rex.GetTimeoutError(
                    f"stream {task_id_hex[:16]} produced nothing for "
                    f"{timeout}s")

    def stream_next(self, task_id_hex: str,
                    timeout: Optional[float] = None):
        """Blocking stream_next for non-loop threads (drivers)."""
        if threading.current_thread() is self._loop_thread:
            raise RuntimeError(
                "stream_next would deadlock the IO loop; use `async for` "
                "on the generator instead")
        return self._run(self.stream_next_async(task_id_hex, timeout))

    def cancel_stream(self, task_id_hex: str, ref0: Optional[ObjectRef] = None):
        """Consumer-side stream teardown (explicit cancel or handle GC):
        drop queued refs (freeing their objects), refuse all future
        yields, and best-effort cancel the producer task so a generator
        stalled between yields doesn't hold its worker forever.  Safe
        from any thread, including during interpreter teardown."""
        def _do():
            st = self._streams.pop(task_id_hex, None)
            if st is None:
                return
            st["cancelled"] = True
            st["queue"].clear()   # refs GC -> remove_local_ref -> free
            st["event"].set()
        try:
            if self.loop.is_closed():
                return
            self.loop.call_soon_threadsafe(_do)
        except RuntimeError:
            return
        if ref0 is not None:
            try:
                self.cancel_task(ref0)
            except Exception:
                pass

    # ------------------------------------------------------------ refcounts

    def add_local_ref(self, oid: ObjectID, owner_address: str = ""):
        h = oid.hex()
        register = False
        with self._ref_lock:
            n = self._local_refs.get(h, 0) + 1
            self._local_refs[h] = n
            # First ref to someone else's object: register as a borrower so
            # the owner keeps the value alive past its own local refcount
            # (reference: ReferenceCounter borrower bookkeeping,
            # reference_count.h:61).
            if (n == 1 and owner_address and owner_address != self.address
                    and h not in self._borrowing):
                self._borrowing.add(h)
                register = True
        if register and not self.loop.is_closed():
            fut = asyncio.run_coroutine_threadsafe(
                self._send_borrow(h, owner_address, add=True), self.loop)
            # Prune finished acks: only executors drain this list (drivers
            # never call flush_borrow_acks), so it must self-limit.
            self._borrow_acks = [f for f in self._borrow_acks
                                 if not f.done()] + [fut]

    def remove_local_ref(self, oid: ObjectID, owner_address: str = ""):
        h = oid.hex()
        deregister = False
        with self._ref_lock:
            n = self._local_refs.get(h, 0) - 1
            if n > 0:
                self._local_refs[h] = n
                return
            self._local_refs.pop(h, None)
            if h in self._borrowing:
                self._borrowing.discard(h)
                deregister = True
            self._free_queue.append(oid)
            wake = not self._free_scheduled
            self._free_scheduled = True
        if self.loop.is_closed():
            return
        if deregister:
            asyncio.run_coroutine_threadsafe(
                self._send_borrow(h, owner_address, add=False), self.loop)
        if wake:
            self.loop.call_soon_threadsafe(self._flush_frees)

    def _flush_frees(self) -> None:
        """Loop-side: free every object whose last local ref dropped since
        the previous tick."""
        with self._ref_lock:
            batch, self._free_queue = self._free_queue, []
            self._free_scheduled = False
        for oid in batch:
            self._free_object(oid)

    async def _send_borrow(self, oid_hex: str, owner: str, add: bool):
        try:
            conn = await self._get_worker_conn(owner)
            await conn.request({"type": "borrow_add" if add else
                                "borrow_remove",
                                "object_id": oid_hex,
                                "borrower": self.address}, timeout=60)
        except Exception:
            # Owner gone: nothing to keep alive / release.
            pass

    async def flush_borrow_acks(self):
        """Await in-flight borrow registrations.  Executors call this before
        replying to a task so the owner learns about borrows while the
        submitter still pins the args (closing the free-vs-borrow race)."""
        acks, self._borrow_acks = self._borrow_acks, []
        for fut in acks:
            try:
                await asyncio.wrap_future(fut)
            except Exception:
                pass

    async def _h_borrow_add(self, msg: dict):
        h = msg["object_id"]
        if h not in self.owned:
            return {"ok": False}  # already freed -- borrower raced the free
        self._borrowers.setdefault(h, set()).add(msg["borrower"])
        return {"ok": True}

    async def _h_borrow_remove(self, msg: dict):
        h = msg["object_id"]
        s = self._borrowers.get(h)
        if s is not None:
            s.discard(msg["borrower"])
            if not s:
                del self._borrowers[h]
                with self._ref_lock:
                    no_local = self._local_refs.get(h, 0) == 0
                if no_local:
                    self._free_object(ObjectID.from_hex(h))
        return {"ok": True}

    def _free_object(self, oid: ObjectID):
        """Zero local refs: owners free the value (reference_count.h eager
        deletion) unless borrowers still hold it; borrowers just drop
        local state."""
        h = oid.hex()
        if h not in self.owned:
            return
        if self._borrowers.get(h):
            return  # a borrower keeps it alive; freed on last borrow_remove
        self.owned.discard(h)
        self._lineage.pop(h, None)
        entry = self.memory_store.pop(h, None)
        self.object_events.pop(h, None)
        if self.plasma is not None and (entry is None or entry[0] == "plasma"):
            try:
                self.plasma.delete(oid)
                # Fan out cluster-wide deletion (remote copies AND spill
                # files) through the GCS object directory — a spilled
                # object has no local plasma copy, so this must fire even
                # when the local delete was a no-op.
                spawn(self.gcs.notify({
                    "type": "object_freed", "object_id": h}),
                    name="notify-object-freed", loop=self.loop, log=logger)
            except Exception:
                pass

    # ------------------------------------------------------------ put/get

    def _store_local(self, oid_hex: str, kind: str, data):
        self.memory_store[oid_hex] = (kind, data)
        if kind != "plasma":
            # In-process values/errors never take the plasma-lost path;
            # their lineage (full task spec + pinned args) can go.
            self._lineage.pop(oid_hex, None)
        ev = self.object_events.get(oid_hex)
        if ev is not None:
            ev.set()

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.for_task_return(task_id_generator.next(), 0)
        ser = self.ser.serialize(value)
        ref = ObjectRef(oid, self.address)
        self._run(self._put_serialized(oid, ser))
        return ref

    async def _plasma_put(self, oid: ObjectID, ser) -> None:
        """put_bytes with one spill-and-retry on a full store (reference:
        plasma CreateRequestQueue retrying after LocalObjectManager spills)."""
        from ray_tpu_torch._private.plasma import ObjectStoreFullError
        try:
            self.plasma.put_bytes(oid, ser.segments, allow_evict=False)
        except ObjectStoreFullError:
            if self.raylet is None:
                raise
            await self.raylet.request(
                {"type": "spill_request", "bytes": ser.total_size},
                timeout=60)
            # Still-full now falls back to LRU eviction rather than failing:
            # everything spillable has been spilled.
            self.plasma.put_bytes(oid, ser.segments)

    async def _put_serialized(self, oid: ObjectID, ser) -> None:
        h = oid.hex()
        self.owned.add(h)
        if ser.total_size <= INLINE_MAX() or self.plasma is None:
            self._store_local(h, "val", ser.to_bytes())
        else:
            await self._plasma_put(oid, ser)
            self._store_local(h, "plasma", None)
            # Seal-time integrity stamp: the plasma copy is the segment
            # concatenation, so crc over segments == crc over the copy.
            await self.gcs.request({"type": "object_location_add",
                                    "object_id": h,
                                    "node_id": self.node_id_hex,
                                    "owner": self.address,
                                    "size": ser.total_size,
                                    "checksum": crc32_segments(ser.segments)
                                    if _rt_config().transfer_checksum
                                    else None})

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None):
        return self._run(self.get_objects_async(refs, timeout))

    async def get_objects_async(self, refs: List[ObjectRef],
                                timeout: Optional[float] = None):
        # Blocked-worker resource release (reference:
        # raylet_client NotifyDirectCallTaskBlocked/Unblocked): a worker
        # mid-task that blocks in get() hands its lease's CPUs back to
        # the raylet so dependent (often CHILD) tasks can schedule —
        # without this, recursive task trees deadlock once every worker
        # slot holds a parent blocked on its children.
        notify = (self.is_worker and self.raylet is not None
                  and getattr(self, "worker_id_hex", None)
                  and getattr(self.task_executor, "_current_task_id", None)
                  is not None
                  # Only when the get will actually wait: an
                  # already-local fast-path get must not bounce the
                  # lease's CPUs (the release + re-deduct around an
                  # instant get would admit an extra task and leave the
                  # pool oversubscribed for both tasks' lifetimes).
                  and any(r.hex() not in self.memory_store for r in refs))
        if notify:
            await self.raylet.notify({"type": "worker_blocked",
                                      "worker_id": self.worker_id_hex})
        try:
            if timeout is None:
                return await self._get_objects(refs)
            return await asyncio.wait_for(self._get_objects(refs), timeout)
        except asyncio.TimeoutError:
            raise rex.GetTimeoutError(
                f"get() timed out after {timeout}s") from None
        finally:
            if notify:
                try:
                    await self.raylet.notify({"type": "worker_unblocked",
                                              "worker_id":
                                              self.worker_id_hex})
                except Exception:
                    pass  # raylet gone: the worker is about to die anyway

    async def _get_objects(self, refs: List[ObjectRef]):
        # Remote-owned refs need their pulls IN FLIGHT concurrently (a
        # gather task each); self-owned refs resolve passively — their
        # values land in the local memory store regardless of who waits —
        # so awaiting them sequentially is equivalent and skips a task +
        # future per ref (the actor-call fan-in hot path: get() on many
        # returns of calls this process submitted).
        out = [None] * len(refs)
        local_idx = []
        remote = []
        for i, r in enumerate(refs):
            if r.owner_address and r.owner_address != self.address:
                remote.append(self._fill_get(out, i, r))
            else:
                local_idx.append(i)
        if remote:
            await asyncio.gather(*remote)
        for i in local_idx:
            out[i] = await self.get_async(refs[i])
        return out

    async def _fill_get(self, out: list, i: int, ref: ObjectRef):
        out[i] = await self.get_async(ref)

    async def get_async(self, ref: ObjectRef) -> Any:
        data = await self._resolve_bytes(ref.id, ref.owner_address)
        return await self._materialize_async(data)

    def _materialize(self, data):
        """Sync decode — off-loop callers (driver threads via _run).  Loop
        code awaits _materialize_async so error unpickling (unbounded,
        user exception state) never runs on the IO loop."""
        kind, payload = data
        if kind == "err":
            self._raise_err(cloudpickle.loads(payload))
        return self._materialize_value(kind, payload)

    async def _materialize_async(self, data):
        kind, payload = data
        if kind == "err":
            self._raise_err(await _loads_off_loop(payload))
        return self._materialize_value(kind, payload)

    def _materialize_value(self, kind, payload):
        if kind == "pval":
            return payload       # raw primitive: the value IS the payload
        if kind == "ndval":
            return self._rebuild_ndarray(("nd",) + tuple(payload))
        if kind == "cancel":
            raise rex.TaskCancelledError(payload)
        value = self.ser.deserialize(memoryview(payload))
        return value

    @staticmethod
    def _raise_err(decoded):
        e, tb = decoded
        if isinstance(e, rex.RayTpuError):
            raise e
        raise rex.TaskError(e, tb)

    async def _resolve_bytes(self, oid: ObjectID, owner: str,
                             deadline: Optional[float] = None):
        """Resolve an object id to ('val'|'err', bytes) — or ('pval',
        raw primitive) — from anywhere."""
        h = oid.hex()
        while True:
            entry = self.memory_store.get(h)
            if entry is not None and entry[0] in ("val", "err", "pval",
                                                  "ndval", "cancel"):
                return entry
            if entry is not None and entry[0] == "cval":
                return ("val", entry[1])   # client-mode byte cache
            # Local shared-memory store.
            if self.plasma is not None:
                view = self.plasma.get(oid)
                if view is not None:
                    try:
                        data = bytes(view)
                    finally:
                        view.release()
                        self.plasma.release(oid)
                    return ("val", data)
            if entry is not None and entry[0] == "plasma":
                if self.plasma is None:
                    # Client mode (no local store): stream the bytes from a
                    # holder node's raylet over TCP instead of pulling into
                    # a plasma segment we don't have.  Cache as a local
                    # value so repeat gets don't re-stream (freed with the
                    # ref like any inline entry).
                    data = await self._fetch_remote_bytes(h)
                    if data is not None:
                        self._store_local(h, "cval", data)
                        return ("val", data)
                ok = await self._pull_to_local(h)
                if ok:
                    continue
                # We own it and every copy is gone: re-execute the
                # producing task from lineage.
                if h in self.owned:
                    if await self._reconstruct(h):
                        continue
                    raise rex.ObjectLostError(
                        f"object {h[:16]} lost: all copies gone and no "
                        f"lineage to reconstruct from (ray.put objects are "
                        f"not recoverable)")
            # Ask the owner (memory-store objects of other processes, or
            # discover that it lives in plasma somewhere).
            if owner and owner != self.address:
                owner_reachable = False
                try:
                    owner_conn = await self._get_worker_conn(owner)
                    reply = await owner_conn.request(
                        {"type": "get_object", "object_id": h}, timeout=310)
                    owner_reachable = True
                    if reply["status"] == "inline":
                        return ("val", reply["data"])
                    if reply["status"] in ("pval", "ndval"):
                        return (reply["status"], reply["data"])
                    if reply["status"] == "error":
                        return ("err", reply["data"])
                    if reply["status"] == "cancelled":
                        return ("cancel", reply["data"])
                    if reply["status"] == "plasma":
                        if self.plasma is None:
                            # Client mode: no store to pull into — stream
                            # bytes from a holder before resorting to
                            # (side-effectful) reconstruction.
                            data = await self._fetch_remote_bytes(h)
                            if data is not None:
                                self._store_local(h, "cval", data)
                                return ("val", data)
                        if await self._pull_to_local(h):
                            continue
                        # Copies lost: ask the owner to reconstruct from
                        # lineage, then pull again.
                        rec = await owner_conn.request(
                            {"type": "reconstruct_object", "object_id": h},
                            timeout=600)
                        if rec.get("ok"):
                            if self.plasma is None:
                                data = await self._fetch_remote_bytes(h)
                                if data is not None:
                                    self._store_local(h, "cval", data)
                                    return ("val", data)
                            elif await self._pull_to_local(h):
                                continue
                except ConnectionLost:
                    pass
                # Owner gone (or reconstruction failed); try the object
                # directory anyway — another node may still hold a copy.
                if await self._pull_to_local(h):
                    continue
                detail = ("owner could not reconstruct it"
                          if owner_reachable else
                          f"owner {owner} unreachable")
                raise rex.ObjectLostError(
                    f"object {h[:16]} lost: {detail} and no copies found")
            if owner == self.address or not owner:
                # We own it but it is not ready yet -> wait for task completion.
                ev = self.object_events.setdefault(h, asyncio.Event())
                await ev.wait()
                ev.clear()
                continue

    async def _reconstruct(self, oid_hex: str) -> bool:
        """Owner-side object recovery: re-execute the producing task to
        regenerate a lost plasma object (reference:
        object_recovery_manager.h:41).  Returns True if the object is
        available again."""
        if oid_hex not in self.owned:
            return False
        rec = self._lineage.get(oid_hex)
        if rec is None:
            return False  # ray.put objects / depth-exhausted: unrecoverable
        inflight = self._reconstructing.get(oid_hex)
        if inflight is not None:
            return await inflight
        fut = asyncio.get_running_loop().create_future()
        for oid in rec["return_ids"]:
            self._reconstructing[oid.hex()] = fut
        logger.info("reconstructing object %s via task %s", oid_hex[:16],
                    rec["spec"]["name"])
        try:
            # Don't pre-clear sibling entries: a failed resubmit must leave
            # healthy siblings resolvable, and a successful one overwrites
            # the stale 'plasma' entries anyway.
            #
            # The resubmit consumes the task's own retry budget (reference:
            # lineage reconstruction decrements num_retries_left).  The
            # first attempt often races the very node death that triggered
            # reconstruction — cluster views are stale for up to a
            # heartbeat, so the lease can chase the dead raylet and get
            # ECONNREFUSED — hence the short backoff between attempts.
            ok = False
            attempts = 1 + max(0, int(rec.get("max_retries", 0)))
            for attempt in range(attempts):
                if attempt:
                    await asyncio.sleep(min(2.0, 0.5 * (2 ** (attempt - 1))))
                try:
                    reply = await self._submit_once(
                        rec["spec"], rec["resources"], rec["scheduling"])
                    ok = bool(reply.get("ok"))
                    if ok:
                        self._store_task_returns(reply, rec["return_ids"])
                        break
                except Exception as e:
                    logger.warning(
                        "reconstruction of %s via task %s failed "
                        "(attempt %d/%d): %r", oid_hex[:16],
                        rec["spec"]["name"], attempt + 1, attempts, e)
            fut.set_result(ok)
            return ok
        finally:
            for oid in rec["return_ids"]:
                self._reconstructing.pop(oid.hex(), None)
            if not fut.done():
                fut.set_result(False)

    async def _fetch_remote_bytes(self, oid_hex: str) -> Optional[bytes]:
        """Chunked fetch of a plasma object's bytes from any holder node's
        raylet (Ray Client path: the driver has no shm store to pull
        into)."""
        try:
            loc = await self.gcs.request({"type": "object_locations_get",
                                          "object_id": oid_hex})
            if not loc:
                return None
            nodes = await self._get_nodes_cached()
        except Exception:
            logger.debug("client-mode remote fetch of %s: directory lookup "
                         "failed", oid_hex[:16], exc_info=True)
            return None
        holders = set(loc.get("nodes", [])) | set(loc.get("spilled", {}))
        checksum = loc.get("checksum") \
            if _rt_config().transfer_checksum else None

        async def _alloc(total: int):
            return bytearray(total)

        for n in nodes:
            if n["node_id"] not in holders or not n["alive"]:
                continue
            # Per-holder isolation: a dead-but-still-listed node must not
            # abort the fetch — try the next copy (same policy as the
            # raylet's own pull path).
            try:
                conn = await self._get_worker_conn(n["address"])
                buf = await fetch_object_into(conn, oid_hex, _alloc,
                                              checksum=checksum)
                if buf is not None:
                    return bytes(buf)
            except ChecksumError as e:
                # Same quarantine contract as the raylet pull path: a
                # client must not hand corrupted bytes to user code, and
                # the bad copy must stop being advertised.
                logger.warning("client-mode fetch of %s from node %s: %s; "
                               "invalidating that copy", oid_hex[:16],
                               n["node_id"][:12], e)
                try:
                    await self.gcs.request({
                        "type": "object_location_invalidate",
                        "object_id": oid_hex, "node_id": n["node_id"],
                        "reason": str(e)})
                except Exception:
                    pass
            except Exception:
                logger.debug("client-mode fetch of %s from %s failed",
                             oid_hex[:16], n["address"], exc_info=True)
        return None

    async def _pull_to_local(self, oid_hex: str) -> bool:
        if self.raylet is None or self.plasma is None:
            return False
        try:
            reply = await self.raylet.request({"type": "pull_object",
                                               "object_id": oid_hex}, timeout=300)
            return bool(reply.get("ok")) or \
                self.plasma.contains(ObjectID.from_hex(oid_hex))
        except ConnectionLost:
            return False

    def broadcast_object(self, ref, timeout: float = 300) -> int:
        """Proactively replicate a plasma object to every alive node via
        the raylet's binomial-tree push (reference push_manager.h has the
        push half; the tree fan-out is new — a 1->N broadcast does O(log N)
        rounds instead of N pulls hammering the owner).  Returns the number
        of target nodes.  Small (inline) objects are a no-op."""
        oid_hex = ref.id.hex()
        entry = self.memory_store.get(oid_hex)
        # "cval" is a client-mode byte cache over a real plasma object —
        # only true inline values ("val") skip replication.
        if entry is not None and entry[0] not in ("plasma", "cval"):
            return 0  # inline value: every consumer gets it with the ref
        if self.raylet is None:
            raise RuntimeError("broadcast requires a local raylet")

        async def _bcast():
            nodes = await self.gcs.request({"type": "get_nodes"})
            targets = [n["address"] for n in nodes
                       if n["alive"] and n["node_id"] != self.node_id_hex]
            if not targets:
                return 0
            r = await self.raylet.request(
                {"type": "broadcast_object", "object_id": oid_hex,
                 "targets": targets, "timeout": timeout}, timeout=timeout)
            if not r.get("ok"):
                raise RuntimeError(f"broadcast failed: {r.get('error')}")
            return len(targets)

        return self._run(_bcast(), timeout=timeout + 10)

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = False):
        ready, not_ready = self._run(
            self._wait_async(refs, num_returns, timeout))
        if fetch_local:
            # Reference wait(fetch_local=True): start pulling ready remote
            # objects to this node in the background, without blocking the
            # wait return (readiness itself stays metadata-only).
            def _log_pull_error(fut):
                if fut.exception() is not None:
                    logger.warning("fetch_local prefetch failed: %s",
                                   fut.exception())

            for r in ready:
                h = r.id.hex()
                entry = self.memory_store.get(h)
                if (entry is None or entry[0] == "plasma") and \
                        self.plasma is not None and \
                        not self.plasma.contains(r.id):
                    fut = asyncio.run_coroutine_threadsafe(
                        self._pull_to_local(h), self.loop)
                    fut.add_done_callback(_log_pull_error)
        return ready, not_ready

    async def _probe_ready(self, oid: ObjectID, owner: str):
        """Readiness check that never moves value bytes (reference: wait is
        metadata-only — round-1 version pulled whole objects to test
        readiness, dragging gigabytes across nodes).  Retries transient
        owner-poll failures forever; the caller bounds total time."""
        h = oid.hex()
        while True:
            entry = self.memory_store.get(h)
            if entry is not None:
                return  # val/err ready, or plasma -> produced somewhere
            if self.plasma is not None and self.plasma.contains(oid):
                return
            if owner and owner != self.address:
                try:
                    owner_conn = await self._get_worker_conn(owner)
                    # Client timeout exceeds the server's long-poll deadline
                    # so an idle poll round-trips cleanly instead of racing.
                    reply = await owner_conn.request(
                        {"type": "wait_object", "object_id": h,
                         "timeout": 300.0}, timeout=310)
                    if reply.get("ready"):
                        return
                except Exception:
                    await asyncio.sleep(0.5)
                continue
            ev = self.object_events.setdefault(h, asyncio.Event())
            await ev.wait()
            ev.clear()

    async def _wait_async(self, refs, num_returns, timeout):
        pending = {asyncio.ensure_future(
            self._probe_ready(r.id, r.owner_address), loop=self.loop): r
            for r in refs}
        ready: List[ObjectRef] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        while pending and len(ready) < num_returns:
            t = None if deadline is None else max(0, deadline - time.monotonic())
            done, _ = await asyncio.wait(pending.keys(), timeout=t,
                                         return_when=asyncio.FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                ref = pending.pop(fut)
                if fut.cancelled() or fut.exception() is not None:
                    continue  # probe failed -> ref stays not-ready
                ready.append(ref)
        for fut in pending:
            fut.cancel()
        ready_set = set(ready[:num_returns])
        ordered_ready = [r for r in refs if r in ready_set]
        not_ready = [r for r in refs if r not in ready_set]
        return ordered_ready, not_ready

    # ------------------------------------------------------------ functions

    def export_function(self, func) -> str:
        payload = cloudpickle.dumps(func)
        fid = hashlib.sha1(payload).hexdigest()
        if fid not in self._exported_functions:
            self._run(self.gcs.request({
                "type": "kv_put", "ns": "funcs", "key": fid.encode(),
                "value": payload, "overwrite": False}))
            self._exported_functions.add(fid)
        return fid

    async def load_function(self, fid: str):
        fn = self._function_cache.get(fid)
        if fn is None:
            payload = await self.gcs.request({"type": "kv_get", "ns": "funcs",
                                              "key": fid.encode()})
            if payload is None:
                raise RuntimeError(f"function {fid} not found in GCS")
            # Closure unpickling is unbounded user work — keep it off the
            # IO loop (the fetch is once per function id, then cached).
            fn = await _loads_off_loop(payload)
            self._function_cache[fid] = fn
        return fn

    # ------------------------------------------------------------ args

    def serialize_args(self, args: tuple, kwargs: dict):
        """Each arg becomes ("v", bytes) inline, or ("ref", hex, owner).

        Also returns the ObjectRefs that ride as refs: the submitter must
        hold them until the task completes, or an owner seeing its local
        count hit zero would eagerly free a value an in-flight task still
        needs (reference: ReferenceCounter submitted-task references,
        reference_count.h:61).  Large pass-by-value args are promoted to
        plasma objects; their temp ObjectRefs join the pin list so they are
        freed when the submission drops them (round-1 leaked these forever)."""
        if not args and not kwargs:
            # Zero-arg calls skip the pin scan and the pickled-ref
            # observer entirely (the context manager alone is ~5us, on a
            # path measured in tens of us).
            return [], {}, []
        pinned = [a for a in args if isinstance(a, ObjectRef)]
        pinned += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
        # Refs nested inside containers are collected during pickling and
        # pinned too — otherwise `f.remote([ref]); del ref` could free the
        # object before the executor registers its borrow.
        with object_ref_mod.observe_pickled_refs(pinned):
            out_args = [self._serialize_one(a, pinned) for a in args]
            out_kwargs = {k: self._serialize_one(v, pinned)
                          for k, v in kwargs.items()}
        return out_args, out_kwargs, pinned

    # Arg entry kinds on the wire:
    #   ("p", value)                     raw primitive, no serialization at
    #                                    all — rides the frame codec as-is
    #   ("nd", dtype, shape, bytes)      small C-contiguous ndarray
    #   ("v", bytes)                     RTP1-serialized inline value
    #   ("ref", hex, owner)              pass-by-reference
    # The raw kinds exist because the v2 frame codec (marshal / tagged)
    # carries primitives natively: pickling them into a ("v", ...) envelope
    # just to unpickle on the executor was the double-serialization the
    # n:n profile billed ~22µs/call for.
    _RAW_TYPES = frozenset((type(None), bool, int, float))

    def _serialize_one(self, value, pinned: list):
        t = type(value)
        if t in self._RAW_TYPES:
            return ("p", value)
        if t is str or t is bytes:
            if len(value) <= INLINE_MAX():
                return ("p", value)
        elif isinstance(value, ObjectRef):
            entry = self.memory_store.get(value.hex())
            if entry is not None:
                if entry[0] == "pval":
                    return ("p", entry[1])
                if entry[0] == "ndval":
                    return ("nd",) + tuple(entry[1])
                if entry[0] == "val" and len(entry[1]) <= INLINE_MAX():
                    return ("v", entry[1])
            return ("ref", value.hex(), value.owner_address)
        else:
            nd = self._serialize_ndarray(value, t)
            if nd is not None:
                return nd
        ser = self.ser.serialize(value)
        if ser.total_size <= INLINE_MAX() or self.plasma is None:
            return ("v", ser.to_bytes())
        oid = ObjectID.for_task_return(task_id_generator.next(), 0)
        self._run_on_loop_sync(self._put_serialized(oid, ser))
        # The temp ref holds one local count until the submitter releases
        # the pin list (task completion / actor death), then the normal
        # zero-count path frees the plasma copy.
        pinned.append(ObjectRef(oid, self.address))
        return ("ref", oid.hex(), self.address)

    @staticmethod
    def _serialize_ndarray(value, t):
        """("nd", dtype, shape, bytes) for a small plain ndarray, else
        None.  Exact np.ndarray only (subclasses may carry reducers), no
        object dtype, C-contiguous, and under the inline ceiling so the
        plasma-promotion path keeps large arrays."""
        np = sys.modules.get("numpy")
        if np is None or t is not np.ndarray:
            return None
        if (value.nbytes > INLINE_MAX() or value.dtype.hasobject
                or not value.flags.c_contiguous):
            return None
        return ("nd", value.dtype.str, value.shape, value.tobytes())

    @staticmethod
    def _rebuild_ndarray(entry):
        import numpy as np
        _, dtype, shape, data = entry
        # bytearray copy -> the rebuilt array is writable (matching what
        # the pickle lane hands user code) and independent of the frame
        # buffer the bytes may be a view over.
        return np.frombuffer(bytearray(data), dtype=dtype).reshape(
            tuple(shape))

    def _run_on_loop_sync(self, coro):
        if threading.get_ident() == self._loop_thread.ident:
            return asyncio.ensure_future(coro, loop=self.loop)
        return self._run(coro)

    def resolve_args_fast(self, args_entries, kwargs_entries):
        """Synchronous fast path: when no entry is an object ref, resolve
        without the async machinery (no gather, no wait_for task/timer) —
        the common case for small actor calls, and a measurable win on the
        calls/s hot path.  Returns None when an async fetch is needed."""
        try:
            args = [self._resolve_inline(e) for e in args_entries]
            kwargs = {k: self._resolve_inline(e)
                      for k, e in kwargs_entries.items()}
        except _NotInline:
            return None
        return args, kwargs

    def _resolve_inline(self, entry):
        kind = entry[0]
        if kind == "p":
            return entry[1]
        if kind == "v":
            return self.ser.deserialize(memoryview(entry[1]))
        if kind == "nd":
            return self._rebuild_ndarray(entry)
        raise _NotInline

    async def resolve_args(self, args_entries, kwargs_entries):
        async def one(entry):
            kind = entry[0]
            if kind == "p":
                return entry[1]
            if kind == "v":
                return self.ser.deserialize(memoryview(entry[1]))
            if kind == "nd":
                return self._rebuild_ndarray(entry)
            _, oid_hex, owner = entry
            data = await self._resolve_bytes(ObjectID.from_hex(oid_hex), owner)
            return await self._materialize_async(data)

        args = list(await asyncio.gather(*[one(e) for e in args_entries]))
        kwargs = {}
        for k, e in kwargs_entries.items():
            kwargs[k] = await one(e)
        return args, kwargs

    # ------------------------------------------------------------ tasks

    def submit_task(self, func, args, kwargs, *, num_returns=1,
                    resources=None, max_retries=None,
                    retry_exceptions=False, scheduling=None,
                    name=None) -> List[ObjectRef]:
        if max_retries is None:
            max_retries = DEFAULT_MAX_RETRIES()
        fid = self.export_function(func)
        task_id = task_id_generator.next()
        s_args, s_kwargs, pinned_args = self.serialize_args(args, kwargs)
        # num_returns="dynamic" (reference: generator tasks,
        # _raylet.pyx dynamic returns): the caller pre-owns only return 0
        # — an ObjectRefGenerator listing per-yield refs the executor
        # creates at indices 1..n; ownership of those registers when the
        # reply arrives (_store_task_returns).  "streaming" pre-owns the
        # same single ref but yields are adopted one at a time as
        # stream_yield RPCs land, consumable before the task finishes.
        n_pre = 1 if num_returns in ("dynamic", "streaming") else num_returns
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(n_pre)]
        refs = [ObjectRef(oid, self.address) for oid in return_ids]
        spec = {
            "task_id": task_id.hex(),
            "name": name or getattr(func, "__name__", "task"),
            "fid": fid,
            "args": s_args,
            "kwargs": s_kwargs,
            "num_returns": num_returns,
            "owner_address": self.address,
        }
        tracing = _tracing_mod()
        if tracing.enabled():
            # Propagate the caller's span so the executor's task span
            # joins this trace (reference tracing_helper.py:53).
            spec["trace"] = {"ctx": tracing.current_context()}
        scheduling = scheduling or {}
        resources = dict(resources or {"CPU": 1.0})
        # Ownership/lineage registration MUST precede scheduling the
        # submission: _store_task_returns drops results for unowned ids
        # (freed-while-running), and on a contended box the task can finish
        # before this thread runs again — registering late would lose the
        # result and hang the eventual get() forever.
        for oid in return_ids:
            self.owned.add(oid.hex())
            # Lineage: the producing task's spec, kept while we own the
            # object so a lost plasma copy can be re-executed (reference:
            # object_recovery_manager.h:41 + task_manager.h lineage pinning).
            # Pinned arg refs ride along so reconstruction can't race their
            # release.
            self._lineage[oid.hex()] = {
                "spec": spec, "resources": resources,
                "scheduling": scheduling, "return_ids": return_ids,
                "pins": pinned_args, "max_retries": max_retries,
            }
        # Cancellation registry (reference core_worker.cc CancelTask):
        # tracks the submission's asyncio task (pending-phase cancel) and
        # the executing worker's connection (running-phase interrupt).
        st = {"cancelled": False, "force": False, "worker_conn": None,
              "atask": None}
        self._cancel_state[task_id.hex()] = st
        for oid in return_ids:
            self._cancel_refs[oid.hex()] = task_id.hex()
        coro = self._submit_and_track(spec, resources, scheduling,
                                      max_retries, retry_exceptions,
                                      return_ids, pinned_args)
        tid_hex = task_id.hex()

        def _kick():
            t = asyncio.ensure_future(coro)
            st["atask"] = t

            def _done(fut):
                # A cancel delivered before the coroutine's FIRST step
                # skips the body (and its except-CancelledError handler)
                # entirely; only this callback can store the result then.
                # If the body ran, it swallowed the CancelledError, so
                # fut.cancelled() is False and nothing double-stores.
                if fut.cancelled():
                    self._store_cancelled(spec, return_ids)
                    self._cancel_state.pop(tid_hex, None)
                    for oid in return_ids:
                        self._cancel_refs.pop(oid.hex(), None)

            t.add_done_callback(_done)

        # Stream consumer state registers as late as possible — just
        # before the task can be scheduled — so nothing between acquire
        # and hand-off can throw and strand the entry; the hand-off
        # itself (loop already closed) unregisters on the way out.
        if num_returns == "streaming":
            self.register_stream(task_id.hex(), return_ids[0].hex())
        try:
            self.loop.call_soon_threadsafe(_kick)
        except BaseException:
            self._streams.pop(tid_hex, None)
            raise
        if num_returns == "streaming":
            return [object_ref_mod.StreamingObjectRefGenerator(
                task_id.hex(), refs[0])]
        return refs

    def cancel_task(self, ref, force: bool = False) -> bool:
        """Best-effort cancel of the task producing ``ref`` (reference
        python/ray/_private/worker.py cancel -> core_worker CancelTask).

        Normal tasks: pending submissions are dropped before execution;
        running ones get a KeyboardInterrupt on their execution thread
        (``force=True`` kills the worker process instead).  Actor calls:
        cancellable while queued / resolving args / awaiting an async
        method; a sync method already executing is not interruptible
        (and ``force`` raises, matching the reference).  Returns False
        when the ref is not an owned in-flight call's output."""
        tid = self._cancel_refs.get(ref.id.hex())
        if tid is None:
            lin = self._lineage.get(ref.id.hex())
            if lin is None:
                return False
            tid = lin["spec"]["task_id"]
        st = self._cancel_state.get(tid)
        if st is None:
            return False
        if "actor" in st:
            if force:
                raise ValueError(
                    "force=True is not supported for actor tasks "
                    "(use ray_tpu_torch.kill to destroy the actor)")

            def _do_actor():
                st["cancelled"] = True
                conn = self.actor_state.get(st["actor"], {}).get("conn")
                if conn is not None and not conn.closed:
                    spawn(conn.notify(
                        {"type": "cancel_task", "task_id": tid}),
                        name="notify-cancel-task", log=logger)

            self.loop.call_soon_threadsafe(_do_actor)
            return True

        def _do():
            st["cancelled"] = True
            st["force"] = force
            conn = st.get("worker_conn")
            if conn is not None and not conn.closed:
                spawn(conn.notify(
                    {"type": "cancel_task", "task_id": tid,
                     "force": force}),
                    name="notify-cancel-task", log=logger)
            else:
                t = st.get("atask")
                if t is not None:
                    t.cancel()

        self.loop.call_soon_threadsafe(_do)
        return True

    def _store_cancelled(self, spec, return_ids):
        """Resolve a cancelled call's returns with the pickle-free
        "cancel" store kind — just the message text; _materialize rebuilds
        the TaskCancelledError.  Cancel storms (gang teardown cancelling
        thousands of in-flight calls) then do zero serialization work on
        the IO loop."""
        msg = (f"task {spec.get('name', '?')} "
               f"({spec['task_id'][:8]}) was cancelled")
        for oid in return_ids:
            self._store_local(oid.hex(), "cancel", msg)

    async def _submit_and_track(self, spec, resources, scheduling, max_retries,
                                retry_exceptions, return_ids,
                                pinned_args=None):
        try:
            await self._submit_and_track_inner(
                spec, resources, scheduling, max_retries, retry_exceptions,
                return_ids)
        # rtlint: disable=cancellation-safety - this IS the cancel
        # protocol's terminus: cancel_task() cancelled this very task,
        # and the contract is to resolve the returns as cancelled, not to
        # propagate out of the fire-and-forget submission wrapper.
        except asyncio.CancelledError:
            # Pending-phase ray_tpu_torch.cancel(): the lease (if any) was
            # returned by _submit_once's finally on the way out.
            self._store_cancelled(spec, return_ids)
        finally:
            self._cancel_state.pop(spec["task_id"], None)
            for oid in return_ids:
                self._cancel_refs.pop(oid.hex(), None)

    async def _submit_and_track_inner(self, spec, resources, scheduling,
                                      max_retries, retry_exceptions,
                                      return_ids):
        cancel_st = self._cancel_state.get(spec["task_id"], {})
        attempts = max_retries + 1
        last_err: Optional[BaseException] = None
        attempt = 0
        # Encode-once: the push frame is serialized here and the encoded
        # body spliced verbatim into every (re)send across the whole
        # retry chain — the spec is never re-encoded per attempt.
        push_msg = wire.PreEncoded({"type": "push_task", "spec": spec})
        # System-level retriable failures (arg-resolution timeout releasing
        # a lease under a lost-object deadlock) get their OWN budget: the
        # function body never ran, so even max_retries=0 tasks are safe to
        # re-push — the user budget is for application failures.
        sys_budget = 10
        while attempt < attempts:
            if cancel_st.get("cancelled"):
                self._store_cancelled(spec, return_ids)
                return
            try:
                reply = await self._submit_once(spec, resources, scheduling,
                                                push_msg)
            except ConnectionLost:
                if cancel_st.get("cancelled"):
                    # force-cancel killed the worker: that's the requested
                    # outcome, not a crash to retry.
                    self._store_cancelled(spec, return_ids)
                    return
                last_err = rex.WorkerCrashedError(
                    f"worker died executing task {spec['name']}")
                attempt += 1
                continue
            except Exception as e:  # scheduling failure etc.
                last_err = e
                break
            if reply.get("ok"):
                self._store_task_returns(reply, return_ids)
                return
            if reply.get("cancelled"):
                for oid in return_ids:
                    self._store_local(oid.hex(), "err", reply["error"])
                return
            if reply.get("retriable") and sys_budget > 0:
                sys_budget -= 1
                # Back off so the producing/reconstruction task can claim
                # the freed CPU before we reoccupy it.
                await asyncio.sleep(min(2.0 * (10 - sys_budget), 10.0))
                continue       # does NOT consume a user attempt
            # Application error.
            if retry_exceptions and attempt < attempts - 1:
                last_err = None
                attempt += 1
                continue
            for oid in return_ids:
                self._store_local(oid.hex(), "err", reply["error"])
            return
        err = last_err or rex.WorkerCrashedError("task failed")
        payload = await _dumps_off_loop((err, ""))
        for oid in return_ids:
            self._store_local(oid.hex(), "err", payload)

    async def _get_nodes_cached(self) -> list:
        """GCS node view cached for one heartbeat period — SPREAD/affinity
        submissions must not pay a GCS round-trip per task (the view is
        ~0.5s stale either way; same rationale as the raylet-side cache)."""
        import time as _time
        now = _time.monotonic()
        ts, nodes = getattr(self, "_node_view_cache", (0.0, None))
        if nodes is None or now - ts > _rt_config().node_view_cache_s:
            nodes = await self.gcs.request({"type": "get_nodes"})
            self._node_view_cache = (now, nodes)
        return nodes

    async def _locality_raylet(self, spec):
        """Locality-aware lease target for the DEFAULT strategy (reference
        lease_policy.h LocalityAwareLeasePolicy): lease from the node
        holding the most of the task's plasma args — moving the task to
        gigabytes beats moving gigabytes to the task.  Returns an
        RpcConnection or None (meaning: use the local raylet)."""
        ref_ids = [e[1] for e in
                   list(spec.get("args", ())) +
                   list((spec.get("kwargs") or {}).values())
                   if isinstance(e, (list, tuple)) and e and e[0] == "ref"]
        if not ref_ids:
            return None
        # Short-TTL location cache: thousands of small-task submissions
        # must not serialize a GCS RPC each (reference answers this from
        # owner-local locality data with no per-task RPC).
        now = time.monotonic()
        cache = getattr(self, "_loc_cache", None)
        if cache is None:
            cache = self._loc_cache = {}
        missing = [r for r in ref_ids
                   if r not in cache or now - cache[r][0] > 1.0]
        if missing:
            try:
                fetched = await self.gcs.request(
                    {"type": "object_locations_get_many",
                     "object_ids": missing})
            except Exception:
                return None
            # Evict BEFORE inserting: clearing afterwards would wipe the
            # entries this very submission is about to tally.
            if len(cache) > 4096:
                cache.clear()
            for r in missing:
                cache[r] = (now, (fetched or {}).get(r))
        # Weigh holders by BYTES, not ref count: one 16GB array must
        # outvote three kilobyte-sized refs (lease_policy.h weighs by
        # object size for the same reason).
        tally: Dict[str, int] = {}
        for r in ref_ids:
            loc = cache.get(r, (0, None))[1]
            if not loc:
                continue
            weight = max(int(loc.get("size", 0)), 1)
            for nh in loc.get("nodes", []):
                tally[nh] = tally.get(nh, 0) + weight
        if not tally:
            return None
        best = max(tally, key=lambda nh: tally[nh])
        if best == self.node_id_hex or \
                tally[best] <= tally.get(self.node_id_hex or "", 0):
            return None
        nodes = await self._get_nodes_cached()
        target = next((n for n in nodes
                       if n["node_id"] == best and n["alive"]), None)
        if target is None:
            return None
        return await self._get_worker_conn(target["address"])

    async def _lease_request(self, conn, lease_msg: dict) -> dict:
        """Cancellation-safe lease request.

        A pending-phase ray_tpu_torch.cancel() cancels the submission coroutine
        while this request is in flight — but the raylet may already have
        granted (or be about to grant) the lease, and dropping that reply
        would leak the worker as busy forever.  Shield the request and, on
        cancellation, attach a callback that returns any late grant."""
        req = asyncio.ensure_future(conn.request(
            lease_msg, timeout=_rt_config().lease_request_timeout_s))
        try:
            return await asyncio.shield(req)
        except asyncio.CancelledError:
            def _return_late_grant(fut):
                if fut.cancelled() or fut.exception() is not None:
                    return
                g = fut.result()
                if isinstance(g, dict) and "lease_id" in g:
                    spawn(conn.request({
                        "type": "return_lease",
                        "lease_id": g["lease_id"],
                        "worker_id": g["worker_id"],
                        "resources": g["resources"],
                        "pg_id": g.get("pg_id"),
                        "bundle_index": g.get("bundle_index", 0),
                        "worker_reusable": True,
                    }))

            req.add_done_callback(_return_late_grant)
            raise

    async def _submit_once(self, spec, resources, scheduling,
                           push_msg=None) -> dict:
        logger.debug("task %s %s: leasing", spec["task_id"][:8],
                     spec["name"])
        raylet = self.raylet
        lease_msg = {"type": "lease_worker", "resources": resources,
                     "job_id": self.job_id}
        if scheduling.get("runtime_env"):
            lease_msg["runtime_env"] = scheduling["runtime_env"]
            lease_msg["env_key"] = scheduling.get("env_key", "")
        if scheduling.get("node_id"):
            # NodeAffinitySchedulingStrategy (reference
            # scheduling_strategies.py:41): lease from that node's raylet;
            # hard affinity fails if the node is gone, soft falls back to
            # the local raylet.
            nodes = await self._get_nodes_cached()
            target = next((n for n in nodes
                           if n["node_id"] == scheduling["node_id"] and
                           n["alive"]), None)
            if target is not None:
                raylet = await self._get_worker_conn(target["address"])
                lease_msg["no_spill"] = not scheduling.get("soft", False)
            elif not scheduling.get("soft", False):
                raise rex.SchedulingError(
                    f"node {scheduling['node_id'][:16]} required by "
                    f"NodeAffinity is not alive")
        elif scheduling.get("strategy") == "SPREAD":
            # SPREAD (reference spread_scheduling_policy.h): round-robin
            # over alive nodes whose capacity fits the request.
            nodes = [n for n in await self._get_nodes_cached()
                     if n["alive"] and all(
                         n["resources_total"].get(k, 0.0) >= v
                         for k, v in resources.items() if v > 0)]
            if nodes:
                self._spread_idx = getattr(self, "_spread_idx", 0) + 1
                target = nodes[self._spread_idx % len(nodes)]
                raylet = await self._get_worker_conn(target["address"])
        elif not scheduling.get("placement_group_id"):
            # DEFAULT strategy: data locality (spillback still applies if
            # the arg-holding node is saturated).
            locality = await self._locality_raylet(spec)
            if locality is not None:
                raylet = locality
        if scheduling.get("placement_group_id"):
            lease_msg["pg_id"] = scheduling["placement_group_id"]
            lease_msg["bundle_index"] = scheduling.get("bundle_index", 0) or 0
            # Placement-group tasks must run on the bundle's node.
            pg = await self.gcs.request({"type": "get_placement_group",
                                         "pg_id": lease_msg["pg_id"]})
            if pg is None:
                raise rex.PlacementGroupUnavailableError(
                    f"placement group {lease_msg['pg_id'][:16]} not found")
            target_node = pg["allocations"].get(lease_msg["bundle_index"]) or \
                pg["allocations"].get(str(lease_msg["bundle_index"]))
            if target_node is not None:
                nodes = await self.gcs.request({"type": "get_nodes"})
                for n in nodes:
                    if n["node_id"] == target_node:
                        raylet = await self._get_worker_conn(n["address"])
                        break
        grant = await self._lease_request(raylet, lease_msg)
        grant_conn = raylet   # the raylet that actually granted the lease
        visited = []
        max_hops = _rt_config().max_spillback_hops
        for _ in range(max_hops):
            if "spillback" not in grant:
                break
            visited.append(grant["spillback"])
            lease_msg["exclude"] = visited
            spill_conn = await self._get_worker_conn(grant["spillback"])
            if len(visited) == max_hops:
                # Hop budget exhausted (stale availability views chasing a
                # saturated cluster): stop spilling and QUEUE at the final
                # node — transient saturation must wait, not fail.
                lease_msg["no_spill"] = True
            grant = await self._lease_request(spill_conn, lease_msg)
            grant_conn = spill_conn
        if "spillback" in grant:
            raise RuntimeError("lease spillback loop did not converge")
        worker_conn = await self._get_worker_conn(grant["worker_address"])
        # Leases MUST return to their granting raylet: returning to the
        # original one after a spillback would free resources that were
        # never taken there and leak them on the grantor.
        lease_raylet = grant_conn
        crashed = False
        cancel_st = self._cancel_state.get(spec["task_id"])
        reusable = True
        try:
            if cancel_st is not None:
                if cancel_st.get("cancelled"):
                    # Cancelled while leasing: don't start execution.  The
                    # raise MUST sit inside this try so the finally below
                    # returns the untouched lease.
                    raise asyncio.CancelledError()
                cancel_st["worker_conn"] = worker_conn
            logger.debug("task %s: pushing to %s", spec["task_id"][:8],
                         grant["worker_address"])
            reply = await worker_conn.request(
                push_msg if push_msg is not None
                else {"type": "push_task", "spec": spec}, timeout=None)
            logger.debug("task %s: reply ok=%s", spec["task_id"][:8],
                         reply.get("ok"))
            # Never reuse a worker a cancel was aimed at — even if the
            # task outran the injected KeyboardInterrupt and replied ok,
            # the interrupt may still be pending on its exec thread and
            # would hit (or kill the thread under) the next task.
            reusable = not (reply.get("cancelled", False) or
                            (cancel_st is not None and
                             cancel_st.get("cancelled")))
            return reply
        except ConnectionLost:
            crashed = True
            raise
        finally:
            try:
                await lease_raylet.request({
                    "type": "return_lease",
                    "lease_id": grant["lease_id"],
                    "worker_id": grant["worker_id"],
                    "resources": grant["resources"],
                    "pg_id": grant.get("pg_id"),
                    "bundle_index": grant.get("bundle_index", 0),
                    "worker_reusable": (not crashed) and reusable,
                })
            except Exception:
                pass

    def _store_task_returns(self, reply: dict, return_ids):
        # Fully synchronous on purpose: the batch-reply path runs it from a
        # future done-callback, where no task exists to await anything.
        entries = reply["returns"]
        # Dynamic-return extras (generator tasks): entries beyond the
        # pre-registered ids are per-yield objects the executor created;
        # the caller becomes their owner NOW, before the generator ref
        # (entry 0) is readable, so a get() of a yielded ref can never
        # observe an unowned id.  (No lineage entry: reconstruction of a
        # dynamic yield would re-run the whole generator — documented gap
        # vs the reference's lineage for dynamic returns.)
        if entries[len(return_ids):] and return_ids \
                and return_ids[0].hex() not in self.owned:
            # Caller freed the generator ref before the reply arrived:
            # adopting the per-yield extras now would leave them owned
            # with no reachable ref.  Drop them — and free their backing
            # copies: each non-inline extra has a plasma copy on the
            # executor's node plus a GCS directory entry that nothing
            # will ever release otherwise (same fan-out _free_object
            # uses; the GCS forwards the free to every holder raylet).
            for oid_hex, kind, _data in entries[len(return_ids):]:
                if kind not in ("inline", "pval", "ndval"):
                    spawn(
                        self.gcs.notify({"type": "object_freed",
                                         "object_id": oid_hex}),
                        loop=self.loop)
            entries = entries[:len(return_ids)]
        for oid_hex, kind, data in entries[len(return_ids):]:
            self.owned.add(oid_hex)
            self._store_return_entry(oid_hex, kind, data)
        for (oid_hex, kind, data), oid in zip(entries, return_ids):
            if oid_hex not in self.owned:
                continue  # freed while the task (or a reconstruction) ran
            self._store_return_entry(oid_hex, kind, data)

    def _store_return_entry(self, oid_hex: str, kind: str, data):
        if kind == "inline":
            self._store_local(oid_hex, "val", data)
        elif kind == "pval" or kind == "ndval":  # raw fast-lane value
            self._store_local(oid_hex, kind, data)
        else:  # plasma, located on executor's node (directory has it)
            self._store_local(oid_hex, "plasma", None)

    # ------------------------------------------------------------ actors

    def _build_create_actor_request(self, cls, args, kwargs, *,
                                    resources=None, max_restarts=0,
                                    name=None, namespace="default",
                                    get_if_exists=False, detached=False,
                                    max_concurrency=1, scheduling=None,
                                    concurrency_groups=None,
                                    method_meta=None):
        s_args, s_kwargs, pinned_args = self.serialize_args(args, kwargs)
        creation_spec = cloudpickle.dumps({
            "cls": cloudpickle.dumps(cls),
            "args": s_args,
            "kwargs": s_kwargs,
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups or {}),
            "name": name,
        })
        return {
            "type": "create_actor",
            "actor_id": ActorID.from_random().hex(),
            "name": name,
            "namespace": namespace,
            "creation_spec": creation_spec,
            "resources": dict(resources or {"CPU": 1.0}),
            "max_restarts": max_restarts,
            "job_id": self.job_id,
            "detached": detached,
            "get_if_exists": get_if_exists,
            "scheduling": scheduling or {},
            "method_meta": dict(method_meta or {}),
        }, pinned_args

    async def create_actor_async(self, cls, args, kwargs, **opts) -> str:
        """Loop-thread-safe actor creation (async actor methods that call
        .remote() would deadlock on the blocking path's _run).

        Spec building cloudpickles the actor class — unbounded work
        (imports, closures) — so it runs on the executor, not the loop."""
        req, pinned_args = await asyncio.get_running_loop().run_in_executor(
            None, lambda: self._build_create_actor_request(
                cls, args, kwargs, **opts))
        reply = await self.gcs.request(req)
        self._pin_actor_creation(reply["actor_id"], pinned_args)
        return reply["actor_id"]

    def _pin_actor_creation(self, actor_id_hex: str, pinned_args):
        if pinned_args:
            # Creation args stay pinned for the actor's lifetime: the GCS
            # may replay the creation spec on restart at any point.
            if not hasattr(self, "_actor_creation_pins"):
                self._actor_creation_pins = {}
            self._actor_creation_pins[actor_id_hex] = pinned_args

    def create_actor(self, cls, args, kwargs, *, resources=None,
                     max_restarts=0, name=None, namespace="default",
                     get_if_exists=False, detached=False, max_concurrency=1,
                     concurrency_groups=None, scheduling=None,
                     method_meta=None) -> str:
        req, pinned_args = self._build_create_actor_request(
            cls, args, kwargs, resources=resources,
            max_restarts=max_restarts, name=name, namespace=namespace,
            get_if_exists=get_if_exists, detached=detached,
            max_concurrency=max_concurrency, scheduling=scheduling,
            concurrency_groups=concurrency_groups, method_meta=method_meta)
        reply = self._run(self.gcs.request(req))
        self._pin_actor_creation(reply["actor_id"], pinned_args)
        return reply["actor_id"]

    def _actor(self, actor_id_hex: str) -> dict:
        st = self.actor_state.get(actor_id_hex)
        if st is None:
            st = {"address": None, "conn": None, "seq": 0,
                  "lock": asyncio.Lock(), "inflight": {},
                  "pending_calls": 0, "kill_on_drain": False}
            self.actor_state[actor_id_hex] = st
        return st

    def submit_actor_task(self, actor_id_hex: str, method: str, args, kwargs,
                          *, num_returns=1,
                          concurrency_group=None) -> List[ObjectRef]:
        task_id = task_id_generator.next()
        s_args, s_kwargs, pinned_args = self.serialize_args(args, kwargs)
        n_pre = 1 if num_returns in ("dynamic", "streaming") else num_returns
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(n_pre)]
        refs = [ObjectRef(oid, self.address) for oid in return_ids]
        for oid in return_ids:
            self.owned.add(oid.hex())
        call = {
            "type": "actor_call",
            "call_id": task_id.hex(),
            "method": method,
            "args": s_args,
            "kwargs": s_kwargs,
            "num_returns": num_returns,
            "owner_address": self.address,
        }
        if concurrency_group is not None:
            call["concurrency_group"] = concurrency_group
        tracing = _tracing_mod()
        if tracing.enabled():
            call["trace"] = {"ctx": tracing.current_context()}
        cst = {"cancelled": False, "actor": actor_id_hex}
        self._cancel_state[task_id.hex()] = cst
        for oid in return_ids:
            self._cancel_refs[oid.hex()] = task_id.hex()
        # Coalesced hand-off: submissions queue on the caller thread and a
        # single call_soon_threadsafe per burst flushes them — one loop
        # wakeup (one self-pipe syscall) and one task per (actor, burst)
        # instead of per call.  Same-tick calls to one actor then ride a
        # single _BATCH frame (reference analog: direct actor transport
        # batching, src/ray/core_worker/transport/direct_actor_transport.cc).
        # Stream state registers immediately before the queue hand-off
        # (an already-scheduled flush may pick the entry up the moment it
        # is appended); a failed hand-off unregisters on the way out so
        # the owner's stream map can't grow a stranded entry.
        if num_returns == "streaming":
            self.register_stream(task_id.hex(), return_ids[0].hex())
        try:
            with self._submit_lock:
                self._submit_queue.append(
                    (actor_id_hex, call, return_ids, pinned_args))
                wake = not self._submit_scheduled
                self._submit_scheduled = True
            if wake:
                self.loop.call_soon_threadsafe(self._flush_submits)
        except BaseException:
            self._streams.pop(task_id.hex(), None)
            raise
        if num_returns == "streaming":
            return [object_ref_mod.StreamingObjectRefGenerator(
                task_id.hex(), refs[0])]
        return refs

    def _flush_submits(self):
        """Loop-side: drain the submit queue, one task per actor group."""
        with self._submit_lock:
            batch, self._submit_queue = self._submit_queue, []
            self._submit_scheduled = False
        groups: Dict[str, list] = {}
        for entry in batch:
            groups.setdefault(entry[0], []).append(entry)
        for actor_id_hex, entries in groups.items():
            spawn(self._submit_actor_group(actor_id_hex, entries),
                  name="submit-actor-group", log=logger)

    async def _submit_actor_group(self, actor_id_hex: str, entries: list):
        """Send a burst of same-actor calls as one _BATCH frame.

        Replies resolve per call via done-callbacks (no per-call task);
        rare outcomes (retriable reply, connection loss) fall back to the
        per-call `_submit_actor_call` slow path with batch-side accounting.
        """
        st = self._actor(actor_id_hex)
        st["pending_calls"] += len(entries)
        try:
            conn = await self._actor_conn(actor_id_hex, st)
        except Exception as e:  # noqa: BLE001 - actor dead/unknown
            err = (e if isinstance(e, rex.ActorDiedError)
                   else rex.ActorDiedError(str(e)))
            payload = await _dumps_off_loop((err, ""))
            for _, call, return_ids, _pin in entries:
                for oid in return_ids:
                    self._store_local(oid.hex(), "err", payload)
                self._finish_actor_entry(st, actor_id_hex, call, return_ids)
            return
        msgs, metas = [], []
        for _, call, return_ids, pinned in entries:
            cst = self._cancel_state.get(call["call_id"])
            if cst is not None and cst.get("cancelled"):
                self._store_cancelled(
                    {"name": call["method"], "task_id": call["call_id"]},
                    return_ids)
                self._finish_actor_entry(st, actor_id_hex, call, return_ids)
                continue
            # seq is assigned in place: the call dict is built per
            # submission and owned by this submit path, so the copy the
            # old code made per send was pure overhead.  A fallback
            # resend overwrites it with a fresh seq.
            call["seq"] = st["seq"]
            st["seq"] += 1
            msgs.append(call)
            metas.append((call, return_ids, pinned))
        if not msgs:
            return
        try:
            futs = conn.request_batch(msgs)
        except Exception:   # connection died between dial and send
            for call, return_ids, pin in metas:
                spawn(self._group_fallback(
                    st, actor_id_hex, call, return_ids, pinned=pin),
                    name="actor-group-fallback", log=logger)
            return
        for fut, meta in zip(futs, metas):
            fut.add_done_callback(functools.partial(
                self._on_actor_reply, st, actor_id_hex, meta))
        await conn.maybe_drain()   # backpressure: bound the send buffer

    def _on_actor_reply(self, st, actor_id_hex, meta, fut):
        """Future done-callback on the IO loop: terminal outcomes store
        synchronously; non-terminal ones re-enter the slow path."""
        call, return_ids, pinned = meta
        try:
            reply = fut.result()
        # rtlint: disable=cancellation-safety - reply-future reap, not a
        # coroutine cancel: the protocol layer cancels pending reply
        # futures on connection teardown, so CancelledError here means
        # "connection died" unless the owner itself cancelled the call —
        # which the flag check below resolves as cancelled.
        except (ConnectionLost, asyncio.CancelledError):
            st["conn"] = None
            st["address"] = None
            cst = self._cancel_state.get(call["call_id"])
            if cst is not None and cst.get("cancelled"):
                # The owner cancelled this call (force-cancel tears the
                # connection down); re-driving it through the fallback
                # would resurrect a cancelled call on the restarted actor.
                self._store_cancelled(
                    {"name": call["method"], "task_id": call["call_id"]},
                    return_ids)
                self._finish_actor_entry(st, actor_id_hex, call, return_ids)
                return
            spawn(self._group_fallback(
                st, actor_id_hex, call, return_ids, pinned=pinned),
                name="actor-group-fallback", log=logger)
            return
        except Exception as e:  # noqa: BLE001
            payload = cloudpickle.dumps((e, traceback.format_exc()))
            for oid in return_ids:
                self._store_local(oid.hex(), "err", payload)
            self._finish_actor_entry(st, actor_id_hex, call, return_ids)
            return
        if reply.get("retriable"):
            spawn(self._group_fallback(
                st, actor_id_hex, call, return_ids, retriable=True,
                pinned=pinned),
                name="actor-group-fallback", log=logger)
            return
        if reply.get("ok"):
            self._store_task_returns(reply, return_ids)
        else:
            for oid in return_ids:
                self._store_local(oid.hex(), "err", reply["error"])
        self._finish_actor_entry(st, actor_id_hex, call, return_ids)

    async def _group_fallback(self, st, actor_id_hex, call, return_ids,
                              retriable=False, pinned=None):
        """Batch-path escape hatch: re-drive one call through the per-call
        submit loop (fresh seq; its own retry budget).  _retry=1 keeps the
        per-call path from double-counting pending_calls/cancel state —
        this wrapper owns the batch-side accounting.  ``pinned`` is held
        in this frame so ObjectRef args stay alive across the retry (the
        batch meta tuple that pinned them dies with its done-callback)."""
        try:
            if retriable:
                await asyncio.sleep(2.0)   # mirror the per-call backoff
            await self._submit_actor_call(actor_id_hex, call, return_ids,
                                          _retry=1)
        finally:
            self._finish_actor_entry(st, actor_id_hex, call, return_ids)

    def _finish_actor_entry(self, st, actor_id_hex, call, return_ids):
        self._cancel_state.pop(call["call_id"], None)
        for oid in return_ids:
            self._cancel_refs.pop(oid.hex(), None)
        st["pending_calls"] -= 1
        if st["kill_on_drain"] and st["pending_calls"] == 0:
            st["kill_on_drain"] = False
            spawn(self.gcs.notify(
                {"type": "kill_actor", "actor_id": actor_id_hex,
                 "no_restart": True}),
                name="notify-kill-actor", log=logger)

    async def _submit_actor_call(self, actor_id_hex, call, return_ids,
                                 _retry: int = 0, pinned_args=None):
        st = self._actor(actor_id_hex)
        if _retry == 0:
            st["pending_calls"] += 1
        try:
            await self._submit_actor_call_inner(actor_id_hex, st, call,
                                                return_ids, _retry)
        finally:
            if _retry == 0:
                self._finish_actor_entry(st, actor_id_hex, call, return_ids)

    async def _submit_actor_call_inner(self, actor_id_hex, st, call,
                                       return_ids, _retry):
        try:
            logger.debug("actor call %s.%s: resolving conn",
                         actor_id_hex[:8], call["method"])
            # System-retriable replies (arg-resolution timeout under a
            # lost-object deadlock) resend with a fresh seq and their own
            # bounded budget — the method body never ran.
            for sys_attempt in range(11):
                conn = await self._actor_conn(actor_id_hex, st)
                # A cancel that raced connection establishment couldn't
                # notify anyone — honor its flag before the call is ever
                # delivered.
                cst = self._cancel_state.get(call["call_id"])
                if cst is not None and cst.get("cancelled"):
                    self._store_cancelled(
                        {"name": call["method"],
                         "task_id": call["call_id"]}, return_ids)
                    return
                call["seq"] = st["seq"]
                st["seq"] += 1
                logger.debug("actor call %s.%s seq=%s: sending",
                             actor_id_hex[:8], call["method"], call["seq"])
                reply = await conn.request(call, timeout=None)
                logger.debug("actor call %s.%s seq=%s: reply ok=%s",
                             actor_id_hex[:8], call["method"], call["seq"],
                             reply.get("ok"))
                if reply.get("retriable") and sys_attempt < 10:
                    await asyncio.sleep(min(2.0 * (sys_attempt + 1), 10.0))
                    continue
                break
            if reply.get("ok"):
                self._store_task_returns(reply, return_ids)
            else:
                for oid in return_ids:
                    self._store_local(oid.hex(), "err", reply["error"])
        # rtlint: disable=cancellation-safety - reply futures are
        # cancelled on connection teardown, so CancelledError here is a
        # transport signal, not a coroutine cancel; an owner-initiated
        # cancel is honored via the flag check below instead of being
        # re-driven through the retry path.
        except (ConnectionLost, asyncio.CancelledError):
            st["conn"] = None
            st["address"] = None
            cst = self._cancel_state.get(call["call_id"])
            if cst is not None and cst.get("cancelled"):
                # Force-cancel killed the worker mid-call: that is the
                # requested outcome — retrying against the restarted
                # actor would resurrect the cancelled call.
                self._store_cancelled(
                    {"name": call["method"], "task_id": call["call_id"]},
                    return_ids)
                return
            info = await self.gcs.request({"type": "wait_actor_state",
                                           "actor_id": actor_id_hex})
            if info is not None and info["state"] == "ALIVE" and _retry < 3:
                await self._submit_actor_call(actor_id_hex, call, return_ids,
                                              _retry + 1)
                return
            cause = (info or {}).get("death_cause", "actor connection lost")
            payload = await _dumps_off_loop(
                (rex.ActorDiedError(f"actor {actor_id_hex[:12]} died: {cause}"),
                 ""))
            for oid in return_ids:
                self._store_local(oid.hex(), "err", payload)
        except Exception as e:
            payload = await _serialize_exception_async(e)
            for oid in return_ids:
                self._store_local(oid.hex(), "err", payload)

    def _on_actor_event(self, data: dict) -> None:
        """Pubsub callback (executor pool): fence stale actor connections.

        A restarted actor gets a NEW address while the cached connection
        to its previous incarnation may still be open — a partitioned
        node keeps its worker processes alive, so ``conn.closed`` alone
        cannot detect the zombie.  Any restart/death event, or an alive
        event whose address differs from the cached one, drops the
        cached conn; the next call re-resolves through the GCS record."""
        actor = (data or {}).get("actor") or {}
        aid = actor.get("actor_id")
        st = self.actor_state.get(aid)
        if st is None:
            return
        event = (data or {}).get("event")
        stale = (event in ("restarting", "dead")
                 or (event == "alive" and st["address"] is not None
                     and actor.get("address") != st["address"]))
        if stale:
            asyncio.run_coroutine_threadsafe(
                self._invalidate_actor_conn(aid, event), self.loop)

    async def _invalidate_actor_conn(self, actor_id_hex: str, why: str):
        st = self.actor_state.get(actor_id_hex)
        if st is None:
            return
        conn, st["conn"], st["address"] = st["conn"], None, None
        if conn is not None and not conn.closed:
            logger.info("actor %s %s: dropping cached connection",
                        actor_id_hex[:12], why)
            # Closing fails this conn's in-flight calls with
            # ConnectionLost; they re-resolve via the fallback path.
            await conn.close()

    async def _actor_conn(self, actor_id_hex: str, st: dict) -> RpcConnection:
        # Lock-free fast path: the connection exists for every call after
        # the first, and the IO loop is single-threaded, so a plain read is
        # safe — the lock only guards concurrent dials below.
        conn = st["conn"]
        if conn is not None and not conn.closed:
            return conn
        async with st["lock"]:
            if st["conn"] is not None and not st["conn"].closed:
                return st["conn"]
            if not self._actor_events_subscribed:
                # Arm restart fencing before the first dial so an actor
                # that restarts later invalidates this cache (replayed
                # across GCS reconnects by _on_gcs_reconnect).
                self._actor_events_subscribed = True
                self._subscriptions.setdefault("actors", []).insert(
                    0, self._on_actor_event)
                try:
                    await self.gcs.request({"type": "subscribe",
                                            "channel": "actors"})
                except Exception:
                    logger.warning("actor-events subscription failed; "
                                   "restart fencing degraded",
                                   exc_info=True)
            info = await self.gcs.request({"type": "wait_actor_state",
                                           "actor_id": actor_id_hex})
            if info is None:
                raise rex.ActorDiedError(f"unknown actor {actor_id_hex[:12]}")
            if info["state"] == "DEAD":
                raise rex.ActorDiedError(
                    f"actor {actor_id_hex[:12]} is dead: {info.get('death_cause')}")
            st["address"] = info["address"]
            st["conn"] = await connect(info["address"], self._handle_push,
                                       name=f"cw->actor-{actor_id_hex[:8]}")
            st["seq"] = 0
            return st["conn"]

    def kill_actor(self, actor_id_hex: str, no_restart: bool = True):
        self._run(self.gcs.request({"type": "kill_actor",
                                    "actor_id": actor_id_hex,
                                    "no_restart": no_restart}))

    def kill_actor_nowait(self, actor_id_hex: str):
        """Fire-and-forget kill for handle GC: __del__ can run on ANY
        thread — including the IO loop thread — so it must never block on
        the loop (a synchronous kill_actor from the loop thread deadlocks
        the whole runtime).  Calls already submitted still complete: with
        calls in flight the kill is deferred until they drain (reference:
        out-of-scope termination waits for pending actor tasks)."""
        async def _kill_when_drained():
            st = self._actor(actor_id_hex)
            if st["pending_calls"] > 0:
                st["kill_on_drain"] = True
                return
            await self.gcs.notify({"type": "kill_actor",
                                   "actor_id": actor_id_hex,
                                   "no_restart": True})

        asyncio.run_coroutine_threadsafe(_kill_when_drained(), self.loop)

    def get_actor_info(self, actor_id_hex: str):
        return self._run(self.gcs.request({"type": "get_actor_info",
                                           "actor_id": actor_id_hex}))

    def get_named_actor(self, name: str, namespace: str = "default"):
        return self._run(self.gcs.request({"type": "get_named_actor",
                                           "name": name,
                                           "namespace": namespace}))

    # ------------------------------------------------------------ misc

    async def _get_worker_conn(self, addr: str) -> RpcConnection:
        conn = self._worker_conns.get(addr)
        if conn is None or conn.closed:
            conn = await connect(addr, self._handle_push, name=f"cw->{addr}")
            self._worker_conns[addr] = conn
        return conn

    def gcs_request(self, msg: dict, timeout: Optional[float] = None):
        return self._run(self.gcs.request(msg), timeout)

    def as_future(self, ref: ObjectRef):
        return asyncio.run_coroutine_threadsafe(self.get_async(ref), self.loop)

    # -- executor-side helpers (used by worker_main's TaskExecutor) --

    def pack_return_sync(self, h: str, value):
        """Pack one task return without awaiting: (entry, None) for the
        pval / ndval / inline kinds, or (None, ser) when the value is
        plasma-bound and the caller must take the async path.  Split out
        of store_return_value_async so the zero-task actor-call reply
        path (TaskExecutor.fast_actor_call) can pack common returns from
        a plain done-callback.  Takes the object id's hex form directly:
        the fast path derives it by string surgery on the call id rather
        than materialising TaskID/ObjectID pairs per call."""
        t = type(value)
        if t in self._RAW_TYPES or (
                (t is str or t is bytes) and len(value) <= INLINE_MAX()):
            return (h, "pval", value), None
        nd = self._serialize_ndarray(value, t)
        if nd is not None:
            return (h, "ndval", nd[1:]), None
        ser = self.ser.serialize(value)
        if ser.total_size <= INLINE_MAX() or self.plasma is None:
            return (h, "inline", ser.to_bytes()), None
        return None, ser

    async def store_return_value_async(self, oid: ObjectID, value
                                       ) -> Tuple[str, str, Any]:
        """Serialize + store one task return; returns the reply entry
        (hex, kind, data).  kind "pval" carries a raw primitive straight
        into the reply frame (zero-pickle fast lane: the v2 codec encodes
        it natively, and the owner stores the value itself — no RTP1
        envelope on either side).

        The GCS location registration is AWAITED before the entry (and thus
        the task reply) is released: a fire-and-forget add lets the owner
        observe readiness before the directory knows the location, so an
        immediate raylet pull (wait fetch_local, remote gets) finds 'no
        locations' for an object that exists."""
        h = oid.hex()
        entry, ser = self.pack_return_sync(h, value)
        if entry is not None:
            return entry
        await self._plasma_put(oid, ser)
        await self.gcs.request({
            "type": "object_location_add", "object_id": h,
            "node_id": self.node_id_hex, "owner": "",
            "size": ser.total_size,
            "checksum": crc32_segments(ser.segments)
            if _rt_config().transfer_checksum else None})
        return (h, "plasma", None)

"""Worker process entry point + task/actor executor.

Design analog: reference ``python/ray/_private/workers/default_worker.py`` +
the Cython execution loop ``_raylet.pyx execute_task:700`` and the
execution-side scheduling queues in ``src/ray/core_worker/transport/``
(NormalSchedulingQueue, ActorSchedulingQueue with sequence numbers,
ConcurrencyGroupManager for async actors).

Execution model:
  * normal tasks and sync actor methods run serially on the dedicated
    execution thread (actor serial semantics);
  * async (coroutine) actor methods run on the IO loop, bounded by a
    max_concurrency semaphore -- the analog of the reference's fiber-based
    async actors (fiber.h).
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import logging
import os
import sys
import time
import traceback

from ray_tpu_torch._private import cloudpickle

from ray_tpu_torch._private.async_utils import spawn
from ray_tpu_torch._private.core_worker import CoreWorker, _serialize_exception
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.protocol import connect

logger = logging.getLogger(__name__)

# Actor class bodies keyed by the sha1 of their cloudpickle blob: a worker
# that hosts successive actors of one class (restart churn, pooled reuse)
# deserializes the class definition once — re-running cloudpickle.loads
# per creation re-executes the class body every time (reference analog:
# the function/actor-class import cache in function_manager.py).
_ACTOR_CLS_CACHE: dict = {}


class TaskExecutor:
    def __init__(self, core: CoreWorker):
        self.core = core
        self.actor_instance = None
        self.actor_id = None
        # method name -> (bound method, is_coroutine, default concurrency
        # group): getattr + inspect.iscoroutinefunction cost ~11µs/call
        # on the actor hot path and never change for a live instance.
        self._method_cache: dict = {}
        self.max_concurrency = 1
        self._sem: asyncio.Semaphore = None
        self._exit_requested = False
        self._order: dict = {}
        self._current_task_id: str = None
        self._task_handle = None
        self._exec_started = False
        # actor-call cancellation registry: call_id -> asyncio task;
        # _sync_started marks bodies the exec THREAD has actually entered
        # (a call parked in the pool queue is still cancellable).
        self._actor_call_tasks: dict = {}
        self._sync_started: set = set()
        # call_ids currently in the streaming-yield phase: the user body
        # is parked at a yield (not mutating actor state mid-statement),
        # so cancel may interrupt even though the sync body "started".
        self._streaming_calls: set = set()

    def _cancel_task(self, msg: dict) -> dict:
        """Best-effort in-flight cancel (reference core_worker.cc
        CancelTask -> KillActor/interrupt semantics for normal tasks).

        force=True exits the process (the owner observes WorkerCrashed-
        style death and maps it to TaskCancelledError); otherwise a
        KeyboardInterrupt is injected into the execution thread.  The
        injection is asynchronous-best-effort: a task that finishes in
        the same instant can escape it, and C-level blocking calls only
        see it on return to bytecode — same caveats as the reference.
        """
        tid = msg.get("task_id")
        # actor calls: cancellable unless the sync body already runs
        t = self._actor_call_tasks.get(tid)
        if t is not None:
            if tid in self._sync_started and tid not in self._streaming_calls:
                return {"ok": True, "not_cancellable": True}
            t.cancel()
            return {"ok": True}
        if self._current_task_id != tid:
            return {"ok": True, "not_running": True}
        if msg.get("force"):
            os._exit(1)
        if not self._exec_started:
            # Still loading/resolving args on the IO loop (can block for
            # minutes on a pending upstream object): cancel the asyncio
            # task — there is nothing on the exec thread to interrupt yet.
            if self._task_handle is not None:
                self._task_handle.cancel()
            return {"ok": True}
        import ctypes
        for t in list(self.core.exec_pool._threads):
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(t.ident),
                ctypes.py_object(KeyboardInterrupt))
        return {"ok": True}

    async def handle(self, conn, msg: dict):
        mtype = msg["type"]
        if mtype == "push_task":
            return await self._execute_task(msg["spec"])
        if mtype == "create_actor":
            return await self._create_actor(msg)
        if mtype == "actor_call":
            return await self._actor_call(conn, msg)
        if mtype == "ping":
            return {"ok": True}
        if mtype == "profile":
            return await self._profile(msg)
        if mtype == "cancel_task":
            return self._cancel_task(msg)
        if mtype == "exit":
            asyncio.get_running_loop().call_later(0.1, sys.exit, 0)
            return {"ok": True}
        raise ValueError(f"executor: unknown message {mtype}")

    async def _profile(self, msg: dict) -> dict:
        """In-process stack sampler over the execution thread.

        Reference analog: ``dashboard/modules/reporter/profile_manager.py``
        attaches py-spy to a live worker; zero-egress equivalent: a daemon
        thread samples ``sys._current_frames()`` of the exec thread every
        ``interval`` for ``duration`` seconds and aggregates identical
        stacks.  Sampling runs off the IO loop (the loop keeps serving
        heartbeats/calls while a busy sync body is profiled).
        """
        import collections

        duration = float(min(msg.get("duration", 5.0), 30.0))
        interval = float(max(msg.get("interval", 0.01), 0.001))
        # threads="all" additionally samples the IO-loop thread (the RPC
        # hot path: frame decode, arg resolve, reply encode) with a
        # per-thread root label so collapsed stacks separate the two.
        labels = {t.ident: "exec" for t in self.core.exec_pool._threads
                  if t.ident is not None}
        if msg.get("threads") == "all":
            io_ident = self.core._loop_thread.ident
            if io_ident is not None:
                labels[io_ident] = "io"

        def sample() -> dict:
            counts: collections.Counter = collections.Counter()
            samples = 0
            end = time.monotonic() + duration
            while time.monotonic() < end:
                frames = sys._current_frames()
                samples += 1
                for ident, label in labels.items():
                    f = frames.get(ident)
                    stack = [label]
                    while f is not None and len(stack) < 41:
                        code = f.f_code
                        stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}"
                                     f":{f.f_lineno}:{code.co_name}")
                        f = f.f_back
                    if len(stack) > 1:
                        stack[1:] = stack[:0:-1]
                        counts[";".join(stack)] += 1
                time.sleep(interval)
            top = counts.most_common(60)
            return {"ok": True, "pid": os.getpid(), "samples": samples,
                    "duration": duration,
                    "stacks": [{"stack": s.split(";"), "count": c}
                               for s, c in top]}

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, sample)

    # -- normal tasks --

    async def _execute_task(self, spec: dict) -> dict:
        logger.debug("exec task %s %s: start", spec["task_id"][:8],
                     spec.get("name"))
        # Visible to cancel_task from the moment the push arrives — a
        # cancel landing during (possibly minutes-long) arg resolution
        # cancels THIS asyncio task rather than injecting a thread
        # interrupt that has nothing to hit yet.
        self._current_task_id = spec["task_id"]
        self._task_handle = asyncio.current_task()
        self._exec_started = False
        t0 = time.time()
        status = "FINISHED"
        try:
            fn = await self.core.load_function(spec["fid"])
            from ray_tpu_torch._private.config import config as _rt_config
            try:
                fast = self.core.resolve_args_fast(spec["args"],
                                                   spec["kwargs"])
                if fast is not None:
                    args, kwargs = fast
                else:
                    args, kwargs = await asyncio.wait_for(
                        self.core.resolve_args(spec["args"], spec["kwargs"]),
                        timeout=_rt_config().arg_resolution_timeout_s)
            except asyncio.TimeoutError:
                # Retriable: give the lease back so reconstruction (or
                # whatever produces the arg) can get a worker; the
                # submitter retries with backoff.
                status = "FAILED"
                return {"ok": False, "retriable": True,
                        "error": _serialize_exception(RuntimeError(
                            "task argument resolution timed out; lease "
                            "released for retry"))}
            loop = asyncio.get_running_loop()
            self._exec_started = True
            tr = spec.get("trace")
            if tr is not None:
                # Execute under a child span.  The span opens ON the exec
                # thread, so nested .remote() calls from inside fn see the
                # context and propagate it further.
                from ray_tpu_torch.util import tracing
                tracing.enable()

                def _traced():
                    with tracing.span(f"task:{spec.get('name')}",
                                      _remote_parent=(
                                          tuple(tr["ctx"])
                                          if tr.get("ctx") else None)):
                        return fn(*args, **kwargs)
                run = _traced
            else:
                run = lambda: fn(*args, **kwargs)  # noqa: E731
            try:
                result = await self.core.exec_pool.run(run)
            # rtlint: disable=cancellation-safety - executor side of the
            # cancel protocol: the owner awaits this push reply and maps
            # {"cancelled": True} to TaskCancelledError; propagating would
            # kill the reply and hang the owner's get().
            except (KeyboardInterrupt, asyncio.CancelledError):
                # ray_tpu_torch.cancel(): either the injected thread interrupt
                # or (pre-execution) this asyncio task's cancellation.
                status = "FAILED"
                from ray_tpu_torch import exceptions as rex
                return {"ok": False, "cancelled": True,
                        "error": _serialize_exception(rex.TaskCancelledError(
                            f"task {spec['task_id'][:8]} was cancelled"))}
            finally:
                self._current_task_id = None
                self._task_handle = None
            # Borrow registrations must reach owners before the reply
            # releases the submitter's arg pins.
            await self.core.flush_borrow_acks()
            logger.debug("exec task %s: done", spec["task_id"][:8])
            return await self._pack_returns(spec, result)
        except SystemExit as e:
            status = "FAILED"
            # Ship buffered task events before dying — the periodic flusher
            # won't get another tick (its period exceeds the exit grace).
            spawn(self.core.flush_task_events(),
                  name="worker-flush-task-events", log=logger)
            asyncio.get_running_loop().call_later(0.2, os._exit,
                                                  e.code or 0)
            return {"ok": False, "error": _serialize_exception(
                RuntimeError("worker exited via SystemExit"))}
        # rtlint: disable=cancellation-safety - executor side of the
        # cancel protocol (see the exec_pool handler above): reply, don't
        # propagate, or the owner's awaited push never resolves.
        except asyncio.CancelledError:
            # ray_tpu_torch.cancel() during the load/resolve phase (cancel_task
            # cancelled this asyncio task).  Reply instead of propagating:
            # the owner is awaiting this push and maps the reply to
            # TaskCancelledError.
            status = "FAILED"
            from ray_tpu_torch import exceptions as rex
            return {"ok": False, "cancelled": True,
                    "error": _serialize_exception(rex.TaskCancelledError(
                        f"task {spec['task_id'][:8]} was cancelled"))}
        except Exception as e:  # noqa: BLE001
            status = "FAILED"
            return {"ok": False, "error": _serialize_exception(e)}
        finally:
            self._current_task_id = None
            self._task_handle = None
            self.core.record_task_event({
                "task_id": spec["task_id"], "name": spec.get("name"),
                "kind": "task", "start": t0, "end": time.time(),
                "status": status})

    async def _pack_returns(self, spec: dict, result) -> dict:
        num_returns = spec["num_returns"]
        if num_returns == "dynamic":
            return await self._pack_dynamic_returns(spec, result)
        if num_returns == "streaming":
            return await self._pack_streaming_returns(spec, result)
        if num_returns == 1:
            results = [result]
        else:
            results = list(result)
            if len(results) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(results)} values")
        from ray_tpu_torch._private.ids import TaskID
        task_id = TaskID(bytes.fromhex(spec.get("call_id") or spec["task_id"]))
        returns = []
        for i, value in enumerate(results):
            oid = ObjectID.for_task_return(task_id, i)
            returns.append(
                await self.core.store_return_value_async(oid, value))
        return {"ok": True, "returns": returns}

    async def _pack_dynamic_returns(self, spec: dict, result) -> dict:
        """Generator task (num_returns="dynamic", reference: dynamic
        returns in _raylet.pyx): store each yielded value as its own
        object at return indices 1..n, then store an ObjectRefGenerator
        listing their refs as return 0.  The reply carries every entry;
        the caller registers ownership of the extras on receipt."""
        from ray_tpu_torch._private.ids import TaskID
        from ray_tpu_torch._private.object_ref import (ObjectRef,
                                                 ObjectRefGenerator)
        task_id = TaskID(
            bytes.fromhex(spec.get("call_id") or spec["task_id"]))
        owner = spec.get("owner_address", "")
        entries, refs = [], []
        i = 0
        for value in result:   # raises TypeError for non-iterables: apt
            i += 1
            oid = ObjectID.for_task_return(task_id, i)
            entries.append(
                await self.core.store_return_value_async(oid, value))
            refs.append(ObjectRef(oid, owner))
        gen_oid = ObjectID.for_task_return(task_id, 0)
        entry0 = await self.core.store_return_value_async(
            gen_oid, ObjectRefGenerator(refs))
        return {"ok": True, "returns": [entry0] + entries}

    async def _pack_streaming_returns(self, spec: dict, result) -> dict:
        """Streaming generator call (num_returns="streaming", reference:
        ReportGeneratorItemReturns in core_worker.cc): each yield is
        stored AND advertised to the owner immediately via a stream_yield
        RPC, so the consumer iterates while the generator still runs.

        Awaiting every ack before the next step is the backpressure (one
        yield in flight per stream); a refused ack means the consumer
        dropped the stream, and close() raises GeneratorExit inside the
        user body so its finally blocks release whatever the sequence
        held.  The final reply stays shape-compatible with dynamic
        returns: an ObjectRefGenerator of all yielded refs at index 0,
        whose arrival in the owner's store doubles as the end-of-stream
        marker (it strictly follows the last acked yield)."""
        from ray_tpu_torch._private.ids import TaskID
        from ray_tpu_torch._private.object_ref import (ObjectRef,
                                                 ObjectRefGenerator)
        task_id_hex = spec.get("call_id") or spec["task_id"]
        task_id = TaskID(bytes.fromhex(task_id_hex))
        owner = spec.get("owner_address", "")
        if not owner:
            raise ValueError(
                'num_returns="streaming" requires an owner_address in the '
                "task spec")
        conn = await self.core._get_worker_conn(owner)
        sentinel = object()
        if hasattr(result, "__anext__"):
            async def step():
                try:
                    return await result.__anext__()
                except StopAsyncIteration:
                    return sentinel

            async def close():
                await result.aclose()
        elif hasattr(result, "__iter__"):
            it = iter(result)

            # next() runs on the exec thread (user code may block); the
            # sentinel keeps StopIteration from crossing the coroutine
            # boundary, where Python would morph it into RuntimeError.
            def _next():
                try:
                    return next(it)
                except StopIteration:
                    return sentinel

            async def step():
                return await self.core.exec_pool.run(_next)

            async def close():
                if hasattr(it, "close"):
                    await self.core.exec_pool.run(it.close)
        else:
            raise TypeError(
                'num_returns="streaming" requires the task to return a '
                f"generator or async generator, got {type(result).__name__}")
        self._streaming_calls.add(task_id_hex)
        refs = []
        i = 0
        try:
            while True:
                try:
                    value = await step()
                except asyncio.CancelledError:
                    # ray_tpu_torch.cancel() mid-stream: close the user body so
                    # its finally blocks run, then let the cancel reply
                    # path take over.
                    try:
                        await close()
                    except Exception:
                        pass
                    raise
                if value is sentinel:
                    break
                i += 1
                oid = ObjectID.for_task_return(task_id, i)
                entry = await self.core.store_return_value_async(oid, value)
                try:
                    ack = await conn.request(
                        {"type": "stream_yield", "task_id": task_id_hex,
                         "index": i, "entry": entry}, timeout=60)
                except Exception:
                    ack = {"ok": False}   # owner died/unreachable: stop
                if not ack.get("ok"):
                    try:
                        await close()
                    except Exception:
                        pass
                    break
                refs.append(ObjectRef(oid, owner))
        finally:
            self._streaming_calls.discard(task_id_hex)
        gen_oid = ObjectID.for_task_return(task_id, 0)
        entry0 = await self.core.store_return_value_async(
            gen_oid, ObjectRefGenerator(refs))
        return {"ok": True, "returns": [entry0], "streamed": i}

    # -- actors --

    async def _create_actor(self, msg: dict) -> dict:
        try:
            import hashlib
            # Class/closure unpickling is unbounded work (imports, class
            # bodies) — run it on the executor so actor creation never
            # freezes the IO loop that is concurrently serving fast-lane
            # calls for other actors on this worker.
            loop = asyncio.get_running_loop()
            spec = await loop.run_in_executor(
                None, cloudpickle.loads, msg["creation_spec"])
            cls_key = hashlib.sha1(spec["cls"]).hexdigest()
            cls = _ACTOR_CLS_CACHE.get(cls_key)
            if cls is None:
                cls = _ACTOR_CLS_CACHE[cls_key] = await loop.run_in_executor(
                    None, cloudpickle.loads, spec["cls"])
            # Bounded like normal tasks: a creation blocked on a lost arg
            # must release its worker so reconstruction can run (the GCS
            # retries the creation on a fresh worker).
            from ray_tpu_torch._private.config import config as _rt_config
            args, kwargs = await asyncio.wait_for(
                self.core.resolve_args(spec["args"], spec["kwargs"]),
                timeout=_rt_config().arg_resolution_timeout_s)
            self.max_concurrency = spec.get("max_concurrency", 1)
            self._sem = asyncio.Semaphore(self.max_concurrency)
            # Named concurrency groups (reference:
            # core_worker/transport/concurrency_group_manager.h + the
            # fiber-per-group execution of async actors): each group gets
            # its own semaphore so e.g. "io" calls can't starve
            # "compute" calls of slots.
            self._group_sems = {
                g: asyncio.Semaphore(int(n))
                for g, n in (spec.get("concurrency_groups") or {}).items()}
            self.actor_id = msg["actor_id"]
            loop = asyncio.get_running_loop()
            self.actor_instance = await self.core.exec_pool.run(
                lambda: cls(*args, **kwargs))
            self._method_cache.clear()   # bound to the (new) instance
            await self.core.flush_borrow_acks()
            title = getattr(cls, "__name__", "Actor")
            _set_proc_title(f"rtt::actor::{title}")
            return {"ok": True}
        except Exception as e:  # noqa: BLE001
            logger.exception("actor constructor failed")
            return {"ok": False, "error": f"{type(e).__name__}: {e}\n"
                    f"{traceback.format_exc()}"}

    def fast_actor_call(self, conn, rid: int, msg) -> bool:
        """Zero-task dispatch for the common actor call: sync method, in
        order, inline-resolvable args, single return, no tracing or
        concurrency group.  The prologue runs synchronously at
        frame-dispatch time and the reply is queued from the exec
        future's done-callback — no asyncio.Task and no coroutine frames
        per call (the n:n profile billed the per-request Task machinery
        ~15us/call on the IO loop).  Returns False to route the call
        down the general `_actor_call` coroutine instead; everything up
        to the exec hand-off is side-effect-free (idempotent caches
        aside), so a False after partial validation is always safe."""
        if (msg.__class__ is not dict
                or msg.get("type") != "actor_call"
                or msg.get("num_returns", 1) != 1
                or msg.get("concurrency_group") is not None
                or msg.get("trace") is not None
                or self._exit_requested
                or self.actor_instance is None):
            return False
        cached = self._method_cache.get(msg["method"])
        if cached is None:
            try:
                method = getattr(self.actor_instance, msg["method"])
            except AttributeError:
                return False
            cached = self._method_cache[msg["method"]] = (
                method, inspect.iscoroutinefunction(method),
                getattr(method, "_rt_concurrency_group", None))
        method, is_coro, default_group = cached
        if is_coro or default_group is not None:
            return False
        key = id(conn)
        order = self._order.get(key)
        if order is None:
            order = self._order[key] = {"next": 0, "waiters": {}}
        seq = msg.get("seq", 0)
        if order["next"] < seq:
            return False     # out of order: the slow path parks on a waiter
        try:
            fast = self.core.resolve_args_fast(msg["args"], msg["kwargs"])
        except Exception:
            # A deserialization error replays deterministically on the
            # slow path, which owns error reporting.
            return False
        if fast is None:
            return False
        args, kwargs = fast
        call_id = msg["call_id"]

        def _call(m=method, a=args, k=kwargs, cid=call_id):
            self._sync_started.add(cid)
            return m(*a, **k)

        fut = self.core.exec_pool.run(_call)
        # Registered as the cancel target: futures expose the same
        # .cancel() surface _cancel_task uses, and a pre-start cancel
        # makes the exec thread skip the body.
        self._actor_call_tasks[call_id] = fut
        self._advance(order, seq)
        fut.add_done_callback(functools.partial(
            self._fast_reply, conn, rid, msg, time.time()))
        return True

    def _fast_reply(self, conn, rid: int, msg: dict, t0: float, fut) -> None:
        """Done-callback epilogue of fast_actor_call (IO loop thread)."""
        call_id = msg["call_id"]
        self._actor_call_tasks.pop(call_id, None)
        self._sync_started.discard(call_id)
        status = "FINISHED"
        try:
            result = fut.result()   # raises CancelledError when cancelled
            if self.core._borrow_acks:
                # Borrows registered while resolving container args must
                # reach the owner before the reply releases the pins.
                spawn(self._fast_reply_slow(conn, rid, msg, t0, result),
                      name="fast-reply-slow", log=logger)
                return
            # Return-0 object id by string surgery (ObjectID.for_task_return
            # flips the top bit and stamps the index into the low two bytes,
            # which a generator-issued call id keeps zero) — no TaskID /
            # ObjectID round trip on the per-call path.
            h = "%02x%s0000" % (int(call_id[:2], 16) ^ 0x80, call_id[2:28])
            entry, _ser = self.core.pack_return_sync(h, result)
            if entry is None:
                # Plasma-bound return: needs the awaiting store path.
                spawn(self._fast_reply_slow(conn, rid, msg, t0, result),
                      name="fast-reply-slow", log=logger)
                return
            reply = {"ok": True, "returns": [entry]}
        # rtlint: disable=cancellation-safety - done-callback reap of the
        # exec future this worker's own _cancel_task cancelled; the
        # cancelled reply is what resolves the owner's call.
        except asyncio.CancelledError:
            status = "FAILED"
            from ray_tpu_torch import exceptions as rex
            reply = {"ok": False, "cancelled": True,
                     "error": _serialize_exception(rex.TaskCancelledError(
                         f"actor call {msg['method']} "
                         f"({call_id[:8]}) was cancelled"))}
        except SystemExit:
            status = "FAILED"
            spawn(self._report_intended_exit(),
                  name="report-intended-exit", log=logger)
            from ray_tpu_torch.exceptions import ActorDiedError
            reply = {"ok": False, "error": _serialize_exception(
                ActorDiedError("actor exited via exit_actor()"))}
        # rtlint: disable=cancellation-safety - thread boundary: the
        # exception is serialized into the reply and re-raised caller-side
        # by _materialize, not swallowed; raising out of a done-callback
        # would only reach the loop's exception handler.
        except BaseException as e:  # noqa: BLE001 - forwarded to caller
            status = "FAILED"
            reply = {"ok": False, "error": _serialize_exception(e)}
        conn.reply_soon(rid, reply)
        self.core.record_task_event({
            "task_id": call_id, "name": msg["method"], "kind": "actor_call",
            "actor_id": self.actor_id, "start": t0, "end": time.time(),
            "status": status})

    async def _fast_reply_slow(self, conn, rid: int, msg: dict, t0: float,
                               result) -> None:
        """Rare epilogue for a fast-dispatched call whose reply needs to
        await (pending borrow acks or a plasma-bound return value)."""
        call_id = msg["call_id"]
        status = "FINISHED"
        try:
            await self.core.flush_borrow_acks()
            oid = ObjectID.for_task_return(
                TaskID(bytes.fromhex(call_id)), 0)
            entry = await self.core.store_return_value_async(oid, result)
            reply = {"ok": True, "returns": [entry]}
        except Exception as e:  # noqa: BLE001 - forwarded to caller
            status = "FAILED"
            reply = {"ok": False, "error": _serialize_exception(e)}
        conn.reply_soon(rid, reply)
        await conn.maybe_drain()
        self.core.record_task_event({
            "task_id": call_id, "name": msg["method"], "kind": "actor_call",
            "actor_id": self.actor_id, "start": t0, "end": time.time(),
            "status": status})

    async def _actor_call(self, conn, msg: dict) -> dict:
        # Per-caller in-order execution start (reference:
        # ActorSchedulingQueue sequence numbers). One handle = one connection;
        # seq restarts at 0 on reconnect after actor restart.
        key = id(conn)
        order = self._order.get(key)
        if order is None:
            order = self._order[key] = {"next": 0, "waiters": {}}
        seq = msg.get("seq", 0)
        if self._exit_requested:
            from ray_tpu_torch.exceptions import ActorDiedError
            return {"ok": False, "error": _serialize_exception(
                ActorDiedError("actor exited via exit_actor()"))}
        # Cancellable while queued / resolving args / awaiting an async
        # method (reference: actor-task cancel covers exactly these; a
        # sync method already on the exec thread is not interruptible
        # without risking the actor's state).
        call_id = msg["call_id"]
        self._actor_call_tasks[call_id] = asyncio.current_task()
        t0 = time.time()
        status = "FINISHED"
        try:
            if order["next"] < seq:
                fut = asyncio.get_running_loop().create_future()
                order["waiters"].setdefault(seq, []).append(fut)
                await fut
            cached = self._method_cache.get(msg["method"])
            if cached is None:
                method = getattr(self.actor_instance, msg["method"])
                cached = self._method_cache[msg["method"]] = (
                    method, inspect.iscoroutinefunction(method),
                    getattr(method, "_rt_concurrency_group", None))
            method, is_coro, default_group = cached
            fast = self.core.resolve_args_fast(msg["args"], msg["kwargs"])
            if fast is not None:
                args, kwargs = fast
            else:
                from ray_tpu_torch._private.config import config as _rt_config
                try:
                    args, kwargs = await asyncio.wait_for(
                        self.core.resolve_args(msg["args"], msg["kwargs"]),
                        timeout=_rt_config().arg_resolution_timeout_s)
                except asyncio.TimeoutError:
                    # Retriable: the caller resends with a fresh seq;
                    # advance the order cursor so later calls aren't
                    # blocked behind this one.
                    status = "FAILED"
                    self._advance(order, seq)
                    return {"ok": False, "retriable": True,
                            "error": _serialize_exception(RuntimeError(
                                "actor-call argument resolution timed out"))}
            tr = msg.get("trace")
            if tr is not None:
                from ray_tpu_torch.util import tracing
                tracing.enable()
                parent = tuple(tr["ctx"]) if tr.get("ctx") else None
                name = f"actor:{msg['method']}"
            if is_coro:
                group = msg.get("concurrency_group") or default_group
                sem = self._group_sems.get(group, self._sem) \
                    if getattr(self, "_group_sems", None) else self._sem
                if group and (not getattr(self, "_group_sems", None)
                              or group not in self._group_sems):
                    raise ValueError(
                        f"unknown concurrency group {group!r}; declared: "
                        f"{sorted(getattr(self, '_group_sems', {}))}")
                # Advance the order cursor BEFORE acquiring the slot:
                # a saturated group must not stall calls bound for other
                # groups.  Same-group start order is still FIFO
                # (asyncio.Semaphore wakes waiters in acquire order).
                self._advance(order, seq)
                async with sem:
                    if tr is not None:
                        with tracing.span(name, _remote_parent=parent):
                            result = await method(*args, **kwargs)
                    else:
                        result = await method(*args, **kwargs)
            else:
                loop = asyncio.get_running_loop()

                # The exec thread marks the body as started on entry
                # (GIL-atomic set add): once entered, cancellation would
                # abandon in-progress actor state mutation, so
                # _cancel_task refuses it (reference: only queued/async
                # actor tasks cancel).
                def _call(m=method, a=args, k=kwargs, _tr=tr):
                    self._sync_started.add(call_id)
                    if _tr is not None:
                        with tracing.span(name, _remote_parent=parent):
                            return m(*a, **k)
                    return m(*a, **k)
                fut = self.core.exec_pool.run(_call)
                self._advance(order, seq)
                result = await fut
            spec = {"num_returns": msg["num_returns"], "task_id": msg["call_id"],
                    "call_id": msg["call_id"],
                    "owner_address": msg.get("owner_address", "")}
            await self.core.flush_borrow_acks()
            return await self._pack_returns(spec, result)
        except SystemExit:
            # exit_actor(): report intended death, reply an error to this call
            # (matching the reference: the exiting call resolves to an
            # ActorError), and hard-exit shortly after the reply flushes.
            # Never re-raise -- SystemExit escaping an asyncio task would tear
            # down the IO loop before the exit is scheduled.
            status = "FAILED"
            await self._report_intended_exit()
            from ray_tpu_torch.exceptions import ActorDiedError
            return {"ok": False, "error": _serialize_exception(
                ActorDiedError("actor exited via exit_actor()"))}
        # rtlint: disable=cancellation-safety - executor side of the
        # cancel protocol: the cancelled reply resolves the owner's call,
        # and the order cursor must step or later calls deadlock.
        except asyncio.CancelledError:
            # ray_tpu_torch.cancel() on this actor call while it was queued,
            # resolving args, or awaiting an async method.  The order
            # cursor MUST eventually step over this seq or every later
            # call on the handle waits forever — but a QUEUED cancel may
            # not leapfrog seqs that are still ahead of the cursor
            # (advancing past them would unleash out-of-order execution).
            status = "FAILED"
            if order["next"] >= seq:
                self._advance(order, seq)
            else:
                order.setdefault("skipped", set()).add(seq)
            from ray_tpu_torch import exceptions as rex
            return {"ok": False, "cancelled": True,
                    "error": _serialize_exception(rex.TaskCancelledError(
                        f"actor call {msg['method']} "
                        f"({call_id[:8]}) was cancelled"))}
        except Exception as e:  # noqa: BLE001
            status = "FAILED"
            self._advance(order, seq)
            return {"ok": False, "error": _serialize_exception(e)}
        finally:
            self._actor_call_tasks.pop(call_id, None)
            self._sync_started.discard(call_id)
            self.core.record_task_event({
                "task_id": msg["call_id"], "name": msg["method"],
                "kind": "actor_call", "actor_id": self.actor_id,
                "start": t0, "end": time.time(), "status": status})

    @staticmethod
    def _advance(order: dict, seq: int):
        # Single-threaded on the IO loop, so plain bookkeeping suffices —
        # the previous asyncio.Condition cost two lock suspensions per
        # call even with nothing waiting (the hot path).
        if order["next"] <= seq:
            order["next"] = seq + 1
        # Cascade over cancelled-while-queued seqs: they will never run,
        # so the cursor must step through them or the line stalls.
        skipped = order.get("skipped")
        while skipped and order["next"] in skipped:
            skipped.discard(order["next"])
            order["next"] += 1
        nxt = order["next"]
        for s in [s for s in order["waiters"] if s <= nxt]:
            for f in order["waiters"].pop(s):
                if not f.done():
                    f.set_result(None)

    async def _report_intended_exit(self):
        self._exit_requested = True
        await self.core.flush_task_events()
        if self.actor_id:
            try:
                await self.core.gcs.request({"type": "report_actor_death",
                                             "actor_id": self.actor_id,
                                             "intended": True})
            except Exception:
                pass
        asyncio.get_running_loop().call_later(0.2, os._exit, 0)


def _set_proc_title(title: str):
    try:
        import ctypes
        libc = ctypes.CDLL(None)
        buf = ctypes.create_string_buffer(title.encode()[:15])
        libc.prctl(15, buf, 0, 0, 0)  # PR_SET_NAME
    except Exception:
        pass


def main():
    logging.basicConfig(level=os.environ.get("RT_LOG_LEVEL", "WARNING"))
    worker_id = os.environ["RT_WORKER_ID"]
    node_id = os.environ["RT_NODE_ID"]
    raylet_address = os.environ["RT_RAYLET_ADDRESS"]
    gcs_address = os.environ["RT_GCS_ADDRESS"]
    store_name = os.environ["RT_STORE_NAME"]
    driver_sys_path = os.environ.get("RT_DRIVER_SYS_PATH")
    if driver_sys_path:
        for p in reversed(driver_sys_path.split(os.pathsep)):
            if p and p not in sys.path:
                sys.path.insert(0, p)
    _set_proc_title("rtt::worker")

    core = CoreWorker(
        gcs_address=gcs_address,
        raylet_address=raylet_address,
        store_name=store_name,
        node_id_hex=node_id,
        job_id="",
        is_worker=True,
    )
    executor = TaskExecutor(core)
    core.task_executor = executor
    core.worker_id_hex = worker_id   # blocked/unblocked raylet notifies

    # Make this process's global_worker usable (nested task submission).
    from ray_tpu_torch._private import worker as worker_mod
    worker_mod.global_worker.attach_core(core, mode="worker")

    # Runtime env materialization (env_vars were applied by the raylet at
    # spawn, under the card ids it leased; packages need the GCS KV, so
    # they land here, after a forked worker left the template):
    # working_dir is extracted + chdir'd, py_modules and pip targets join
    # sys.path (reference: the runtime-env agent's ``working_dir.py`` /
    # ``py_modules.py`` / ``pip.py`` plugins).
    renv_json = os.environ.get("RT_RUNTIME_ENV")
    if renv_json:
        import json as _json
        import tempfile as _tempfile
        from ray_tpu_torch.runtime_env.runtime_env import PKG_NS, materialize
        renv = _json.loads(renv_json)

        def _kv_get(key):
            return core.gcs_request({"type": "kv_get", "ns": PKG_NS,
                                     "key": key})

        mat = materialize(renv, _kv_get, os.path.join(
            _tempfile.gettempdir(), "rtt_runtime_env"))
        for p in reversed(mat["paths"]):
            if p not in sys.path:
                sys.path.insert(0, p)
        if mat["workdir"]:
            os.chdir(mat["workdir"])

    async def register():
        conn = await connect(raylet_address,
                             lambda m: executor.handle(None, m),
                             name="worker->raylet")
        await conn.request({"type": "register_worker",
                            "worker_id": worker_id,
                            "address": core.address})
        return conn

    raylet_conn = asyncio.run_coroutine_threadsafe(register(), core.loop).result()

    # Exit when the raylet goes away (our parent).
    import threading
    import time

    def watch():
        ppid = os.getppid()
        while True:
            if os.getppid() != ppid or raylet_conn.closed:
                os._exit(0)
            time.sleep(1.0)

    threading.Thread(target=watch, daemon=True).start()
    threading.Event().wait()  # serve forever on the loop thread


if __name__ == "__main__":
    main()

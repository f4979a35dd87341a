"""HTTP ingress actor: asyncio HTTP/1.1 server routing to replicas,
with token-streaming responses and zero-loss failover.

Reference analog: HTTPProxyActor + LongestPrefixRouter
(_private/http_proxy.py:387,143).  No aiohttp/starlette in this image, so
the request loop is a small hand-rolled HTTP/1.1 parser: request line +
headers + Content-Length body, JSON in/out.

Everything here is async-on-the-actor-loop; sync ray_tpu_torch calls (which
block on the same loop) are never used — the controller is resolved through an
async GCS lookup and replicas are called by awaiting their ObjectRefs.

POST /<route_prefix>  body=JSON  ->  result of deployment(body)
GET  /-/routes                   ->  route table
GET  /-/healthz                  ->  "ok"

**Streaming.**  A request with ``"stream": true`` in its JSON body (or
``Accept: text/event-stream``) is routed through the replica's streaming
path (``handle_stream`` + ``num_returns="streaming"``): the response is
``Transfer-Encoding: chunked`` Server-Sent Events, one ``data:`` event
per yielded item, flushed as produced — the client reads the first token
while the replica is still generating.  The stream ends with an
``event: end`` record and the chunked terminator; the connection stays
keep-alive.  A client that disconnects (or stops reading past the write
timeout) cancels the replica-side stream, which frees the engine's KV
pages.

**Resilience** (see ``serve/resilience.py`` for the state machines):

* *Mid-stream failover.*  The ingress records each live stream's request
  payload and the items already delivered to the client.  When the
  serving replica dies (ActorDiedError from the stream) or stalls past
  ``RT_SERVE_STALL_S``, the ingress cancels the broken stream, picks a
  healthy replica, and resumes: for token-generation payloads
  (``{"tokens": [...], "max_new_tokens": N}``) it re-prefills
  ``prompt + delivered`` with the remaining token budget — under greedy
  decoding the resumed tail is bit-identical to an uninterrupted run —
  and for opaque payloads it replays the request and skips the items
  already delivered.  The client's SSE stream never breaks; a resumed
  stream bumps the ``streams_resumed`` counter.

* *Circuit breaking + bounded retry.*  Per-replica consecutive-failure
  breakers (``RT_SERVE_CB_THRESHOLD``/``RT_SERVE_CB_COOLDOWN_S``) eject
  failing replicas from routing with half-open probe re-admission; every
  request carries a retry budget (``RT_SERVE_RETRY_BUDGET``) spent on
  exponential-backoff-with-jitter re-sends (``router_retries`` counter).
  Budget exhausted or no routable replica → 503.

* *Deadlines.*  ``x-request-deadline-s`` header (or ``deadline_s`` in
  the JSON body) sets an absolute end-to-end deadline propagated to the
  replica and engine; expiry → 504, with replica-side decode cancelled
  and its KV pages freed.

* *Push-based replica discovery.*  A long-poll listener per routed
  deployment (controller ``listen_for_change``) replaces the 1s replica
  poll: stop-routing decisions (rolling restart, scale-down) reach the
  ingress the moment the controller bumps the version, not a poll period
  later.  Controller loss falls back to exponential-backoff re-resolve
  (``ctrl_reresolves`` in ``stats()``) instead of a tight retry loop.

**Self-protection.**  Connection storms are load-shed at accept time
(429 + Retry-After once ``max_connections`` are live); malformed or
oversized requests get clean 400/413s instead of a hung reader; every
socket read and write is bounded by a timeout, with the slow-client
fault hook (``util.fault_injection``) injected inside the drain so
chaos tests can trip the write path deterministically.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch._private.async_utils import spawn
import itertools
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.serve import metrics as serve_metrics
from ray_tpu_torch.serve import resilience

logger = logging.getLogger(__name__)

_MAX_HEADERS = 64


async def _materialize(item):
    from ray_tpu_torch._private.object_ref import ObjectRef
    if isinstance(item, ObjectRef):
        return await item
    return item


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _BadRequest(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _Unavailable(Exception):
    """No routable replica within the retry budget (HTTP 503)."""


class HTTPIngress:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 namespace: str = "default", *,
                 max_connections: Optional[int] = None,
                 max_body_bytes: Optional[int] = None,
                 read_timeout_s: Optional[float] = None,
                 write_timeout_s: Optional[float] = None,
                 stream_idle_timeout_s: Optional[float] = None,
                 stall_timeout_s: Optional[float] = None):
        self._host, self._port = host, port
        self._namespace = namespace
        self._server = None
        self._routes: Dict[str, str] = {}
        self._replicas: Dict[str, list] = {}
        self._rr = itertools.count()
        self._ctrl = None
        self._nconn = 0
        self._shed = 0          # connections 429'd (observability)
        self._cb = resilience.CircuitBreaker(
            on_open=lambda rid: serve_metrics.bump("circuit_open"))
        self._listen_tasks: Dict[str, asyncio.Task] = {}
        # Controller re-resolve backoff: repeated failures (controller
        # restarting, GCS briefly away) grow the retry interval instead of
        # hammering the GCS with a lookup per request per second.
        self._ctrl_failures = 0
        self._ctrl_retry_at = 0.0         # monotonic gate
        self._ctrl_reresolves = 0         # successful re-resolves (stats)
        self._max_conn = int(max_connections if max_connections is not None
                             else _env_f("RT_SERVE_MAX_CONNECTIONS", 256))
        self._max_body = int(max_body_bytes if max_body_bytes is not None
                             else _env_f("RT_SERVE_MAX_BODY_BYTES",
                                         10 * 1024 * 1024))
        self._read_timeout = (read_timeout_s if read_timeout_s is not None
                              else _env_f("RT_SERVE_READ_TIMEOUT_S", 120.0))
        self._write_timeout = (write_timeout_s
                               if write_timeout_s is not None
                               else _env_f("RT_SERVE_WRITE_TIMEOUT_S", 30.0))
        self._stream_idle = (stream_idle_timeout_s
                             if stream_idle_timeout_s is not None
                             else _env_f("RT_SERVE_STREAM_IDLE_S", 120.0))
        # A stream quiet past this long is treated as a stalled replica
        # and failed over (vs. _stream_idle, which is the terminal bound).
        self._stall_s = (stall_timeout_s if stall_timeout_s is not None
                         else _env_f("RT_SERVE_STALL_S", 30.0))

    async def _ensure_started(self):
        if self._server is not None:
            return
        self._server = await asyncio.start_server(
            self._serve_conn, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        self._route_refresh_task = spawn(
            self._route_refresh_loop(), name="ingress-route-refresh")

    async def address(self) -> Tuple[str, int]:
        await self._ensure_started()
        return (self._host, self._port)

    async def stats(self) -> Dict[str, int]:
        return {"connections": self._nconn, "shed": self._shed,
                "max_connections": self._max_conn,
                "ctrl_reresolves": self._ctrl_reresolves,
                **serve_metrics.stats()}

    # ------------------------------------------------- controller discovery

    async def _controller(self):
        if self._ctrl is None:
            if time.monotonic() < self._ctrl_retry_at:
                raise RuntimeError("serve controller unavailable "
                                   "(re-resolve backing off)")
            from ray_tpu_torch._private.worker import get_core
            from ray_tpu_torch.actor import ActorHandle
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME
            try:
                info = await get_core().gcs.request(
                    {"type": "get_named_actor", "name": CONTROLLER_NAME,
                     "namespace": self._namespace})
            except Exception:
                self._ctrl_backoff()
                raise
            if info is None:
                self._ctrl_backoff()
                raise RuntimeError("serve controller not running")
            self._ctrl = ActorHandle(info["actor_id"], "ServeController")
            if self._ctrl_failures:
                # Dual-sink: the local attribute feeds this ingress's
                # stats(); the registry counter survives the node-stats ->
                # GCS-fold -> /api/metrics chain (the attribute alone was
                # invisible off-process).
                self._ctrl_reresolves += 1
                serve_metrics.bump("ctrl_reresolves")
            self._ctrl_failures = 0
        return self._ctrl

    def _ctrl_backoff(self):
        self._ctrl_failures += 1
        delay = min(8.0, 0.25 * (2 ** min(self._ctrl_failures, 6)))
        self._ctrl_retry_at = time.monotonic() + delay

    def _ctrl_lost(self):
        """A call through the cached handle failed: drop it so the next
        _controller() re-resolves (through the backoff gate)."""
        self._ctrl = None
        self._ctrl_backoff()

    async def _route_refresh_loop(self):
        while True:
            try:
                ctrl = await self._controller()
                self._routes = await ctrl.routes.remote()
                names = set(self._routes.values())
                for name in names:
                    t = self._listen_tasks.get(name)
                    if t is None or t.done():
                        self._listen_tasks[name] = spawn(
                            self._listen_replicas(name),
                            name=f"ingress-listen-{name}")
                for name in list(self._listen_tasks):
                    if name not in names:
                        self._listen_tasks.pop(name).cancel()
                        self._replicas.pop(name, None)
            except Exception:
                self._ctrl_lost()  # controller restarted; re-resolve
            await asyncio.sleep(1.0)

    async def _listen_replicas(self, name: str):
        """Long-poll the controller for replica-set changes (push, not
        poll): a rolling restart's stop-routing version bump lands here
        the moment it happens, so no new stream targets a draining
        replica."""
        version = -1
        while True:
            try:
                ctrl = await self._controller()
                upd = await asyncio.wait_for(
                    ctrl.listen_for_change.remote(name, version, 25.0),
                    timeout=40.0)
                version = upd["version"]
                self._replicas[name] = upd["replicas"]
                live = {r._actor_id
                        for reps in self._replicas.values() for r in reps}
                self._cb.forget_missing(live)
            except asyncio.CancelledError:
                raise
            except Exception:
                self._ctrl_lost()
                await asyncio.sleep(
                    min(8.0, 0.25 * (2 ** min(self._ctrl_failures, 6))))

    # ------------------------------------------------------------- routing

    def _match_route(self, path: str) -> Optional[str]:
        # Longest matching route prefix wins, on path-segment boundaries
        # (http_proxy.py:143 LongestPrefixRouter): /echo matches /echo and
        # /echo/x but not /echoes.
        target: Optional[str] = None
        best = -1
        for prefix, name in self._routes.items():
            p = prefix.rstrip("/")
            if (path == p or path.startswith(p + "/")) and len(p) > best:
                target, best = name, len(p)
        return target

    async def _pick_replica(self, name: str,
                            exclude: Optional[set] = None):
        reps = self._replicas.get(name)
        if not reps:
            ctrl = await self._controller()
            reps = self._replicas[name] = \
                await ctrl.get_replicas.remote(name)
        if not reps:
            raise _Unavailable(f"deployment {name} has no replicas")
        picked = self._cb.select(reps, next(self._rr), exclude=exclude)
        if picked is None:
            # Everything routable is ejected or excluded: maybe the
            # controller already replaced the dead replicas — refresh the
            # set once before giving up.
            try:
                ctrl = await self._controller()
                reps = self._replicas[name] = \
                    await ctrl.get_replicas.remote(name)
            except Exception:
                reps = []
            picked = self._cb.select(reps, next(self._rr), exclude=exclude)
        if picked is None:
            raise _Unavailable(
                f"deployment {name} has no routable replica "
                "(all ejected or excluded)")
        return picked

    def _expired(self, deadline: Optional[float]) -> bool:
        rem = resilience.deadline_remaining(deadline)
        return rem is not None and rem <= 0

    async def _call(self, name: str, payload,
                    deadline: Optional[float] = None):
        """Unary call with circuit breaking + bounded backoff retry."""
        policy = resilience.RetryPolicy()
        exclude: set = set()
        while True:
            if self._expired(deadline):
                raise resilience.DeadlineExceeded(
                    "request deadline expired before completion")
            replica = await self._pick_replica(name, exclude)
            rid = replica._actor_id
            try:
                result = await replica.handle_request.remote(
                    [payload], {}, None, deadline)
            except Exception as e:   # noqa: BLE001
                if not resilience.is_retryable_error(e):
                    raise
                self._cb.record_failure(rid)
                exclude.add(rid)
                self._replicas.pop(name, None)   # force a refresh
                if not policy.can_retry():
                    raise _Unavailable(
                        f"retry budget exhausted for {name}: {e!r}") from e
                serve_metrics.bump("router_retries")
                await asyncio.sleep(policy.next_backoff_s(deadline))
                continue
            self._cb.record_success(rid)
            return result

    async def _call_stream(self, name: str, payload,
                           deadline: Optional[float] = None,
                           exclude: Optional[set] = None):
        """StreamingObjectRefGenerator of the replica handler's yields;
        returns (generator, replica_actor_id)."""
        replica = await self._pick_replica(name, exclude)
        gen = replica.handle_stream.options(
            num_returns="streaming").remote([payload], {}, None, deadline)
        return gen, replica._actor_id

    # --------------------------------------------------------- connection

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        if self._nconn >= self._max_conn:
            # Load shedding: a storm of connections must not starve the
            # live ones (or the event loop).  Shed at accept with an
            # explicit retry hint; /-/healthz stays responsive because
            # established connections still serve.
            self._shed += 1
            try:
                await self._respond(writer, 429,
                                    {"error": "too many connections"},
                                    extra_headers={"Retry-After": "1"},
                                    close=True)
            except Exception:
                pass
            finally:
                writer.close()
            return
        self._nconn += 1
        try:
            while True:
                try:
                    line = await asyncio.wait_for(
                        reader.readline(), self._read_timeout)
                except (asyncio.TimeoutError, ValueError):
                    return   # idle keep-alive or oversized request line
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, path, _ = line.decode().split(" ", 2)
                except ValueError:
                    return await self._respond(
                        writer, 400, {"error": "bad request"}, close=True)
                try:
                    headers, body = await self._read_request(reader)
                except _BadRequest as e:
                    # The body was not (fully) read: the connection can't
                    # be reused safely, so answer and close.
                    return await self._respond(
                        writer, e.code, {"error": str(e)}, close=True)
                except (asyncio.TimeoutError, ValueError,
                        asyncio.IncompleteReadError):
                    return   # client stopped mid-request: nothing to say
                keep = headers.get("connection", "").lower() != "close"
                await self._dispatch(writer, method, path, headers, body)
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, asyncio.TimeoutError):
            pass
        finally:
            self._nconn -= 1
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader) -> Tuple[Dict[str, str], bytes]:
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS):
            h = await asyncio.wait_for(reader.readline(),
                                       self._read_timeout)
            if h in (b"\r\n", b"\n", b""):
                break
            k, sep, v = h.decode("latin-1").partition(":")
            if sep:
                headers[k.strip().lower()] = v.strip()
        else:
            raise _BadRequest(400, "too many headers")
        raw_n = headers.get("content-length", "0") or "0"
        try:
            n = int(raw_n)
            if n < 0:
                raise ValueError
        except ValueError:
            # A reader that trusted this value would hang waiting for a
            # body that never comes (or worse, int("1e9")-style garbage).
            raise _BadRequest(400,
                              f"malformed content-length {raw_n!r}") from None
        if n > self._max_body:
            raise _BadRequest(413, f"body of {n} bytes exceeds limit "
                                   f"{self._max_body}")
        body = b""
        if n:
            body = await asyncio.wait_for(reader.readexactly(n),
                                          self._read_timeout)
        return headers, body

    # ----------------------------------------------------------- dispatch

    @staticmethod
    def _parse_deadline(headers: Dict[str, str], payload) -> Optional[float]:
        """Relative deadline (seconds) from the `x-request-deadline-s`
        header or a `deadline_s` body field, as an absolute epoch time."""
        v = headers.get("x-request-deadline-s")
        if v is None and isinstance(payload, dict):
            v = payload.get("deadline_s")
        if v is None:
            return None
        try:
            return time.time() + float(v)
        except (TypeError, ValueError):
            return None

    async def _dispatch(self, writer, method: str, path: str,
                        headers: Dict[str, str], body: bytes):
        path = path.split("?", 1)[0]  # health checks may append queries
        if path == "/-/healthz":
            return await self._respond(writer, 200, "ok")
        if path == "/-/routes":
            return await self._respond(writer, 200, self._routes)
        target = self._match_route(path)
        if target is None:
            # Route-table miss: the background refresh runs on a 1s
            # cadence, so a request racing a fresh serve.run (or a fresh
            # ingress) would 404 spuriously.  Pull the table once,
            # synchronously, before giving up.
            try:
                ctrl = await self._controller()
                self._routes = await ctrl.routes.remote()
            except Exception:
                self._ctrl_lost()
            target = self._match_route(path)
        if target is None:
            return await self._respond(writer, 404,
                                       {"error": f"no route for {path}"})
        try:
            payload = json.loads(body) if body else None
        except json.JSONDecodeError:
            payload = body.decode("utf-8", "replace")
        deadline = self._parse_deadline(headers, payload)
        streaming = ("text/event-stream" in headers.get("accept", "")
                     or (isinstance(payload, dict)
                         and payload.get("stream") is True))
        if streaming:
            return await self._dispatch_stream(writer, target, payload,
                                               deadline)
        try:
            result = await self._call(target, payload, deadline)
            await self._respond(writer, 200, {"result": result})
        except Exception as e:  # noqa: BLE001
            code = self._error_code(e)
            if code == 500:
                logger.exception("serve http: request to %s failed", target)
            await self._respond(writer, code, {"error": repr(e)})

    @staticmethod
    def _error_code(e: BaseException) -> int:
        if resilience.is_deadline_error(e):
            return 504
        if isinstance(e, _Unavailable):
            return 503
        return 500

    # ---------------------------------------------------------- streaming

    @staticmethod
    def _resume_payload(payload, delivered) -> Tuple[object, int]:
        """(payload-for-retry, items-to-skip).  Token-generation payloads
        resume by re-prefill: ``prompt + delivered`` with the remaining
        budget — under greedy decoding the new replica recomputes the
        exact KV state and continues bit-identically.  Anything else
        replays the original request and skips what the client already
        has (correct for any deterministic stream)."""
        if (isinstance(payload, dict)
                and isinstance(payload.get("tokens"), list)
                and isinstance(payload.get("max_new_tokens"), int)
                and delivered
                and all(isinstance(t, int) for t in delivered)):
            return ({**payload,
                     "tokens": list(payload["tokens"]) + list(delivered),
                     "max_new_tokens":
                         payload["max_new_tokens"] - len(delivered)},
                    0)
        return payload, len(delivered)

    async def _dispatch_stream(self, writer, target: str, payload,
                               deadline: Optional[float] = None):
        """SSE token stream with mid-stream failover: chunked transfer,
        one data event per yield, flushed as produced.  Replica death or
        decode stall hands the stream to a healthy replica (see
        _resume_payload); client disconnect / write timeout / terminal
        idle cancel the replica-side generator."""
        policy = resilience.RetryPolicy()
        exclude: set = set()
        delivered: list = []
        headers_sent = False
        per_item_timeout = min(self._stall_s, self._stream_idle)

        async def fail(code: int, message: str):
            if headers_sent:
                await self._write_event(writer, "error",
                                        {"error": message, "code": code})
                await self._write(writer, b"0\r\n\r\n")
            else:
                await self._respond(writer, code, {"error": message})

        while True:
            if self._expired(deadline):
                return await fail(504, "request deadline expired")
            attempt_payload, skip = (payload, 0) if not delivered \
                else self._resume_payload(payload, delivered)
            if (isinstance(attempt_payload, dict)
                    and isinstance(
                        attempt_payload.get("max_new_tokens"), int)
                    and attempt_payload["max_new_tokens"] <= 0):
                # The dead replica had already generated every requested
                # token; nothing left to resume — just finish the stream.
                await self._write_event(writer, "end", {})
                await self._write(writer, b"0\r\n\r\n")
                return
            try:
                gen, rid = await self._call_stream(
                    target, attempt_payload, deadline, exclude)
            except _Unavailable as e:
                if policy.can_retry() and not self._expired(deadline):
                    serve_metrics.bump("router_retries")
                    await asyncio.sleep(policy.next_backoff_s(deadline))
                    continue
                return await fail(503, repr(e))
            except Exception as e:   # noqa: BLE001
                logger.exception("serve http: stream to %s failed to start",
                                 target)
                return await fail(self._error_code(e), repr(e))
            if not headers_sent:
                await self._write(
                    writer,
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: text/event-stream\r\n"
                    b"Cache-Control: no-cache\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n")
                headers_sent = True
            resumed = bool(delivered)
            got_any = False
            try:
                while True:
                    rem = resilience.deadline_remaining(deadline)
                    wait = per_item_timeout if rem is None \
                        else min(per_item_timeout, max(rem, 0.0))
                    try:
                        # Each stream item is a per-yield ObjectRef (the
                        # generator owner side of num_returns="streaming");
                        # awaiting the ref materializes the token.
                        item = await asyncio.wait_for(gen.__anext__(), wait)
                        item = await asyncio.wait_for(
                            _materialize(item), wait)
                    except StopAsyncIteration:
                        self._cb.record_success(rid)
                        await self._write_event(writer, "end", {})
                        await self._write(writer, b"0\r\n\r\n")
                        return
                    except asyncio.TimeoutError:
                        if self._expired(deadline):
                            gen.cancel()
                            return await fail(
                                504, "request deadline expired mid-stream")
                        # Stalled replica: treat like a death and fail
                        # the stream over.
                        raise resilience.DecodeStalled(
                            f"no token for {wait:.1f}s")
                    if resumed and not got_any:
                        serve_metrics.bump("streams_resumed")
                    got_any = True
                    if skip > 0:
                        # Replay path: the client already has this item.
                        skip -= 1
                        delivered.append(item)
                        continue
                    await self._write_event(writer, None, item)
                    delivered.append(item)
            except (ConnectionResetError, BrokenPipeError):
                # Client gone: tear down the replica-side stream so the
                # engine frees its KV pages.
                gen.cancel()
                raise
            except asyncio.TimeoutError:
                # _write timed out (client reading too slowly): same as
                # a disconnect.
                gen.cancel()
                raise
            except Exception as e:   # noqa: BLE001
                gen.cancel()
                if resilience.is_deadline_error(e):
                    return await fail(504, "request deadline expired")
                if not (resilience.is_retryable_error(e)
                        or isinstance(e, resilience.DecodeStalled)):
                    # Handler exception: deterministic, don't retry.
                    return await fail(500, repr(e))
                self._cb.record_failure(rid)
                exclude.add(rid)
                self._replicas.pop(target, None)   # force a refresh
                if not policy.can_retry():
                    return await fail(
                        503, f"retry budget exhausted: {e!r}")
                serve_metrics.bump("router_retries")
                logger.warning(
                    "serve http: stream to %s replica %s broke (%r); "
                    "failing over with %d tokens delivered",
                    target, rid[:8], e, len(delivered))
                await asyncio.sleep(policy.next_backoff_s(deadline))
                continue

    async def _write_event(self, writer, event: Optional[str], data):
        payload = (f"event: {event}\n" if event else "") + \
            "data: " + json.dumps(data, default=repr) + "\n\n"
        raw = payload.encode()
        await self._write(writer,
                          f"{len(raw):x}\r\n".encode() + raw + b"\r\n")

    async def _drain(self, writer):
        from ray_tpu_torch.util import fault_injection
        delay = fault_injection.slow_client_delay_s()
        if delay:
            await asyncio.sleep(delay)
        await writer.drain()

    async def _write(self, writer, data: bytes):
        """All socket writes funnel here: a client that stops reading
        (full TCP window) parks drain(); the timeout converts that into
        an abort instead of an ingress slot leaked forever."""
        writer.write(data)
        await asyncio.wait_for(self._drain(writer), self._write_timeout)

    async def _respond(self, writer, code: int, payload,
                       extra_headers: Optional[Dict[str, str]] = None,
                       close: bool = False):
        if isinstance(payload, str):
            data = payload.encode()
            ctype = "text/plain"
        else:
            data = json.dumps(payload, default=repr).encode()
            ctype = "application/json"
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(code, "ERR")
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (extra_headers or {}).items())
        if close:
            extra += "Connection: close\r\n"
        await self._write(
            writer,
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(data)}\r\n{extra}\r\n".encode() + data)
        if close:
            writer.close()

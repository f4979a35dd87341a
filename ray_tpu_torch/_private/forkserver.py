"""Worker forkserver: prestarted template process forked per worker.

Design analog: reference worker prestart + startup caching
(``src/ray/raylet/worker_pool.cc`` ``PrestartWorkers`` /
``StartWorkerProcess``) — the reference amortizes worker startup by
prestarting idle python processes.  Here the amortization is stronger: ONE
template process pays interpreter boot + ray_tpu_torch imports, then each worker
is an ``os.fork()`` of it (~20 ms vs ~300 ms cold spawn on this box), and
the copy-on-write pages make N workers cost far less RSS than N cold
interpreters.  This is what lets the 1-core box hold a thousands-of-actors
scalability envelope (release scale_bench).

Only workers that hold no card (``CUDA_VISIBLE_DEVICES=""``) fork from the
template: a forked child cannot initialise CUDA once its parent has, so a
GPU worker is a cold interpreter.  The template is single-threaded, never
imports torch and never initialises CUDA, so forking it is safe (no
locks/threads/thread pools/contexts to inherit).

Protocol: one JSON line per connection on a unix socket —
``{"env": {...}, "out": path, "err": path}`` -> ``{"pid": N}``.
Children are reaped by the template (SIGCHLD); the raylet tracks them
through `ForkedProc`, a Popen-shaped shim keyed on pid liveness.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

logger = logging.getLogger(__name__)


def serve(sock_path: str) -> None:
    """Template main loop (runs as `python -m ray_tpu_torch._private.forkserver
    <sock_path>`)."""
    # Die with the raylet (SIGKILLed raylets can't run close()): linux
    # parent-death signal keeps orphaned templates from accumulating.
    try:
        import ctypes
        PR_SET_PDEATHSIG = 1
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(
            PR_SET_PDEATHSIG, signal.SIGTERM)
    except Exception:
        pass

    # Pay the import bill once, pre-fork; worker_main reads all its config
    # from env inside main(), so importing it early is side-effect free.
    import ray_tpu_torch._private.worker_main  # noqa: F401

    def _reap(*_a):
        try:
            while os.waitpid(-1, os.WNOHANG)[0] > 0:
                pass
        except ChildProcessError:
            pass

    signal.signal(signal.SIGCHLD, _reap)
    # Chaos hook (util/fault_injection.py): a test can start a node whose
    # template accepts connections but never replies ("wedge") or replies
    # after a delay ("slow") — the raylet-side client must survive both.
    from ray_tpu_torch.util.fault_injection import forkserver_fault
    fault_mode, fault_delay = forkserver_fault()
    srv = socket.socket(socket.AF_UNIX)
    if os.path.exists(sock_path):
        os.unlink(sock_path)
    srv.bind(sock_path)
    srv.listen(128)
    print("forkserver ready", flush=True)
    wedged: list = []   # held open so a "wedge" client blocks on recv
    while True:
        try:
            conn, _ = srv.accept()
        except InterruptedError:
            continue
        try:
            if fault_mode == "wedge":
                wedged.append(conn)   # accept, never read, never reply
                continue
            with conn:
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = conn.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                if not buf.strip():
                    continue
                if fault_mode == "slow" and fault_delay > 0:
                    time.sleep(fault_delay)
                req = json.loads(buf)
                pid = os.fork()
                if pid == 0:
                    _child(srv, req)   # never returns
                conn.sendall((json.dumps({"pid": pid}) + "\n").encode())
        except Exception as e:  # keep serving: one bad request != outage
            print(f"forkserver request failed: {e!r}", file=sys.stderr,
                  flush=True)


def _child(srv: socket.socket, req: dict) -> None:
    try:
        srv.close()
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        os.environ.clear()
        os.environ.update(req["env"])
        # The template's forkserver_fault() probe populated the fault-spec
        # cache from the TEMPLATE's env; drop it so this worker re-reads
        # RT_FAULT_INJECTION from its own (possibly fault-carrying) env.
        from ray_tpu_torch.util import fault_injection
        fault_injection.clear_spec()
        out = open(req["out"], "ab", buffering=0)
        err = open(req["err"], "ab", buffering=0)
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
        from ray_tpu_torch._private import worker_main
        worker_main.main()
        os._exit(0)
    except SystemExit as e:
        os._exit(int(e.code or 0) if isinstance(e.code, int) else 1)
    except BaseException:
        import traceback
        traceback.print_exc()
        os._exit(1)


class ForkedProc:
    """Popen-shaped handle for a worker forked by the template.  The
    template (not the raylet) is the parent and reaps the exit status, so
    liveness is pid-probed and ``returncode`` reports -1 ("unknown, dead")
    rather than the real code."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        # Pin identity against pid reuse: kernel start-time (field 22 of
        # /proc/pid/stat) is unique per incarnation of a pid.
        self._starttime = self._read_starttime()
        if self._starttime is None:
            self.returncode = -1   # died before we looked

    def _read_starttime(self) -> Optional[int]:
        try:
            with open(f"/proc/{self.pid}/stat") as f:
                stat = f.read()
            # comm may contain spaces/parens: split after the last ')'
            fields = stat[stat.rindex(")") + 2:].split()
            return int(fields[19])   # starttime is field 22 overall
        except (OSError, ValueError):
            return None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            if self._read_starttime() != self._starttime:
                self.returncode = -1
        return self.returncode

    def terminate(self) -> None:
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            self.returncode = self.returncode or -1

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            self.returncode = self.returncode or -1

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"pid:{self.pid}", timeout)
            time.sleep(0.02)
        return self.returncode


class ForkserverClient:
    """Raylet-side handle: lazily starts the template and requests forks.

    Fully asynchronous — every step (template start, unix connect, fork
    request) has its own deadline and NOTHING blocks the calling event
    loop, so a wedged or slow template can never stall raylet heartbeats
    (the old synchronous client busy-waited up to 2s for the socket and
    then sat in a 5s blocking recv; under a spawn storm that starved the
    loop long enough for the GCS to declare a healthy node dead).

    Failure policy: any step missing its deadline returns None (the
    caller cold-spawns — correct, only slower), retires the current
    template GENERATION (kills the process), and arms an exponential
    restart backoff so a template that keeps dying or wedging is retried
    at 0.5s, 1s, 2s, ... up to ``forkserver_backoff_max_s`` instead of
    being hammered every spawn.  A successful fork resets the backoff.
    """

    def __init__(self, sock_path: str, log_path: str):
        self.sock_path = sock_path
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._generation = 0        # bumped every template (re)start
        self._started_at = 0.0      # monotonic start of current generation
        self._failures = 0          # consecutive bad generations
        self._next_start = 0.0      # monotonic gate for the next restart
        self._dying: list = []      # killed templates awaiting reap

    # ------------------------------------------------------------ template

    def _template_alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _cfg(self):
        from ray_tpu_torch._private.config import config
        return config()

    def _mark_bad(self, generation: int, reason: str) -> None:
        """Retire one template generation exactly once: under a spawn
        storm dozens of in-flight requests hit their deadline together,
        and each must not separately kill/backoff (the counter would
        explode to hours)."""
        if generation != self._generation:
            return   # a newer generation is already running
        self._generation += 1
        self._failures += 1
        cfg = self._cfg()
        backoff = min(cfg.forkserver_backoff_max_s,
                      cfg.forkserver_backoff_base_s *
                      (2 ** (self._failures - 1)))
        self._next_start = time.monotonic() + backoff
        logger.warning(
            "forkserver template gen %d retired (%s); restart backoff "
            "%.1fs (failure #%d)", generation, reason, backoff,
            self._failures)
        if self.proc is not None:
            if self.proc.poll() is None:
                try:
                    self.proc.kill()
                except Exception:
                    pass
                # Reaped opportunistically in _ensure — kill() is async
                # and a blocking wait() here would stall the event loop.
                self._dying.append(self.proc)
            self.proc = None

    def _ensure(self) -> bool:
        """Start the template if needed; returns True iff the socket is
        ready RIGHT NOW.  Never waits: a booting template means spawn()
        falls back to a cold start and tries the template next time."""
        self._dying = [p for p in self._dying if p.poll() is None]
        if self._template_alive():
            if os.path.exists(self.sock_path):
                return True
            # Still importing; past the boot grace it is wedged pre-bind.
            if (time.monotonic() - self._started_at
                    > self._cfg().forkserver_boot_grace_s):
                self._mark_bad(self._generation, "never bound its socket")
            return False
        if self.proc is not None:
            # Died on its own (not via _mark_bad): arm the backoff too.
            self._mark_bad(self._generation,
                           f"exited rc={self.proc.returncode}")
        if time.monotonic() < self._next_start:
            return False   # backing off
        # A stale socket from a SIGKILLed predecessor must not read as
        # readiness: unlink first so existence implies the NEW bind.
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
        env = dict(os.environ)
        # The template must never see a card (see module docstring).
        env["CUDA_VISIBLE_DEVICES"] = ""
        log = open(self.log_path, "ab", buffering=0)
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.forkserver",
                 self.sock_path],
                env=env, stdout=log, stderr=log)
        finally:
            log.close()
        self._started_at = time.monotonic()
        return False   # let it boot; callers cold-spawn meanwhile

    # ------------------------------------------------------------ spawning

    async def _await_socket(self) -> bool:
        """Async-wait for a BOOTING template's socket (bounded by the
        boot grace).  Only the calling coroutine waits — the loop keeps
        running heartbeats — so this recovers the old client's
        wait-for-warm-fork behavior (a cold spawn costs ~300ms of CPU vs
        ~20ms for a fork; paying it for every spawn that races template
        boot would bleed whole suites) without its loop stall."""
        grace = self._cfg().forkserver_boot_grace_s
        while (self._template_alive()
               and time.monotonic() - self._started_at < grace):
            if os.path.exists(self.sock_path):
                return True
            await asyncio.sleep(0.05)
        # Cold-spawn fallback (PR-1 design): the rare template respawn
        # Popen is deadline-bounded and beats a wedged fork pipeline.
        return self._ensure()  # rtlint: disable=blocking-in-loop

    async def spawn(self, env: dict, out_path: str, err_path: str
                    ) -> Optional[ForkedProc]:
        if not self._ensure():  # rtlint: disable=blocking-in-loop
            # Distinguish "booting" (wait for the warm template — only
            # this request waits, not the loop) from "down/backing off"
            # (cold-spawn immediately).
            if not self._template_alive() or not await self._await_socket():
                return None
        cfg = self._cfg()
        generation = self._generation
        writer = None
        try:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_unix_connection(self.sock_path),
                    timeout=cfg.forkserver_connect_timeout_s)
            except (OSError, asyncio.TimeoutError) as e:
                self._mark_bad(generation, f"connect failed: {e!r}")
                return None
            try:
                writer.write((json.dumps(
                    {"env": env, "out": out_path, "err": err_path})
                    + "\n").encode())
                await asyncio.wait_for(
                    writer.drain(),
                    timeout=cfg.forkserver_connect_timeout_s)
                line = await asyncio.wait_for(
                    reader.readline(),
                    timeout=cfg.forkserver_spawn_timeout_s)
            except asyncio.TimeoutError:
                self._mark_bad(generation,
                               "no reply within spawn deadline (wedged?)")
                return None
            if not line:
                self._mark_bad(generation, "closed connection mid-request")
                return None
            pid = json.loads(line)["pid"]
            self._failures = 0   # healthy generation: reset the backoff
            return ForkedProc(pid)
        except Exception:
            logger.debug("forkserver spawn failed", exc_info=True)
            return None
        finally:
            if writer is not None:
                writer.close()

    def spawn_sync(self, env: dict, out_path: str, err_path: str
                   ) -> Optional[ForkedProc]:
        """Blocking wrapper for non-asyncio callers (tests, tooling).
        Must NOT be called from a running event loop."""
        return asyncio.run(self.spawn(env, out_path, err_path))

    def close(self) -> None:
        if self.proc is not None:
            try:
                self.proc.terminate()
                self.proc.wait(timeout=3)
            except Exception:
                try:
                    self.proc.kill()
                except Exception:
                    pass
        for p in self._dying:
            try:
                p.wait(timeout=1)
            except Exception:
                pass
        self._dying = []
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass


if __name__ == "__main__":
    serve(sys.argv[1])

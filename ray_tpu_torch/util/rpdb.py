"""Remote pdb: drop into a debugger inside any task/actor from the driver.

Port of ``ray_tpu/util/rpdb.py``.

Design analog: reference ``python/ray/util/rpdb.py`` (``ray.util.pdb
.set_trace`` opens a telnet-able pdb in the worker and advertises it
through the GCS so ``ray debug`` can find and attach to it).  Same shape
here: ``set_trace()`` listens on a free TCP port, registers
host/port/pid/context under a ``debugger:`` KV key, and blocks the task
until a client attaches (or ``RT_DEBUGGER_TIMEOUT_S`` elapses — a CI-safe
default the reference lacks).  ``ray_tpu_torch debug`` (CLI) lists sessions and
bridges the terminal to the chosen one.
"""

from __future__ import annotations

import json
import os
import pdb
import socket
import sys
import time
import uuid
from typing import Dict, List, Optional

_KV_NS = "debugger"


class _SocketIO:
    """File-like adapter pdb can use as stdin/stdout over one socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._rfile = sock.makefile("r", encoding="utf-8", newline="\n")

    def readline(self) -> str:
        return self._rfile.readline()

    def write(self, s: str) -> int:
        self._sock.sendall(s.encode("utf-8"))
        return len(s)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()


class _RemotePdb(pdb.Pdb):
    """Pdb over a socket.  Cleanup (socket close + KV deregister) happens
    in the detach commands, NOT after ``set_trace`` returns — any code
    executed inside set_trace's caller after arming the trace function
    would itself be traced and pdb would stop there instead of in the
    user's frame."""

    def __init__(self, io: _SocketIO, on_detach):
        super().__init__(stdin=io, stdout=io)
        self.use_rawinput = False
        self.prompt = "(rpdb) "
        self._io = io
        self._on_detach = on_detach

    def _detach(self):
        try:
            self._io.close()
        except OSError:
            pass
        self._on_detach()

    def do_continue(self, arg):
        r = super().do_continue(arg)
        self._detach()
        return r
    do_c = do_cont = do_continue

    def do_quit(self, arg):
        r = super().do_quit(arg)
        self._detach()
        return r
    do_q = do_exit = do_quit


def _register(session: Dict) -> None:
    from ray_tpu_torch._private.kv import kv_put
    kv_put(session["id"].encode(), json.dumps(session).encode(), ns=_KV_NS)


def _deregister(session_id: str) -> None:
    try:
        from ray_tpu_torch._private.kv import kv_del
        kv_del(session_id.encode(), ns=_KV_NS)
    except Exception:
        pass  # best effort: driver may already be shutting down


def list_sessions() -> List[Dict]:
    """Active debugger sessions registered in the GCS."""
    from ray_tpu_torch._private.kv import kv_get, kv_keys
    out = []
    for key in kv_keys(ns=_KV_NS):
        raw = kv_get(key, ns=_KV_NS)
        if raw:
            try:
                out.append(json.loads(raw))
            except json.JSONDecodeError:
                pass
    return sorted(out, key=lambda s: s.get("created_at", 0))


def set_trace(*, timeout_s: Optional[float] = None) -> None:
    """Breakpoint: advertise a TCP pdb session and block until a client
    attaches.  ``timeout_s`` (default env RT_DEBUGGER_TIMEOUT_S or 600)
    bounds the wait so an unattended breakpoint can't wedge a job forever.
    """
    if timeout_s is None:
        timeout_s = float(os.environ.get("RT_DEBUGGER_TIMEOUT_S", "600"))
    frame = sys._getframe().f_back
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    host, port = srv.getsockname()
    session_id = uuid.uuid4().hex[:12]
    session = {
        "id": session_id,
        "host": host,
        "port": port,
        "pid": os.getpid(),
        "filename": frame.f_code.co_filename if frame else "?",
        "lineno": frame.f_lineno if frame else 0,
        "function": frame.f_code.co_name if frame else "?",
        "created_at": time.time(),
    }
    registered = False
    try:
        _register(session)
        registered = True
    except Exception:
        # Outside a cluster (plain script): still debuggable by the
        # printed address, like the reference's fallback behavior.
        print(f"rpdb: waiting on {host}:{port} (no GCS to register with)",
              file=sys.stderr, flush=True)
    srv.settimeout(timeout_s)
    try:
        conn, _ = srv.accept()
    except socket.timeout:
        print(f"rpdb: no client attached within {timeout_s}s; continuing",
              file=sys.stderr, flush=True)
        srv.close()
        if registered:
            _deregister(session_id)
        return
    srv.close()
    io = _SocketIO(conn)

    def on_detach(_registered=registered):
        if _registered:
            _deregister(session_id)

    dbg = _RemotePdb(io, on_detach)
    io.write(f"rpdb attached: {session['function']} at "
             f"{session['filename']}:{session['lineno']} "
             f"(pid {session['pid']})\n")
    # MUST be the last statement: arming the trace means every subsequent
    # line in this function would be the "next" line pdb stops on.
    dbg.set_trace(frame)


def connect(session: Dict, *, stdin=None, stdout=None) -> None:
    """Bridge a terminal (or any file pair) to a debugger session.

    Reads commands from ``stdin`` line-by-line, forwards to the worker's
    pdb, and streams its output to ``stdout`` until the session ends.
    """
    import threading
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    sock = socket.create_connection((session["host"], session["port"]),
                                    timeout=10)

    done = threading.Event()

    def pump_out():
        try:
            while True:
                data = sock.recv(4096)
                if not data:
                    break
                stdout.write(data.decode("utf-8", "replace"))
                stdout.flush()
        except OSError:
            pass
        finally:
            done.set()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    try:
        while not done.is_set():
            line = stdin.readline()
            if not line:
                break
            try:
                sock.sendall(line.encode("utf-8"))
            except OSError:
                break
            if line.strip() in ("c", "continue", "q", "quit", "exit"):
                # pdb detaches after these; wait for the stream to close.
                done.wait(timeout=5)
                break
    finally:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()

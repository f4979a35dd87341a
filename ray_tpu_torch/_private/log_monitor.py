"""Worker log capture: per-process log files tailed to the driver.

Design analog: reference ``python/ray/_private/log_monitor.py`` (tails
``/tmp/ray/session_*/logs`` and publishes through GCS pubsub) +
``_private/ray_logging.py`` (driver-side ``print_logs`` with
``(pid=..., ip=...)`` prefixes).

Here the raylet owns the tailing (it already knows every worker it
spawned, so there is no directory-scanning discovery step): each spawned
worker's stdout/stderr are redirected to ``worker-<id>.out|.err`` under the
node's log dir, a single asyncio task polls live files for appended lines,
and batches are published on the GCS ``worker_logs`` channel.  Drivers
subscribe (``ray_tpu_torch.init(log_to_driver=True)``, the default) and echo
lines with a ``(name pid=..., node=...)`` prefix — so a remote task's
``print`` lands on the driver's console the way it does in the reference.

Batches carry the job that currently holds the worker (set on lease grant /
actor spawn), and each driver filters to its own job — reference
``print_logs`` does the same with its job_id subscription filter.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# Cap lines per poll per stream so one log-spamming worker can't monopolize
# the raylet IO loop or blow a single pubsub frame (reference log_monitor
# reads at most 100 lines per file per beat).  The file position only
# advances past what was actually emitted, so excess lines are picked up by
# the next poll instead of being dropped.
MAX_LINES_PER_POLL = 200
MAX_LINE_LEN = 8192
READ_CAP = MAX_LINES_PER_POLL * 256


@dataclass
class _Stream:
    path: str
    stream: str                  # "out" | "err"
    pid: int
    worker_id: str
    actor_id: Optional[str] = None
    job_id: Optional[str] = None
    pos: int = 0                 # first byte not yet emitted
    # Set after emitting the truncated head of an oversized line: drop
    # bytes up to the next newline so the line's remainder is not misread
    # as fresh lines on later polls.
    skip_to_newline: bool = False


@dataclass
class LogMonitor:
    """Tails registered worker log files and publishes new lines.

    ``publish`` is an async callable taking the batch dict; the raylet
    passes a closure that forwards to the GCS ``worker_logs`` channel.
    """

    node_id: str
    publish: "callable"
    streams: Dict[str, List[_Stream]] = field(default_factory=dict)

    def register(self, worker_id: str, pid: int, out_path: str,
                 err_path: str, actor_id: Optional[str] = None,
                 job_id: Optional[str] = None) -> None:
        self.streams[worker_id] = [
            _Stream(out_path, "out", pid, worker_id, actor_id, job_id),
            _Stream(err_path, "err", pid, worker_id, actor_id, job_id),
        ]

    def set_actor(self, worker_id: str, actor_id: Optional[str]) -> None:
        for s in self.streams.get(worker_id, []):
            s.actor_id = actor_id

    def set_job(self, worker_id: str, job_id: Optional[str]) -> None:
        """Tag the job currently leasing this worker (None when idle)."""
        for s in self.streams.get(worker_id, []):
            s.job_id = job_id

    async def unregister(self, worker_id: str) -> None:
        """Final drain, then stop tracking (files stay on disk)."""
        for s in self.streams.pop(worker_id, []):
            # Keep draining until the file is exhausted so a crashing
            # worker's last burst isn't truncated to one poll's cap.
            for _ in range(50):
                if not await self._drain(s):
                    break

    async def poll_once(self) -> None:
        for streams in list(self.streams.values()):
            for s in streams:
                await self._drain(s)

    async def _drain(self, s: _Stream) -> bool:
        """Emit up to MAX_LINES_PER_POLL complete lines; returns True if
        anything was emitted.  s.pos only advances past emitted bytes."""
        try:
            size = os.path.getsize(s.path)
        except OSError:
            return False
        if size <= s.pos:
            return False
        def _read_chunk():
            with open(s.path, "rb") as f:
                f.seek(s.pos)
                return f.read(READ_CAP)

        try:
            # This loop is shared with the raylet — keep even bounded log
            # file reads off it (NFS/cold-page reads block arbitrarily).
            data = await asyncio.get_running_loop().run_in_executor(
                None, _read_chunk)
        except OSError:
            return False
        if not data:
            return False
        if s.skip_to_newline:
            # Discarding the remainder of a previously-truncated line.
            nl = data.find(b"\n")
            if nl < 0:
                s.pos += len(data)
                return False
            s.pos += nl + 1
            data = data[nl + 1:]
            s.skip_to_newline = False
            if not data:
                return False
        lines = data.split(b"\n")
        tail = lines.pop()  # incomplete trailing line (or b"")
        truncated_tail = None
        if len(lines) > MAX_LINES_PER_POLL:
            lines = lines[:MAX_LINES_PER_POLL]
            s.pos += sum(len(ln) + 1 for ln in lines)
        elif not lines and (len(tail) > MAX_LINE_LEN
                            or len(data) == READ_CAP):
            # A single oversized line with no newline yet: emit its head
            # with an explicit truncation marker (dropped bytes must be
            # visible) and skip the rest up to the next newline.
            truncated_tail = (tail[:MAX_LINE_LEN].decode("utf-8", "replace")
                              + " ...[truncated: line exceeded "
                              f"{MAX_LINE_LEN} bytes]")
            s.pos += len(data)
            s.skip_to_newline = True
        else:
            # Oversized-but-accompanied tails wait here too: the complete
            # lines go out now, the tail is re-read next poll and takes
            # the lone-oversized path above if it still has no newline.
            s.pos += len(data) - len(tail)
        if not lines and truncated_tail is None:
            return False
        out = [ln[:MAX_LINE_LEN].decode("utf-8", "replace") for ln in lines]
        if truncated_tail is not None:
            out.append(truncated_tail)
        try:
            await self.publish({
                "node_id": self.node_id,
                "worker_id": s.worker_id,
                "pid": s.pid,
                "actor_id": s.actor_id,
                "job_id": s.job_id,
                "stream": s.stream,
                "lines": out,
            })
        except Exception:
            logger.debug("log publish failed", exc_info=True)
        return True


def default_log_dir(node_id_hex: str) -> str:
    import tempfile
    d = os.environ.get("RT_LOG_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "logs", node_id_hex[:12])
    os.makedirs(d, exist_ok=True)
    return d


def print_to_driver(batch: dict, *, file=None) -> None:
    """Driver-side echo with reference-style prefixes."""
    import sys
    file = file or sys.stderr
    actor = batch.get("actor_id")
    who = f"Actor({actor[:8]}) " if actor else ""
    prefix = (f"({who}pid={batch.get('pid')}, "
              f"node={str(batch.get('node_id'))[:8]})")
    for line in batch.get("lines", []):
        print(f"{prefix} {line}", file=file)
    try:
        file.flush()
    except Exception:
        pass

"""Persistent kernel-autotune cache: JSON-lines, keyed per shape, shared.

Port of ``ray_tpu/autotune/cache.py`` with the same record schema, so
both packages may share one file:

    {"v": 1, "op": "splash_attention", "backend": "cuda:nvidiah10080gbhbm3x1",
     "key": "B=2|S=4096|N=32|H=128|dtype=bfloat16|causal=1",
     "config": {"block_q": 128, "block_kv": 128, ...}, "ms": 11.2,
     "meta": {...}, "ts": 1754380000.0}

Records are keyed by ``(op, backend fingerprint, canonical shape key)``;
for the same full key the LAST line wins, so a re-tune is a plain append.

* **append** is a single ``write()`` to an ``O_APPEND`` fd: concurrent
  processes interleave whole lines, never bytes;
* **rewrite** (compaction) goes through tmp + fsync + ``os.replace``, so a
  kill mid-compact never destroys the only copy;
* **load** skips lines that fail to parse (the torn tail of a crashed
  append) and records of a foreign schema version: a corrupt cache
  degrades to a cold cache and never raises into the kernel call path.

The fingerprint is the port's own (``cuda:<device name>x<count>`` on the
card, ``cpu:torch`` on the CPU), so no record of the JAX package
(``cpu:interpret``, ``tpu:...``) steers the port, even in a shared file.

The file lives at ``$RT_AUTOTUNE_CACHE`` (default
``~/.cache/ray_tpu/autotune.jsonl``).  ``lookup`` re-stats it (throttled)
and reloads when another process appended.  The module imports torch only
inside ``backend_fingerprint``.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.autotune import metrics as _am

SCHEMA_VERSION = 1
DEFAULT_PATH = os.path.join("~", ".cache", "ray_tpu", "autotune.jsonl")

# How often lookup() re-stats the backing file for appends by OTHER
# processes: the stat is cheap, but the kernel call path is hot.
RELOAD_THROTTLE_S = 0.5


def cache_path() -> str:
    return os.path.expanduser(
        os.environ.get("RT_AUTOTUNE_CACHE") or DEFAULT_PATH)


def canon_dtype(dtype: Any) -> str:
    """Canonical dtype string ("bfloat16", "float32", ...) of a string, a
    numpy dtype or a ``torch.dtype`` (``torch.bfloat16`` -> "bfloat16")."""
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    if name == "bfloat16":             # numpy alone does not know it
        return name
    return str(np.dtype(dtype))


def norm_batch(B: int) -> int:
    """Batch is bucketed to the next power of two: timings are much more
    sensitive to (S, N, H, dtype) than to small batch deltas, and the
    bucket keeps one sweep reusable across nearby batches."""
    B = max(1, int(B))
    return 1 << (B - 1).bit_length()


def attention_key(B: int, S: int, N: int, H: int, dtype: Any,
                  causal: bool = True) -> str:
    """Canonical shape key shared by every attention-family op (flash,
    splash, dense, and the variant-crossover records)."""
    return (f"B={norm_batch(B)}|S={int(S)}|N={int(N)}|H={int(H)}"
            f"|dtype={canon_dtype(dtype)}|causal={int(bool(causal))}")


@functools.lru_cache(maxsize=None)
def _cuda_fingerprint(index: int) -> str:
    import torch
    name = torch.cuda.get_device_name(index)
    return f"cuda:{name.lower().replace(' ', '')}x{torch.cuda.device_count()}"


def backend_fingerprint(device: Any = None) -> str:
    """Identity of the measuring backend: ``cuda:<device name, lower-cased,
    no spaces>x<count>`` for a CUDA device, ``cpu:torch`` for the CPU.
    ``device=None`` means the first CUDA card when there is one, else the
    CPU.  A cache tuned on one card model must not drive another."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu:torch"
    if dev.type != "cuda":
        raise ValueError(f"no autotune backend for device {dev}")
    return _cuda_fingerprint(dev.index if dev.index is not None
                             else torch.cuda.current_device())


class AutotuneCache:
    """In-memory view over one JSON-lines cache file (see module doc)."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else cache_path()
        self._lock = threading.RLock()
        self._records: Dict[Tuple[str, str, str], dict] = {}
        self._stat: Optional[Tuple[int, int]] = None
        self._last_stat_t = 0.0
        self.corrupt_lines = 0
        self._load()

    # ------------------------------------------------------------- load

    def _file_stat(self):
        if not os.path.exists(self.path):
            return None
        st = os.stat(self.path)
        return (st.st_size, st.st_mtime_ns)

    def _read(self) -> str:
        """The file's text; an unreadable file reads as an empty cache."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return f.read()
        except OSError:
            return ""

    def _load(self) -> None:
        with self._lock:
            self._records.clear()
            self.corrupt_lines = 0
            self._stat = self._file_stat()
            self._last_stat_t = time.monotonic()
            if self._stat is None:
                return
            for line in self._read().splitlines():
                line = line.strip()
                if not line:
                    continue
                rec = _parse(line)
                if rec is None:
                    # Torn tail of a crashed append, or garbage: a corrupt
                    # line costs itself, not the cache.
                    self.corrupt_lines += 1
                    continue
                if rec.get("v") != SCHEMA_VERSION:
                    continue
                if not all(f in rec for f in ("op", "backend", "key")):
                    self.corrupt_lines += 1
                    continue
                k = (str(rec["op"]), str(rec["backend"]), str(rec["key"]))
                self._records[k] = rec        # last line wins

    def maybe_reload(self) -> None:
        """Pick up appends from other processes (throttled stat)."""
        with self._lock:
            now = time.monotonic()
            if now - self._last_stat_t < RELOAD_THROTTLE_S:
                return
            self._last_stat_t = now
            if self._file_stat() != self._stat:
                self._load()

    # ------------------------------------------------------------ query

    def lookup(self, op: str, key: str, backend: Optional[str] = None,
               count: bool = True) -> Optional[dict]:
        """Best record for (op, backend, key) or None.  ``count=False``
        suppresses the hit/miss counters for repeat consultations the
        caller already memoized once."""
        backend = backend or backend_fingerprint()
        self.maybe_reload()
        with self._lock:
            rec = self._records.get((op, backend, key))
        if count:
            _am.bump("autotune_cache_hits" if rec is not None
                     else "autotune_cache_misses")
        return rec

    def records(self):
        with self._lock:
            return list(self._records.values())

    def __len__(self):
        with self._lock:
            return len(self._records)

    # ------------------------------------------------------------ write

    def put(self, op: str, key: str, config: dict, ms: Optional[float],
            meta: Optional[dict] = None,
            backend: Optional[str] = None) -> dict:
        """Append one record (atomic whole-line append) and adopt it
        in memory."""
        backend = backend or backend_fingerprint()
        rec = {"v": SCHEMA_VERSION, "op": op, "backend": backend,
               "key": key, "config": config,
               "ms": round(float(ms), 4) if ms is not None else None,
               "ts": round(time.time(), 3)}
        if meta:
            rec["meta"] = meta
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # O_APPEND + one write(): concurrent appenders interleave whole
            # lines (a torn line from a crash mid-write is skipped by _load).
            fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, line.encode("utf-8"))
            finally:
                os.close(fd)
            self._records[(op, backend, key)] = rec
            self._stat = self._file_stat()
        return rec

    def rewrite(self) -> int:
        """Compact the file to one line per key (drops superseded records,
        corrupt lines and foreign schema versions).  tmp + fsync + rename:
        a kill mid-compact leaves the old file intact.  Returns the number
        of records written."""
        with self._lock:
            self._load()                      # fold in foreign appends
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in self._records.values():
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.corrupt_lines = 0
            self._stat = self._file_stat()
            return len(self._records)


def _parse(line: str) -> Optional[dict]:
    """The record on one line, or None when the line is not a JSON
    object."""
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


_CACHES: Dict[str, AutotuneCache] = {}
_caches_lock = threading.Lock()


def get_cache(path: Optional[str] = None) -> AutotuneCache:
    """Process-wide cache singleton per resolved path (the env var may
    legitimately change between tests)."""
    p = os.path.expanduser(path) if path else cache_path()
    with _caches_lock:
        c = _CACHES.get(p)
        if c is None:
            c = _CACHES[p] = AutotuneCache(p)
        return c

"""Crash-consistent training checkpoints + the async off-step-loop writer.

The availability story for long training runs is checkpoint/resume (the
Ray paper's checkpoint-based actor recovery, at the scale of "Scalable
Training of Language Models using JAX pjit and TPUv4" — a preempted pool
must cost minutes of recompute, not the run).  Three invariants:

* **Crash consistency.**  A checkpoint directory is committed by its
  ``MANIFEST.json``, written LAST via the spill files' durable pattern
  (tmp → fsync(file) → rename → fsync(dir)).  Shard files are fsynced
  before the manifest is, so a crash at ANY point leaves either no
  manifest (directory ignored as partial) or a complete, verifiable
  checkpoint — never a torn one a naive restore would load.

* **Integrity.**  The manifest records every shard's size + crc32;
  restore re-verifies before handing state back and falls back to the
  previous intact checkpoint on any mismatch (bit-rot, post-commit
  truncation), bumping ``ckpt_corrupt_skipped``.

* **Determinism.**  A checkpoint captures model/optimizer state, host
  RNG state (numpy + python + torch's CPU generator, and the cards'
  generators where CUDA is initialised), and the data-iterator position,
  so a run killed mid-training and resumed produces a bit-identical loss
  trajectory to an uninterrupted run.

Port of ``ray_tpu/train/_internal/checkpoint_store.py``: the state is a
nested dict of tensors (``ray_tpu_torch.air._tensor_tree``), each leaf
written as its raw bytes with its dtype name and shape.

Writes happen **off the step loop**: ``AsyncCheckpointWriter`` snapshots
device tensors to host at a step boundary (the only synchronous cost) and
runs the IO on a single-thread executor with at most one write in
flight — a second ``submit()`` while one is active first waits for it
(bounded backpressure, counted in ``stalls``) so the store can never
accumulate unbounded dirty state.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import random
import re
import shutil
import sys
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air import _tensor_tree
from ray_tpu_torch.train import metrics as train_metrics

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
_CKPT_DIR_RE = re.compile(r"^ckpt-(\d{12})$")


class CorruptCheckpointError(Exception):
    """A checkpoint directory failed verification: missing/torn manifest,
    missing shard, size mismatch, or crc32 mismatch.  Restore treats it
    as 'this checkpoint does not exist' and falls back."""


# -- durable small-file writes (the spill files' pattern) ---------------

def write_file_durable(path: str, data: bytes) -> float:
    """tmp → fsync(file) → rename → fsync(dir).  A crash leaves either
    the previous state or the complete new file, never a torn one.
    Returns seconds spent in fsync."""
    tmp = path + ".tmp"
    fsync_s = 0.0
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        t0 = time.perf_counter()
        os.fsync(f.fileno())
        fsync_s += time.perf_counter() - t0
    os.replace(tmp, path)
    # The rename itself must be durable: without the directory fsync a
    # crash can keep the (fsynced) inode but lose the directory entry.
    t0 = time.perf_counter()
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    fsync_s += time.perf_counter() - t0
    return fsync_s


def write_json_durable(path: str, obj: Any) -> float:
    return write_file_durable(
        path, json.dumps(obj, sort_keys=True).encode("utf-8"))


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


# -- host snapshot / RNG capture ------------------------------------------

def snapshot_to_host(tree: Any) -> Any:
    """Device→host snapshot of a tensor tree at a step boundary: each
    tensor is copied once to a fresh CPU tensor (numpy leaves are
    copied).  This is the only part of a checkpoint that runs on the step
    loop; everything after it is executor IO on the copies."""
    def copy(leaf):
        if _tensor_tree._is_tensor(leaf):
            return leaf.detach().to("cpu", copy=True)
        return leaf.copy()
    return _tensor_tree.map_leaves(copy, tree)


def capture_rng_state() -> Dict[str, Any]:
    """Host RNG state (numpy global + python random) and torch's: the CPU
    generator when torch is imported, each card's generator when CUDA is
    already initialised (a card-less process must not initialise it)."""
    import numpy as np
    state: Dict[str, Any] = {"numpy": np.random.get_state(),
                             "python": random.getstate()}
    torch = sys.modules.get("torch")
    if torch is not None:
        state["torch"] = torch.get_rng_state()
        if torch.cuda.is_initialized():
            state["torch_cuda"] = torch.cuda.get_rng_state_all()
    return state


def restore_rng_state(state: Dict[str, Any]) -> None:
    import numpy as np
    if "numpy" in state:
        np.random.set_state(state["numpy"])
    if "python" in state:
        random.setstate(state["python"])
    if "torch" in state:
        import torch
        torch.set_rng_state(state["torch"])
        if "torch_cuda" in state:
            torch.cuda.set_rng_state_all(state["torch_cuda"])


@dataclass
class RestoredCheckpoint:
    """What restore hands back: verified state + everything needed for a
    deterministic resume."""

    step: int
    path: str
    tree: Any
    rng_state: Optional[Dict[str, Any]] = None
    data_state: Optional[Any] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def restore_host_rng(self) -> None:
        if self.rng_state is not None:
            restore_rng_state(self.rng_state)


class CheckpointStore:
    """A directory of ``ckpt-<step>`` checkpoints with manifest-committed
    writes and CRC-verified restores.

    Layout per checkpoint::

        ckpt-000000000042/
          leaf_0.bin ... leaf_N.bin   # tensor leaves (raw bytes)
          tree.json                   # structure, each leaf's dtype + shape
          aux.pkl                     # rng state / data-iterator position
          MANIFEST.json               # written LAST: step + files{size,crc32}
    """

    def __init__(self, root: str, keep: int = 2):
        self.root = os.path.abspath(root)
        self.keep = max(1, int(keep))
        os.makedirs(self.root, exist_ok=True)

    # -- write ------------------------------------------------------------

    def save(self, step: int, tree: Any, *,
             rng_state: Optional[Dict[str, Any]] = None,
             data_state: Optional[Any] = None,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Write one checkpoint durably; returns its directory path.
        ``tree`` must already be host tensors (see snapshot_to_host).
        Blocking — call from AsyncCheckpointWriter's executor, not the
        step loop."""
        from ray_tpu_torch.util import fault_injection

        t0 = time.perf_counter()
        name = f"ckpt-{step:012d}"
        path = os.path.join(self.root, name)
        tmp_dir = path + ".writing"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir)

        slow_s = fault_injection.slow_ckpt_io_s()
        leaves, spec = _tensor_tree.flatten(tree)
        files: Dict[str, Dict[str, int]] = {}

        def _write_shard(fname: str, blob: bytes) -> None:
            if slow_s > 0.0:
                time.sleep(slow_s)
            write_file_durable(os.path.join(tmp_dir, fname), blob)
            files[fname] = {"size": len(blob),
                            "crc32": zlib.crc32(blob) & 0xFFFFFFFF}

        infos = []
        for i, leaf in enumerate(leaves):
            blob, info = _tensor_tree.encode_leaf(leaf)
            _write_shard(f"leaf_{i}.bin", blob)
            infos.append(info)
        _write_shard("tree.json", json.dumps(
            {"structure": spec, "leaves": infos}).encode("utf-8"))
        aux = {"rng_state": rng_state, "data_state": data_state}
        _write_shard("aux.pkl", pickle.dumps(aux, pickle.HIGHEST_PROTOCOL))

        # Commit point: the manifest is the LAST durable write; a crash
        # anywhere above leaves a manifest-less directory that restore
        # ignores and a later save of the same step overwrites.
        manifest = {"format": 1, "step": int(step),
                    "num_leaves": len(leaves),
                    "files": files, "meta": meta or {},
                    "created_at": time.time()}
        write_json_durable(os.path.join(tmp_dir, MANIFEST_NAME), manifest)
        # Publish under the canonical name.  rename(dir) is atomic on the
        # same filesystem; the manifest inside is already durable.
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp_dir, path)
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

        self._gc()
        train_metrics.bump("ckpt_write_ms",
                           (time.perf_counter() - t0) * 1000.0)
        return path

    def _gc(self) -> None:
        """Keep the newest ``keep`` committed checkpoints (never fewer —
        the previous intact one is the corruption fallback) and sweep
        orphaned .writing/.tmp debris from crashed writers."""
        steps = self.list_steps()
        for step in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"ckpt-{step:012d}"),
                          ignore_errors=True)
        for name in os.listdir(self.root):
            if name.endswith(".writing") or name.endswith(".tmp"):
                full = os.path.join(self.root, name)
                # A concurrent writer owns at most the newest one; stale
                # debris is from a crashed process.
                if time.time() - os.path.getmtime(full) > 300:
                    shutil.rmtree(full, ignore_errors=True)

    # -- read -------------------------------------------------------------

    def list_steps(self) -> List[int]:
        """Committed (manifest-bearing) checkpoint steps, ascending."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in names:
            m = _CKPT_DIR_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.root, name, MANIFEST_NAME)):
                out.append(int(m.group(1)))
        return sorted(out)

    def verify(self, step: int) -> Dict[str, Any]:
        """Verify one checkpoint's manifest + every shard CRC; returns the
        manifest.  Raises CorruptCheckpointError on any mismatch."""
        path = os.path.join(self.root, f"ckpt-{step:012d}")
        return verify_checkpoint_dir(path)

    def restore(self, step: int) -> RestoredCheckpoint:
        """Load one verified checkpoint (raises CorruptCheckpointError)."""
        t0 = time.perf_counter()
        path = os.path.join(self.root, f"ckpt-{step:012d}")
        manifest = verify_checkpoint_dir(path)
        with open(os.path.join(path, "tree.json"), "rb") as f:
            layout = json.loads(f.read().decode("utf-8"))
        leaves = []
        for i, info in enumerate(layout["leaves"]):
            with open(os.path.join(path, f"leaf_{i}.bin"), "rb") as f:
                leaves.append(_tensor_tree.decode_leaf(f.read(), info))
        tree = _tensor_tree.unflatten(leaves, layout["structure"])
        with open(os.path.join(path, "aux.pkl"), "rb") as f:
            aux = pickle.load(f)
        train_metrics.bump("ckpt_restore_ms",
                           (time.perf_counter() - t0) * 1000.0)
        return RestoredCheckpoint(
            step=int(manifest["step"]), path=path, tree=tree,
            rng_state=aux.get("rng_state"),
            data_state=aux.get("data_state"),
            meta=manifest.get("meta", {}))

    def restore_latest(self) -> Optional[RestoredCheckpoint]:
        """Newest checkpoint that verifies; corrupt/partial ones are
        skipped (counted in ``ckpt_corrupt_skipped``) and the previous
        intact one is returned instead.  None when nothing restorable."""
        for step in reversed(self.list_steps()):
            try:
                return self.restore(step)
            except (CorruptCheckpointError, OSError, ValueError,
                    pickle.UnpicklingError) as e:
                train_metrics.bump("ckpt_corrupt_skipped")
                logger.warning(
                    "checkpoint step=%d failed verification (%s); falling "
                    "back to the previous intact one", step, e)
        return None


def verify_checkpoint_dir(path: str) -> Dict[str, Any]:
    """Manifest + CRC verification of one checkpoint directory; returns
    the parsed manifest.  Raises CorruptCheckpointError when the manifest
    is missing/torn or any listed shard is missing, short, or fails its
    crc32."""
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except FileNotFoundError:
        raise CorruptCheckpointError(
            f"{path}: no {MANIFEST_NAME} (partial write)") from None
    except (OSError, ValueError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(f"{path}: torn manifest: {e}") from e
    files = manifest.get("files")
    if not isinstance(files, dict):
        raise CorruptCheckpointError(f"{path}: manifest lists no files")
    for fname, rec in files.items():
        fpath = os.path.join(path, fname)
        try:
            size = os.path.getsize(fpath)
        except OSError:
            raise CorruptCheckpointError(
                f"{path}: shard {fname} missing") from None
        if size != int(rec["size"]):
            raise CorruptCheckpointError(
                f"{path}: shard {fname} is {size} bytes, manifest says "
                f"{rec['size']} (torn write)")
        if file_crc32(fpath) != int(rec["crc32"]):
            raise CorruptCheckpointError(
                f"{path}: shard {fname} failed crc32 verification")
    return manifest


class AsyncCheckpointWriter:
    """Checkpoint IO off the step loop, at most one write in flight.

    ``submit()`` is called from the training thread at a step boundary
    with an ALREADY host-snapshotted tree (snapshot_to_host is the
    caller's only synchronous cost).  The write runs on a dedicated
    single-thread executor; a second submit while one is in flight first
    waits for it — the loop stalls only when IO is slower than the
    checkpoint cadence, and ``stalls`` counts exactly those events so
    tests and the release bench can assert on overlap."""

    def __init__(self, store: CheckpointStore):
        self.store = store
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="rtt-ckpt-io")
        self._inflight: Optional[Future] = None
        self.stalls = 0
        self.submitted = 0

    def in_flight(self) -> bool:
        return self._inflight is not None and not self._inflight.done()

    def submit(self, step: int, host_tree: Any, **save_kwargs) -> Future:
        if self.in_flight():
            self.stalls += 1
            self._inflight.result()      # backpressure: one in flight
        elif self._inflight is not None:
            self._inflight.result()      # surface a failed previous write
        self._inflight = self._ex.submit(
            self.store.save, step, host_tree, **save_kwargs)
        self.submitted += 1
        return self._inflight

    def wait(self) -> None:
        """Block until the in-flight write (if any) is durable; re-raises
        its error.  Call before reporting a checkpoint as complete and
        before clean preemption exit."""
        if self._inflight is not None:
            self._inflight.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._ex.shutdown(wait=True)

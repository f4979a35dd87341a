"""Device ingest: numpy batches onto the card, the next one's copy in
flight while the caller's step runs on the current one.

Port of the reference's ``Dataset.iter_device_batches``
(``ray_tpu/data/dataset.py:1082-1107``), where ``jax.device_put`` returns
at once and copies in the background.  Here each column has two
page-locked host buffers, sized at the first batch and reused in turn.  A
batch is written into its slot's buffers, copied to the card with
``non_blocking=True`` on a side stream, and an event is recorded after
the copy.  Three rules keep that right:

* a slot's buffers are written again only once the event of the slot's
  previous copy has completed (the host waits on it): a pinned buffer
  overwritten while its copy is in flight corrupts a batch with no error;
* the consumer's stream waits on a batch's event before it reads the
  batch;
* the batch's device memory is recorded on the consumer's stream
  (``record_stream``), so the caching allocator does not hand it out for
  the side stream's next copy while the consumer's work on it is queued.

``sharding=(mesh, spec)`` (the reference's ``NamedSharding``) lands each
batch as DTensors on the mesh: every rank holds the whole host batch and
copies only its own shard (``placements_for`` gives the placements).
``device="cpu"`` yields CPU tensors (copies, never pinned).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np


def _torch_dtype(name: str, arr: np.ndarray):
    import torch
    try:
        return torch.from_numpy(np.empty(0, arr.dtype)).dtype
    except TypeError:
        raise TypeError(f"column {name!r} has dtype {arr.dtype}, which has "
                        f"no torch dtype; iter_device_batches takes numeric "
                        f"columns") from None


class PinnedCopier:
    """Copies dict batches of numpy arrays to one card through two pinned
    staging buffers per column, on a side stream (see the module
    docstring).  ``pinned_allocs`` counts the buffers allocated (two per
    column, unless a batch outgrows them), ``bytes_copied`` the bytes sent
    to the card."""

    SLOTS = 2

    def __init__(self, device):
        import torch
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._buffers: Dict[Tuple[str, int], Any] = {}
        self._done: List[Any] = [None] * self.SLOTS  # slot -> last copy's event
        self._slot = 0
        self._timing: List[Tuple[Any, Any]] = []
        self.pinned_allocs = 0
        self.bytes_copied = 0

    def _staging(self, key, arr: np.ndarray):
        import torch
        dtype = _torch_dtype(key[0], arr)
        buf = self._buffers.get(key)
        if (buf is None or buf.dtype != dtype or buf.shape[0] < arr.shape[0]
                or tuple(buf.shape[1:]) != arr.shape[1:]):
            buf = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            self._buffers[key] = buf
            self.pinned_allocs += 1
        return buf[:arr.shape[0]]

    def submit(self, arrays: Dict[str, np.ndarray]):
        """Stage ``arrays`` and start their copies; returns the pending
        batch for ``hand_over``."""
        import torch
        slot, self._slot = self._slot, (self._slot + 1) % self.SLOTS
        if self._done[slot] is not None:
            self._done[slot].synchronize()   # the slot's last copy has read it
        staged = {}
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            staged[name] = self._staging((name, slot), arr)
            np.copyto(staged[name].numpy(), arr)
            self.bytes_copied += arr.nbytes
        # The events time the copies alone: the staging above and the
        # allocations here are host work.
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            out = {name: torch.empty(host.shape, dtype=host.dtype,
                                     device=self.device)
                   for name, host in staged.items()}
            start.record(self.stream)
            for name, host in staged.items():
                out[name].copy_(host, non_blocking=True)
            done.record(self.stream)
        self._done[slot] = done
        self._timing.append((start, done))
        return out, done

    def hand_over(self, pending):
        """The batch, safe to use on the caller's current stream."""
        import torch
        out, done = pending
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for t in out.values():
            t.record_stream(current)
        return out

    def copy_ms(self) -> List[float]:
        """Each copy's device time (waits for the copies to finish)."""
        self.stream.synchronize()
        return [a.elapsed_time(b) for a, b in self._timing]


class _CpuCopier:
    """``device="cpu"``: each batch a fresh CPU tensor per column."""

    def __init__(self):
        self.bytes_copied = 0
        self.pinned_allocs = 0

    def submit(self, arrays):
        import torch
        out = {}
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            _torch_dtype(name, arr)
            out[name] = torch.from_numpy(np.array(arr, copy=True))
            self.bytes_copied += arr.nbytes
        return out

    def hand_over(self, pending):
        return pending

    def copy_ms(self) -> List[float]:
        return []


def _local_slices(shape, mesh, placements):
    """The index of this rank's shard of an array of ``shape``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


class DeviceBatches:
    """The iterator ``Dataset.iter_device_batches`` returns.  Besides the
    batches it keeps ``batches`` (yielded so far), ``copies_submitted``
    (started so far: one ahead of the caller while batches remain),
    ``submit_ms`` (each batch's host time to stage it and start its copy)
    and the copier's ``bytes_copied``, ``pinned_allocs`` and
    ``copy_ms()``."""

    def __init__(self, host_batches: Iterator[Dict[str, np.ndarray]],
                 device=None, sharding=None):
        from ray_tpu_torch import resolve_device
        self._placements = None
        if sharding is not None:
            from ray_tpu_torch.parallel.mesh import active_mesh
            from ray_tpu_torch.parallel.sharding import placements_for
            mesh, spec = sharding
            self._mesh = active_mesh(mesh)
            self._placements = placements_for(self._mesh, tuple(spec))
            kind = self._mesh.device_type
            if device is not None and resolve_device(device).type != kind:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"device type {kind!r}")
            if device is None and kind == "cpu":
                device = "cpu"          # the mesh names the CPU itself
        self.device = resolve_device(device)
        self.copier = (PinnedCopier(self.device)
                       if self.device.type == "cuda" else _CpuCopier())
        self._host = host_batches
        self._gen = self._run()
        self.batches = 0
        self.copies_submitted = 0
        self.submit_ms: List[float] = []

    @property
    def bytes_copied(self) -> int:
        return self.copier.bytes_copied

    @property
    def pinned_allocs(self) -> int:
        return self.copier.pinned_allocs

    def copy_ms(self) -> List[float]:
        return self.copier.copy_ms()

    def _submit(self, batch: Dict[str, np.ndarray]):
        t0 = time.perf_counter()
        shapes = None
        if self._placements is not None:
            shapes = {k: np.shape(v) for k, v in batch.items()}
            batch = {k: np.asarray(v)[_local_slices(np.shape(v), self._mesh,
                                                    self._placements)]
                     for k, v in batch.items()}
        pending = self.copier.submit(batch)
        self.copies_submitted += 1
        self.submit_ms.append((time.perf_counter() - t0) * 1e3)
        return pending, shapes

    def _place(self, pending, shapes):
        out = self.copier.hand_over(pending)
        if shapes is None:
            return out
        from torch.distributed.tensor import DTensor
        return {k: DTensor.from_local(
            v, self._mesh, self._placements, run_check=False,
            shape=shapes[k], stride=_contiguous_strides(shapes[k]))
            for k, v in out.items()}

    def _run(self):
        prev = None
        for batch in self._host:
            nxt = self._submit(batch)      # its copy runs during the
            if prev is not None:           # caller's step on ``prev``
                yield self._place(*prev)
            prev = nxt
        if prev is not None:
            yield self._place(*prev)

    def __iter__(self):
        return self

    def __next__(self):
        out = next(self._gen)
        self.batches += 1
        return out


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, acc = [], 1
    for n in reversed(tuple(shape)):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))

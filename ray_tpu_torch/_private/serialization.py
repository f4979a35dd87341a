"""Serialization of task args/returns and put objects.

Design analog: reference ``python/ray/_private/serialization.py``
(SerializationContext) + vendored cloudpickle.  Same core trick: pickle
protocol 5 with out-of-band buffers, so numpy array and torch tensor
payloads are split from the pickle stream and written contiguously into
shared memory.

On-disk/shm layout of a serialized object:

    [u32 magic][u32 nbufs][u64 pickle_len][u64 buf_len * nbufs]
    [pickle bytes][pad to 64][buf 0][pad to 64][buf 1]...

numpy arrays are rebuilt as read-only views over the shm mapping
(zero-copy, like the reference's plasma-backed numpy views).

torch tensors travel as their raw bytes (out of band) plus the dtype name
and shape, so every dtype survives, bf16 included, which numpy lacks.  A
tensor is made contiguous and detached (``requires_grad`` is dropped);
a CUDA tensor is staged to host on serialize.  On deserialize the bytes
are copied: a tensor cannot be made read-only, and a view of the mapping
would let an in-place op overwrite the stored object under every other
reader.  A tensor that left a CUDA device comes back on the receiver's
current CUDA device when that process sees a card, else on the CPU (as a
JAX array lands on the receiver's default backend).
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from collections import ChainMap
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import cloudpickle

_MAGIC = 0x52545031  # "RTP1"
_ALIGN = 64
_HEAD = struct.Struct("<II")


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class SerializedObject:
    """A serialized value as a list of payload segments (for vectored writes)."""

    __slots__ = ("segments", "total_size", "inband_size")

    def __init__(self, segments: List[bytes], inband_size: int):
        self.segments = segments
        self.total_size = sum(len(s) for s in segments)
        self.inband_size = inband_size

    def to_bytes(self) -> bytes:
        return b"".join(bytes(s) for s in self.segments)


# type -> reducer, consulted before cloudpickle's own table.  Filled with
# the tensor reducers once torch is imported in this process; the global
# copyreg table is left alone, so torch.save and torch.distributed's
# pickling keep their own behaviour.
_REDUCERS: Dict[type, Callable] = {}


class _Pickler(cloudpickle.Pickler):
    dispatch_table = ChainMap(_REDUCERS, cloudpickle.Pickler.dispatch_table)


class SerializationContext:
    """Pluggable reducers + pack/unpack of the shm layout."""

    def __init__(self):
        self._custom_reducers = {}
        self._torch_registered = False

    def register_reducer(self, cls, reducer: Callable):
        self._custom_reducers[cls] = reducer

    def _maybe_register_torch(self):
        # Lazy: never import torch ourselves (daemons and the forkserver
        # template must not pay the import, and a worker that holds no
        # card must not touch CUDA).
        if not self._torch_registered and "torch" in sys.modules:
            self._torch_registered = True
            _register_torch_reducers()

    # -- serialize --

    # Exact builtin scalar types take the C pickler directly: a cloudpickle
    # dumps() builds a CloudPickler per call (~15us); plain pickle is
    # sub-microsecond.  Only EXACT types — subclasses or containers may
    # reach objects that need cloudpickle's reducers (closures, torch
    # tensors), so they keep the general path.
    _PLAIN_TYPES = (type(None), bool, int, float, str, bytes)

    def serialize(self, value: Any) -> SerializedObject:
        self._maybe_register_torch()
        buffers: List[pickle.PickleBuffer] = []
        if type(value) in self._PLAIN_TYPES:
            payload = pickle.dumps(value, protocol=5)
        else:
            with io.BytesIO() as f:
                _Pickler(f, protocol=5,
                         buffer_callback=buffers.append).dump(value)
                payload = f.getvalue()
        raws = [b.raw() for b in buffers]
        header = _HEAD.pack(_MAGIC, len(raws))
        lens = struct.pack(f"<{len(raws) + 1}Q", len(payload), *[r.nbytes for r in raws])
        segments: List[bytes] = [header, lens, payload]
        pos = len(header) + len(lens) + len(payload)
        for r in raws:
            padding = _pad(pos) - pos
            if padding:
                segments.append(b"\x00" * padding)
                pos += padding
            segments.append(r)
            pos += r.nbytes
        return SerializedObject(segments, inband_size=len(payload))

    # -- deserialize --

    def deserialize(self, data: memoryview) -> Any:
        data = memoryview(data)
        magic, nbufs = _HEAD.unpack_from(data, 0)
        if magic != _MAGIC:
            raise ValueError("corrupt serialized object (bad magic)")
        off = _HEAD.size
        lens = struct.unpack_from(f"<{nbufs + 1}Q", data, off)
        off += 8 * (nbufs + 1)
        pickle_len, buf_lens = lens[0], lens[1:]
        payload = data[off:off + pickle_len]
        pos = off + pickle_len
        bufs = []
        for blen in buf_lens:
            pos = _pad(pos)
            bufs.append(data[pos:pos + blen])
            pos += blen
        return pickle.loads(payload, buffers=bufs)

    def deserialize_bytes(self, data: bytes) -> Any:
        return self.deserialize(memoryview(data))


_default_context: Optional[SerializationContext] = None


def get_context() -> SerializationContext:
    global _default_context
    if _default_context is None:
        _default_context = SerializationContext()
    return _default_context


def _rebuild_tensor(buf, dtype: str, shape, from_cuda: bool):
    """A new tensor holding a copy of ``buf``'s bytes (see the module
    docstring for where it lands)."""
    import warnings

    import torch
    nbytes = memoryview(buf).nbytes
    if nbytes == 0:
        flat = torch.empty(0, dtype=torch.uint8)
    else:
        with warnings.catch_warnings():
            # A read-only buffer warns; the view is copied before anyone
            # can write through it.
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(buf, dtype=torch.uint8)
    if from_cuda and torch.cuda.is_available():
        flat = flat.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        flat = flat.clone()
    return flat.view(getattr(torch, dtype)).reshape(shape)


def _reduce_tensor(t):
    import torch
    if t.layout != torch.strided or t.device.type not in ("cpu", "cuda"):
        raise TypeError(f"cannot serialize a {t.layout} tensor on "
                        f"{t.device}: only strided CPU and CUDA tensors")
    from_cuda = t.device.type == "cuda"
    host = t.detach().cpu().contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(raw),
                             str(host.dtype).removeprefix("torch."),
                             tuple(host.shape), from_cuda)


def _register_torch_reducers():
    import torch
    _REDUCERS[torch.Tensor] = _reduce_tensor
    _REDUCERS[torch.nn.Parameter] = _reduce_tensor

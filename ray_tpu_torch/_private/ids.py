"""Unique identifiers for jobs, tasks, actors, objects, nodes, placement groups.

Design analog: reference ``src/ray/common/id.h`` (JobID/ActorID/TaskID/ObjectID bit
layouts).  We keep the same conceptual hierarchy -- an ObjectID embeds the TaskID
that produced it plus a return index; an ActorID embeds the JobID -- but use a
flat 16-byte random layout with typed wrappers rather than the reference's packed
bit-fields, since we never need to recover the parent from the bytes on the hot
path (the owner address rides alongside the id in our protocol).
"""

from __future__ import annotations

import os
import threading

_ID_LENGTH = 16


class BaseID:
    """A 16-byte identifier with a cached hex form."""

    __slots__ = ("_bytes", "_hex")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != _ID_LENGTH:
            raise ValueError(f"expected {_ID_LENGTH} bytes, got {len(id_bytes)}")
        self._bytes = id_bytes
        self._hex = id_bytes.hex()

    @classmethod
    def from_random(cls):
        return cls(os.urandom(_ID_LENGTH))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_LENGTH)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_LENGTH

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._hex

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(self) is type(other) and self._bytes == other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._hex[:12]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class ObjectID(BaseID):
    """Object ids are derived from (task id, return index) so that lineage
    reconstruction can map an object back to the task that produces it."""

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        raw = bytearray(task_id.binary())
        raw[-2] = (index >> 8) & 0xFF
        raw[-1] = index & 0xFF
        # Flip a high bit so a return-object id never collides with a task id
        # used directly as a put-object id.
        raw[0] ^= 0x80
        return cls(bytes(raw))

    def task_id(self) -> TaskID:
        raw = bytearray(self._bytes)
        raw[0] ^= 0x80
        raw[-2] = 0
        raw[-1] = 0
        return TaskID(bytes(raw))

    def return_index(self) -> int:
        return (self._bytes[-2] << 8) | self._bytes[-1]


class _TaskIDGenerator:
    """Deterministic per-process task-id stream (random base + counter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._base = os.urandom(_ID_LENGTH - 4)
        self._counter = 0

    def next(self) -> TaskID:
        with self._lock:
            self._counter += 1
            c = self._counter
        # Low two bytes stay zero: ObjectID.for_task_return owns that index
        # slot; the counter rides bytes 10..13.
        return TaskID(self._base[:10] + c.to_bytes(4, "big") + b"\x00\x00")


task_id_generator = _TaskIDGenerator()

"""Python client for the native shared-memory object store.

Design analog: reference ``src/ray/core_worker/store_provider/plasma_store_provider.h``
(CoreWorkerPlasmaStoreProvider) + the plasma client protocol.  Unlike the
reference there is no store server socket: every process attaches the segment
and calls into the native library directly (see object_store.cc for rationale).

Zero-copy reads: ``get_buffers`` returns memoryviews directly over the shm
mapping; the deserializer builds numpy arrays on top of them without copying,
matching plasma's mmap zero-copy read path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

from ray_tpu_torch._native.build import ensure_built
from ray_tpu_torch._private.ids import ObjectID

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.store_create.restype = ctypes.c_void_p
        lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.store_attach.restype = ctypes.c_void_p
        lib.store_attach.argtypes = [ctypes.c_char_p]
        lib.store_detach.argtypes = [ctypes.c_void_p]
        lib.store_create_object.restype = ctypes.c_int
        lib.store_create_object.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.store_seal.restype = ctypes.c_int
        lib.store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.store_get.restype = ctypes.c_int
        lib.store_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.store_release.restype = ctypes.c_int
        lib.store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.store_delete_object.restype = ctypes.c_int
        lib.store_delete_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.store_contains.restype = ctypes.c_int
        lib.store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.store_list_sealed.restype = ctypes.c_uint64
        lib.store_list_sealed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint64,
        ]
        lib.store_pointer.restype = ctypes.c_void_p
        lib.store_pointer.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        for name in ("store_capacity", "store_bytes_used", "store_num_objects",
                     "store_num_evictions"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class ObjectStoreFullError(Exception):
    pass


def segment_name(node_id_hex: str, pid: Optional[int] = None) -> str:
    """Canonical shm segment name: ``/rtt_<owner-pid>_<node12>``.

    The ``rtt_`` prefix is the port's own: no pattern of the JAX
    package's sweeper (``rt_<pid>_<hex>``, ``rt_<hex12>``) matches it, and
    this module's sweeper matches nothing but it, so clusters of the two
    packages on one host leave each other's segments alone.

    The owner pid is embedded so a later session can tell a live segment
    from an orphan without attaching to it (reference analog: plasma store
    teardown in ``src/ray/object_manager/plasma/store_runner.cc`` — the
    store process owns and removes its socket/shm on exit; we additionally
    survive SIGKILL via ``sweep_orphan_segments``).
    """
    import os
    return f"/rtt_{pid or os.getpid()}_{node_id_hex[:12]}"


# Legacy (pre pid-keyed) names carry no owner information; only sweep them
# once they are plausibly not backing a live pre-upgrade session.
_LEGACY_MIN_AGE_S = 3600.0


def sweep_dead_owner_entries(directory: str, pid_pattern: str,
                             legacy_pattern: str, remove) -> int:
    """Shared dead-owner sweep over one directory (shm segments and spill
    dirs use identical logic; keep the liveness rules in ONE place).

    ``pid_pattern`` must capture the owner pid in group 1 — the entry is
    removed iff /proc/<pid> is gone.  ``legacy_pattern`` entries have no
    owner pid; they are removed only when older than _LEGACY_MIN_AGE_S, so
    a still-running pre-upgrade session on the same host is not swept out
    from under its workers mid-transition.  Never raises; returns the
    number of entries removed.
    """
    import os
    import re
    import time
    removed = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0
    now = time.time()
    for entry in entries:
        path = os.path.join(directory, entry)
        m = re.fullmatch(pid_pattern, entry)
        dead = False
        if m:
            dead = not os.path.exists(f"/proc/{m.group(1)}")
        elif re.fullmatch(legacy_pattern, entry):
            try:
                dead = now - os.stat(path).st_mtime > _LEGACY_MIN_AGE_S
            except OSError:
                continue
        if dead:
            try:
                remove(path)
                removed += 1
            except OSError:
                pass
    return removed


def sweep_orphan_segments() -> int:
    """Unlink /dev/shm ``rtt_*`` segments whose owning raylet is dead.

    Called at raylet startup: a SIGKILLed raylet leaks its segment (atexit
    never runs), and on long-lived hosts those leaks accumulate into GBs
    (614 orphans / 9.4 GB observed).  Reference analog: plasma store
    teardown, ``src/ray/object_manager/plasma/store_runner.cc``.
    """
    import os
    return sweep_dead_owner_entries(
        "/dev/shm", r"rtt_(\d+)_[0-9a-f]+", r"rtt_[0-9a-f]{12}", os.unlink)


def _check_shm_room(capacity: int) -> None:
    """The native store maps its whole segment at creation, but tmpfs
    backs pages only when they are written: a store larger than the free
    room of /dev/shm would die of SIGBUS on a later write, not raise.
    Refuse it here instead."""
    import os
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    if capacity > free:
        raise ObjectStoreFullError(
            f"object store of {capacity} bytes does not fit in /dev/shm "
            f"({free} bytes free); pass a smaller object_store_memory or "
            f"enlarge /dev/shm")


class PlasmaClient:
    """Per-process handle to the host-local shared object store."""

    def __init__(self, name: str, capacity: Optional[int] = None, create: bool = False,
                 num_slots: int = 1 << 16):
        self._lib = _load()
        self.name = name
        if create:
            _check_shm_room(capacity)
            self._h = self._lib.store_create(name.encode(), capacity, num_slots)
        else:
            self._h = self._lib.store_attach(name.encode())
        if not self._h:
            raise RuntimeError(f"failed to {'create' if create else 'attach'} store {name}")

    # -- lifecycle --

    def close(self):
        if self._h:
            self._lib.store_detach(self._h)
            self._h = None

    # -- object ops --

    def create(self, object_id: ObjectID, size: int,
               allow_evict: bool = True) -> memoryview:
        """Allocate an unsealed object; returns a writable view of its payload.

        allow_evict=False refuses allocations that would need LRU eviction
        (best-effort: checks byte headroom, not fragmentation) and raises
        ObjectStoreFullError instead -- used for primary copies, which must
        be *spilled* to disk rather than silently dropped (reference: plasma
        pins primary copies; eviction only takes secondary copies)."""
        if not allow_evict:
            st = self.stats()
            if st["bytes_used"] + size > st["capacity"]:
                raise ObjectStoreFullError(
                    f"{size} bytes would exceed store capacity "
                    f"({st['bytes_used']}/{st['capacity']} used) and "
                    f"eviction is disallowed for primary copies")
        off = ctypes.c_uint64()
        rc = self._lib.store_create_object(self._h, object_id.binary(), size,
                                           ctypes.byref(off))
        if rc == -2:
            raise ObjectStoreFullError(
                f"object of {size} bytes does not fit in store {self.name}")
        if rc == -3:
            raise KeyError(f"object {object_id} already exists")
        if rc != 0:
            raise RuntimeError(f"store_create_object failed rc={rc}")
        return self._view(off.value, size)

    def seal(self, object_id: ObjectID):
        rc = self._lib.store_seal(self._h, object_id.binary())
        if rc != 0:
            raise RuntimeError(f"seal failed rc={rc}")

    def put_bytes(self, object_id: ObjectID, payloads: List[bytes],
                  allow_evict: bool = True) -> int:
        """Create+write+seal a multi-buffer object. Layout: see serialization.py."""
        total = sum(len(p) for p in payloads)
        buf = self.create(object_id, total, allow_evict=allow_evict)
        try:
            pos = 0
            for p in payloads:
                buf[pos:pos + len(p)] = p
                pos += len(p)
            self.seal(object_id)
        except BaseException:
            # An unsealed buffer holds store memory forever AND blocks any
            # re-put of this id — scrub it before surfacing the failure.
            self.release(object_id)
            self.delete(object_id)
            raise
        self.release(object_id)  # drop the creator ref; LRU-managed now
        return total

    def get(self, object_id: ObjectID) -> Optional[memoryview]:
        """Zero-copy read view of a sealed object; pins it until release()."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.store_get(self._h, object_id.binary(), ctypes.byref(off),
                                 ctypes.byref(size))
        if rc != 0:
            return None
        return self._view(off.value, size.value)

    def release(self, object_id: ObjectID):
        self._lib.store_release(self._h, object_id.binary())

    def delete(self, object_id: ObjectID) -> bool:
        return self._lib.store_delete_object(self._h, object_id.binary()) == 0

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.store_contains(self._h, object_id.binary()))

    def list_sealed(self) -> List[bytes]:
        """Binary ids of every sealed object currently in the store.

        Drives the raylet's GCS resync: after a control-plane partition
        heals, every local sealed copy is re-advertised so the object
        directory recovers from any drops it performed while the node was
        unreachable."""
        max_ids = int(self.stats()["num_objects"]) + 64
        while True:
            buf = (ctypes.c_ubyte * (16 * max_ids))()
            n = int(self._lib.store_list_sealed(self._h, buf, max_ids))
            if n < max_ids:
                raw = bytes(buf)
                return [raw[i * 16:(i + 1) * 16] for i in range(n)]
            max_ids *= 2

    # -- introspection --

    def stats(self) -> Dict[str, int]:
        return {
            "capacity": self._lib.store_capacity(self._h),
            "bytes_used": self._lib.store_bytes_used(self._h),
            "num_objects": self._lib.store_num_objects(self._h),
            "num_evictions": self._lib.store_num_evictions(self._h),
        }

    def _view(self, offset: int, size: int) -> memoryview:
        ptr = self._lib.store_pointer(self._h, offset)
        array_t = (ctypes.c_ubyte * size)
        return memoryview(array_t.from_address(ptr)).cast("B")

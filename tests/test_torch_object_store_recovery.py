"""Shared-memory store crash recovery.

Workers are SIGTERM'd as part of normal actor teardown; one dying inside a
store operation leaves the robust mutex EOWNERDEAD with half-updated
allocator/LRU state.  Recovery must rebuild from the entry table instead of
freezing every process on the host (reference analog: plasma survives
client crashes because only the store process mutates state; the
direct-attach design pays for its zero-RPC reads with this recovery path).

The port's runtime under ``test_object_store_recovery.py``'s cases, one for one.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from ray_tpu_torch._native.build import ensure_built
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.plasma import PlasmaClient

STORE = f"/rtt_test_recovery_{os.getpid()}"


def _oid(i: int) -> ObjectID:
    return ObjectID(bytes([i]) * 16)


def _die_in_child(store_name: str):
    """Child attaches and dies holding the lock with corrupted LRU state."""
    code = f"""
import ctypes, sys
sys.path.insert(0, {repr(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))})
from ray_tpu_torch._native.build import ensure_built
lib = ctypes.CDLL(ensure_built())
lib.store_attach.restype = ctypes.c_void_p
lib.store_attach.argtypes = [ctypes.c_char_p]
lib.store_test_die_holding_lock.argtypes = [ctypes.c_void_p]
h = lib.store_attach({store_name.encode()!r})
assert h
lib.store_test_die_holding_lock(h)
"""
    proc = subprocess.run([sys.executable, "-c", code], timeout=60)
    assert proc.returncode == 0


def test_survives_death_while_holding_lock():
    client = PlasmaClient(STORE, capacity=1 << 20, create=True)
    try:
        # Populate with a mix: sealed, pinned, and deleted (to make gaps).
        for i in range(1, 9):
            client.put_bytes(_oid(i), [bytes([i]) * 1000])
        pinned = client.get(_oid(3))  # hold a ref across the crash
        assert client.delete(_oid(2))
        assert client.delete(_oid(6))

        _die_in_child(STORE)

        # Every op must work (not hang, not crash) after recovery.
        assert client.contains(_oid(1))
        v = client.get(_oid(5))
        assert bytes(v[:10]) == bytes([5]) * 10
        v.release()
        client.release(_oid(5))
        # Allocation forcing eviction walks the rebuilt LRU + block chain.
        big = bytes(300_000)
        for i in range(20, 24):
            client.put_bytes(_oid(i), [big])
        assert client.contains(_oid(23))
        # The pre-crash pinned view still reads correctly (block preserved).
        assert bytes(pinned[:10]) == bytes([3]) * 10
        pinned.release()
    finally:
        client.close()


def test_recovery_preserves_sealed_payloads():
    name = STORE + "_p"
    client = PlasmaClient(name, capacity=1 << 20, create=True)
    try:
        payloads = {i: np.random.default_rng(i).bytes(5000)
                    for i in range(1, 6)}
        for i, p in payloads.items():
            client.put_bytes(_oid(i), [p])
        _die_in_child(name)
        for i, p in payloads.items():
            v = client.get(_oid(i))
            assert v is not None, f"object {i} lost"
            assert bytes(v) == p
            v.release()
            client.release(_oid(i))
    finally:
        client.close()

"""Sanitizer build of the C++ object store.

Design analog: SURVEY §5.2 — the reference's C++ CI runs TSAN/ASAN
builds (``bazel test --config=asan/tsan``).  Zero-egress equivalent:
build ``_native/object_store.cc`` with AddressSanitizer + UBSan and
drive the hot paths (create/seal/get/release/delete, eviction pressure,
second-handle attach) in a subprocess; any heap-buffer-overflow /
undefined behavior aborts the child with a sanitizer report, failing
the test.

The port's runtime under ``test_native_sanitizers.py``'s cases, one for one.
"""

import os
import subprocess
import sys

import pytest

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ray_tpu_torch", "_native")

DRIVER = r"""
import ctypes, os, sys

lib = ctypes.CDLL(sys.argv[1])
lib.store_create.restype = ctypes.c_void_p
lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                             ctypes.c_uint64]
lib.store_attach.restype = ctypes.c_void_p
lib.store_attach.argtypes = [ctypes.c_char_p]
lib.store_detach.argtypes = [ctypes.c_void_p]
lib.store_create_object.restype = ctypes.c_int
lib.store_create_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64,
                                    ctypes.POINTER(ctypes.c_uint64)]
lib.store_seal.restype = ctypes.c_int
lib.store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
lib.store_get.restype = ctypes.c_int
lib.store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                          ctypes.POINTER(ctypes.c_uint64),
                          ctypes.POINTER(ctypes.c_uint64)]
lib.store_release.restype = ctypes.c_int
lib.store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
lib.store_delete_object.restype = ctypes.c_int
lib.store_delete_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
lib.store_contains.restype = ctypes.c_int
lib.store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
lib.store_pointer.restype = ctypes.c_void_p
lib.store_pointer.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
for f in ("store_capacity", "store_bytes_used", "store_num_objects",
          "store_num_evictions"):
    getattr(lib, f).restype = ctypes.c_uint64
    getattr(lib, f).argtypes = [ctypes.c_void_p]

name = f"/rtt_asan_{os.getpid()}".encode()
h = lib.store_create(name, 1 << 20, 256)   # 1MB cap: forces eviction
assert h

def oid(i):
    return i.to_bytes(16, "little")

def put(i, payload):
    off = ctypes.c_uint64()
    rc = lib.store_create_object(h, oid(i), len(payload),
                                 ctypes.byref(off))
    if rc != 0:
        return rc
    ctypes.memmove(lib.store_pointer(h, off.value), payload, len(payload))
    rc = lib.store_seal(h, oid(i))
    if rc == 0:
        # Drop the creator ref (create leaves refcount=1 until
        # seal+release) so the object becomes LRU-evictable.
        lib.store_release(h, oid(i))
    return rc

def get(i):
    off = ctypes.c_uint64(); n = ctypes.c_uint64()
    rc = lib.store_get(h, oid(i), ctypes.byref(off), ctypes.byref(n))
    if rc != 0:
        return rc, None
    data = ctypes.string_at(lib.store_pointer(h, off.value), n.value)
    lib.store_release(h, oid(i))
    return 0, data

# basic roundtrip (boundary-exact payload: off-by-one writes would trip
# ASan on the allocator's boundary tags)
assert put(1, b"x" * 1000) == 0
rc, data = get(1)
assert rc == 0 and data == b"x" * 1000

# duplicate create rejected
assert put(1, b"y") == -3

# eviction pressure: aggregate far beyond capacity, uneven sizes
for i in range(100, 164):
    rc = put(i, bytes([i % 256]) * (30000 + (i % 7) * 1111))
    assert rc in (0, -2), rc
assert lib.store_num_evictions(h) > 0
assert lib.store_bytes_used(h) <= lib.store_capacity(h)

# delete + not-found + contains paths
lib.store_delete_object(h, oid(1))
rc, _ = get(2)
assert rc == -1
assert lib.store_contains(h, oid(9999)) == 0

# second handle attach sees the same table; detach cleanly
h2 = lib.store_attach(name)
assert h2
assert lib.store_num_objects(h2) == lib.store_num_objects(h)
lib.store_detach(h2)
lib.store_detach(h)
import ctypes.util
print("ASAN_DRIVER_OK")
"""


@pytest.mark.slow
def test_object_store_asan_ubsan_clean(tmp_path):
    src = os.path.join(_DIR, "object_store.cc")
    lib = str(tmp_path / "libstore_asan.so")
    subprocess.run(
        ["g++", "-O1", "-g", "-shared", "-fPIC", "-std=c++17",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-o", lib, src, "-lpthread", "-lrt"],
        check=True, capture_output=True)
    libasan = subprocess.run(
        ["g++", "-print-file-name=libasan.so"],
        capture_output=True, text=True).stdout.strip()
    env = {**os.environ,
           # Preload the sanitizer runtime: it must initialize before the
           # python interpreter's allocator; halt_on_error fails fast.
           "LD_PRELOAD": libasan,
           "ASAN_OPTIONS": "detect_leaks=0:halt_on_error=1"}
    r = subprocess.run([sys.executable, "-c", DRIVER, lib], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-3000:]
    assert "ASAN_DRIVER_OK" in r.stdout

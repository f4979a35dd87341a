"""Builds the native object-store library on demand.

The library goes to ``ray_tpu_torch/_build/`` (git ignores it), named by a
hash of the sources and the flags, so an edited source is rebuilt and an
unchanged one is reused.  It is written under a temporary name and renamed
into place, so a concurrent build sees all of it or none.  Nothing is built
at import: the first store creation or attach calls ``ensure_built``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["object_store.cc"]
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lpthread", "-lrt")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return os.path.join(BUILD_DIR,
                        f"libray_tpu_torch_native-{h.hexdigest()[:16]}.so")


def ensure_built() -> str:
    with _lock:
        lib = library_path()
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", *_FLAGS, "-o", tmp,
               *[os.path.join(_DIR, s) for s in _SOURCES], *_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SOURCES} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
        return lib

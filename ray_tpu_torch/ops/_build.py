"""Build and load the port's CUDA kernels.

Each source under ``ray_tpu_torch/csrc/`` is compiled by nvcc into its own
shared library with a plain C interface and loaded with ctypes; no source
includes PyTorch's headers, so a build takes seconds.  Libraries go to
``ray_tpu_torch/_build/`` (git ignores it), named by a hash of the source,
every header in ``csrc/`` (``*.cuh``, which the sources include) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  Nothing is built at import: the first CUDA call builds what it
needs.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_builds = 0       # nvcc builds finished in this process


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def library_path(source: str) -> str:
    """Where the library of ``csrc/<source>`` is (or will be) built: named
    by a hash of the source, every ``.cuh`` header beside it and the
    flags."""
    h = hashlib.sha256()
    headers = sorted(s for s in os.listdir(CSRC_DIR) if s.endswith(".cuh"))
    for name in (source, *headers):
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def find_tool(name: str) -> str:
    """A CUDA toolkit program (``cuobjdump``, ...) beside nvcc."""
    path = os.path.join(os.path.dirname(find_nvcc()), name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found beside nvcc ({path})")
    return path


def _ptxas_lines(log: str) -> List[str]:
    """The lines of an nvcc log that name each kernel, give its registers
    and spills, or warn (e.g. C7508: setmaxnreg ignored)."""
    return [ln.strip() for ln in log.splitlines()
            if re.search(r"entry function|registers|spill|warning|\(C\d+\)",
                         ln, re.IGNORECASE)]


def _compile(source: str, out: str) -> dict:
    global _builds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    with _count_lock:
        _builds += 1
    return {"source": source, "nvcc_s": secs,
            "ptxas": _ptxas_lines(proc.stdout + proc.stderr)}


def build_count() -> int:
    """The nvcc builds this process has finished; a library found built
    counts none.  A run reads it before and after a window to show a
    rebuild inside it."""
    return _builds


def build_all(sources: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile every given source (default: all of ``csrc/*.cu``) that has
    no library yet, one nvcc process per source, all started together.
    Returns, per source, the nvcc seconds (0.0 when a built library was
    reused) and the ptxas lines of the build that name each kernel, give
    its registers and spills, or warn."""
    if sources is None:
        sources = sorted(s for s in os.listdir(CSRC_DIR) if s.endswith(".cu"))
    todo = [s for s in sources if not os.path.exists(library_path(s))]
    results = {}
    if todo:
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            futs = {s: pool.submit(_compile, s, library_path(s))
                    for s in todo}
        results = {s: f.result() for s, f in futs.items()}
    return {s: results.get(s, {"source": s, "nvcc_s": 0.0, "ptxas": []})
            for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all([source])
            lib = ctypes.CDLL(library_path(source))
            _libs[source] = lib
        return lib

"""Per-task/actor runtime environments.

Design analog: reference ``python/ray/runtime_env/`` +
``_private/runtime_env/`` (working_dir.py, packaging.py — zip + upload to
GCS, content-addressed ``gcs://_ray_pkg_<hash>.zip`` URIs; the per-node
agent materializes packages into a local cache).  Supported fields:

- ``env_vars``: {str: str} exported into the worker process environment.
- ``working_dir``: local directory, zipped and shipped through the GCS KV;
  workers extract it to a content-addressed cache and chdir into it.
- ``py_modules``: list of local module directories, shipped the same way
  and prepended to ``sys.path``.
- ``pip``: list of requirements — local package directories (shipped
  through the GCS KV like py_modules) or plain requirement strings.
  Workers ``pip install --target`` them into a venv-less cache dir keyed
  by the requirement set's hash and PREPEND it to ``sys.path``, so a task
  can run with a package version the base image doesn't have (reference:
  ``_private/runtime_env/pip.py:294`` ``_install_pip_packages``; the
  per-env virtualenv becomes a per-env site dir here).  Installs run
  ``--no-index --no-build-isolation``: hermetic GPU hosts have zero
  egress, so requirements must be local dirs/wheels — a network-only
  requirement fails fast instead of hanging on a dead fetch.  conda and
  containers stay rejected by design (the image is the environment).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Dict, Optional

PKG_NS = "runtime_env_packages"
_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip"}
_MAX_PKG_BYTES = 64 * 1024 * 1024


class RuntimeEnv(dict):
    """Dict subclass for parity with the reference's RuntimeEnv class."""

    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[list] = None,
                 pip: Optional[list] = None, **other):
        super().__init__()
        if env_vars:
            self["env_vars"] = dict(env_vars)
        if working_dir:
            self["working_dir"] = working_dir
        if py_modules:
            self["py_modules"] = list(py_modules)
        if pip:
            self["pip"] = list(pip)
        self.update(other)


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in
                       ("__pycache__", ".git", ".venv")]
            for fn in files:
                full = os.path.join(root, fn)
                z.write(full, os.path.relpath(full, path))
    data = buf.getvalue()
    if len(data) > _MAX_PKG_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes "
            f"(limit {_MAX_PKG_BYTES}); exclude large data files")
    return data


def _upload_dir(path: str) -> str:
    """Zip + content-addressed upload into the GCS KV; returns pkg uri."""
    from ray_tpu_torch._private import kv
    data = _zip_dir(path)
    digest = hashlib.sha1(data).hexdigest()
    key = digest.encode()
    if not kv.kv_exists(key, ns=PKG_NS):
        kv.kv_put(key, data, ns=PKG_NS, overwrite=False)
    return f"pkg:{digest}"


def _upload_file(path: str) -> str:
    """Content-addressed upload of one file (a wheel); returns pkgfile
    uri carrying the original basename so pip sees a valid wheel name."""
    from ray_tpu_torch._private import kv
    with open(path, "rb") as f:
        data = f.read()
    if len(data) > _MAX_PKG_BYTES:
        raise ValueError(f"runtime_env file {path!r} is {len(data)} bytes "
                         f"(limit {_MAX_PKG_BYTES})")
    digest = hashlib.sha1(data).hexdigest()
    key = digest.encode()
    if not kv.kv_exists(key, ns=PKG_NS):
        kv.kv_put(key, data, ns=PKG_NS, overwrite=False)
    return f"pkgfile:{digest}#{os.path.basename(path)}"


def normalize_runtime_env(runtime_env: Optional[dict]) -> Optional[dict]:
    """Validate + materialize local paths into uploaded package URIs.
    Must run in a connected driver/worker (uploads go through the GCS)."""
    if not runtime_env:
        return None
    unknown = set(runtime_env) - _SUPPORTED
    if unknown:
        raise ValueError(
            f"unsupported runtime_env keys {sorted(unknown)}; supported: "
            f"{sorted(_SUPPORTED)} (conda/containers are not available on "
            f"this runtime — the image is the environment)")
    out: Dict[str, Any] = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in env_vars.items()):
            raise TypeError("env_vars must be {str: str}")
        out["env_vars"] = dict(env_vars)
    wd = runtime_env.get("working_dir")
    if wd:
        if wd.startswith("pkg:"):
            out["working_dir"] = wd
        else:
            if not os.path.isdir(wd):
                raise ValueError(f"working_dir {wd!r} is not a directory")
            out["working_dir"] = _upload_dir(wd)
    mods = runtime_env.get("py_modules")
    if mods:
        uris = []
        for m in mods:
            if isinstance(m, str) and m.startswith("pkg:"):
                uris.append(m)
            elif isinstance(m, str) and os.path.isdir(m):
                uris.append(_upload_dir(m) + "#" + os.path.basename(m))
            else:
                raise ValueError(f"py_modules entry {m!r} must be a local "
                                 f"module directory")
        out["py_modules"] = uris
    pip = runtime_env.get("pip")
    if pip:
        reqs = []
        for r in pip:
            if not isinstance(r, str):
                raise TypeError(f"pip entry {r!r} must be a string")
            if r.startswith(("pkg:", "pkgfile:")):
                reqs.append(r)
            elif os.path.isdir(r):
                # Local source package: ship it through the KV so every
                # node installs the same bits without shared storage.
                reqs.append(_upload_dir(r))
            elif os.path.isfile(r) and r.endswith(".whl"):
                # Wheels ship by content too — a raw path would only
                # resolve on the driver's machine, and hashing the path
                # (not the bytes) would let a rebuilt wheel reuse a stale
                # cached install.
                reqs.append(_upload_file(r))
            else:
                reqs.append(r)    # plain requirement string
        out["pip"] = reqs
    return out or None


def env_hash(normalized: Optional[dict]) -> str:
    """Worker-pool key: workers are reusable only within one env."""
    if not normalized:
        return ""
    return hashlib.sha1(
        json.dumps(normalized, sort_keys=True).encode()).hexdigest()[:16]


def materialize(normalized: dict, kv_get, cache_root: str) -> dict:
    """Worker-side: download+extract packages; returns {workdir, paths}.
    ``kv_get(key_bytes)`` fetches a package from the GCS KV."""
    os.makedirs(cache_root, exist_ok=True)

    def extract(uri: str) -> str:
        digest = uri.split(":", 1)[1].split("#", 1)[0]
        dest = os.path.join(cache_root, digest)
        done = dest + ".done"
        if not os.path.exists(done):
            data = kv_get(digest.encode())
            if data is None:
                raise RuntimeError(f"runtime_env package {digest} missing "
                                   f"from GCS (head restarted?)")
            with zipfile.ZipFile(io.BytesIO(data)) as z:
                z.extractall(dest)
            open(done, "w").close()
        return dest

    out = {"workdir": None, "paths": []}
    if normalized.get("pip"):
        out["paths"].append(
            _materialize_pip(normalized["pip"], extract, kv_get,
                             cache_root))
    if normalized.get("working_dir"):
        out["workdir"] = extract(normalized["working_dir"])
        out["paths"].append(out["workdir"])
    for uri in normalized.get("py_modules", []):
        base = extract(uri)
        # "pkg:<sha>#modname": the zip root IS the module dir; expose its
        # parent so `import modname` works.
        if "#" in uri:
            name = uri.split("#", 1)[1]
            target = os.path.join(base, "_mods", name)
            if not os.path.isdir(target):
                os.makedirs(os.path.dirname(target), exist_ok=True)
                import shutil
                shutil.copytree(base, target,
                                ignore=shutil.ignore_patterns("_mods"))
            out["paths"].append(os.path.join(base, "_mods"))
        else:
            out["paths"].append(base)
    return out


def _materialize_pip(reqs, extract, kv_get, cache_root: str) -> str:
    """Install the requirement set into a content-addressed site dir.

    Keyed by the sha1 of the normalized requirement list, so every env
    with the same requirements shares one install and different envs
    never collide.  Concurrent installers race benignly: each installs
    into a private tmp dir and the first rename wins (the directory is
    immutable once its .done marker exists).
    """
    import shutil
    import subprocess
    import sys

    digest = hashlib.sha1(json.dumps(sorted(reqs)).encode()).hexdigest()
    dest = os.path.join(cache_root, "pip", digest)
    done = dest + ".done"
    if os.path.exists(done):
        return dest
    def fetch_file(uri: str) -> str:
        digest, name = uri.split(":", 1)[1].split("#", 1)
        d = os.path.join(cache_root, "files", digest)
        path = os.path.join(d, name)
        if not os.path.exists(path):
            data = kv_get(digest.encode())
            if data is None:
                raise RuntimeError(f"runtime_env file {digest} missing "
                                   f"from GCS (head restarted?)")
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        return path

    tmp = f"{dest}.tmp.{os.getpid()}"
    local_reqs = []
    for r in reqs:
        if r.startswith("pkg:"):
            # Private copy: --no-build-isolation builds IN-TREE, so two
            # concurrent installers sharing the content-addressed source
            # dir would collide in its build/ directory (Errno 17 on
            # dist-info).  Each installer builds its own copy.
            src = extract(r)
            copy = os.path.join(f"{tmp}.src", os.path.basename(src))
            shutil.copytree(src, copy,
                            ignore=shutil.ignore_patterns("build",
                                                          "*.egg-info"))
            local_reqs.append(copy)
        elif r.startswith("pkgfile:"):
            local_reqs.append(fetch_file(r))
        else:
            local_reqs.append(r)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pip", "install", "--quiet",
             "--target", tmp, "--no-index", "--no-build-isolation",
             *local_reqs],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"runtime_env pip install failed (requirements must be "
                f"local dirs/wheels on this zero-egress runtime): "
                f"{proc.stderr[-2000:]}")
        try:
            os.rename(tmp, dest)
        except OSError:
            pass    # lost the race; the winner's install is equivalent
        open(done, "w").close()
        return dest
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(f"{tmp}.src", ignore_errors=True)

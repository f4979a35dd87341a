"""Pluggable URI storage for checkpoints and experiment sync.

Port of ``ray_tpu/air/storage.py`` (reference
``python/ray/air/checkpoint.py:63`` from_uri / to_uri +
``python/ray/tune/syncer.py``, experiment-dir sync to cloud storage).
Checkpoints that must survive the loss of a host live in object storage —
a node-local path dies with the node.

Scheme registry: ``file://`` (and bare paths) copy through the local
filesystem; any other scheme (``gs://``, ``s3://``, ...) goes through an
fsspec-shaped provider if :mod:`fsspec` is importable, else raises with a
clear message.  ``register_storage_provider`` lets deployments plug their
own (e.g. a GCS client wired to the hosts' service credentials).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

__all__ = [
    "StorageProvider", "LocalFileProvider", "FsspecProvider",
    "get_provider", "register_storage_provider", "parse_uri", "is_uri",
]


def parse_uri(uri: str) -> Tuple[str, str]:
    """'scheme://path' -> (scheme, path); bare paths get scheme 'file'."""
    if "://" in uri:
        scheme, path = uri.split("://", 1)
        return scheme.lower(), path
    return "file", uri


def is_uri(path: Optional[str]) -> bool:
    return bool(path) and "://" in path


class StorageProvider:
    """Directory-granular remote storage interface."""

    def upload_dir(self, local: str, uri: str) -> None:
        raise NotImplementedError

    def download_dir(self, uri: str, local: str) -> None:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def delete_dir(self, uri: str) -> None:
        raise NotImplementedError


class LocalFileProvider(StorageProvider):
    """file:// — also the path every test and the sim cluster exercises."""

    @staticmethod
    def _path(uri: str) -> str:
        return parse_uri(uri)[1]

    def upload_dir(self, local: str, uri: str) -> None:
        dest = self._path(uri)
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(local, dest, dirs_exist_ok=True)

    def download_dir(self, uri: str, local: str) -> None:
        src = self._path(uri)
        if not os.path.isdir(src):
            raise FileNotFoundError(f"no checkpoint directory at {uri}")
        os.makedirs(local, exist_ok=True)
        shutil.copytree(src, local, dirs_exist_ok=True)

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))

    def delete_dir(self, uri: str) -> None:
        shutil.rmtree(self._path(uri), ignore_errors=True)


class FsspecProvider(StorageProvider):
    """Adapter over fsspec for cloud schemes (gs://, s3://, ...).

    fsspec is not a hard dependency: constructing the provider raises a
    clear ImportError when it (or the scheme's driver) is missing.
    """

    def __init__(self, scheme: str):
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover - env without fsspec
            raise ImportError(
                f"URI scheme '{scheme}://' needs fsspec (or register a "
                f"provider via register_storage_provider)") from e
        self._fs = fsspec.filesystem(scheme)

    def upload_dir(self, local: str, uri: str) -> None:
        self._fs.put(local.rstrip("/") + "/", uri.rstrip("/") + "/",
                     recursive=True)

    def download_dir(self, uri: str, local: str) -> None:
        os.makedirs(local, exist_ok=True)
        self._fs.get(uri.rstrip("/") + "/", local.rstrip("/") + "/",
                     recursive=True)

    def exists(self, uri: str) -> bool:
        return self._fs.exists(uri)

    def delete_dir(self, uri: str) -> None:
        self._fs.rm(uri, recursive=True)


_PROVIDERS: Dict[str, StorageProvider] = {"file": LocalFileProvider()}


def register_storage_provider(scheme: str, provider: StorageProvider) -> None:
    _PROVIDERS[scheme.lower()] = provider


def get_provider(uri: str) -> StorageProvider:
    scheme, _ = parse_uri(uri)
    if scheme not in _PROVIDERS:
        _PROVIDERS[scheme] = FsspecProvider(scheme)
    return _PROVIDERS[scheme]

"""Checkpoint envelope: dict <-> directory <-> bytes inter-convertible.

Port of ``ray_tpu/air/checkpoint.py`` (reference
``python/ray/air/checkpoint.py:63``: from_dict/to_dict/from_directory/
to_directory/from_bytes/to_bytes/from_uri).  The JAX package's pytree
flavour becomes a nested dict of tensors (``from_pytree``/``to_pytree``):
the directory form keeps one file per leaf plus the structure JSON, each
leaf its raw bytes with its dtype name and shape (numpy has no bf16), so
large params never round-trip through pickle.  A restored tensor lands on
the CPU; the caller moves it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tarfile
import tempfile
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.air import _tensor_tree

_DICT_FILE = "checkpoint_dict.pkl"
_PYTREE_DIR = "pytree"
_PYTREE_META = "pytree_structure.json"


class Checkpoint:
    """An immutable envelope around a training state snapshot.

    Exactly one of ``_data_dict`` / ``_local_path`` is set; conversions
    materialize the other form on demand (matching the reference's
    dict <-> directory duality).
    """

    def __init__(self, local_path: Optional[str] = None,
                 data_dict: Optional[Dict[str, Any]] = None):
        if (local_path is None) == (data_dict is None):
            raise ValueError(
                "exactly one of local_path / data_dict must be given "
                "(use Checkpoint.from_dict / Checkpoint.from_directory)")
        self._local_path = local_path
        self._data_dict = data_dict

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        if not isinstance(data, dict):
            raise TypeError("from_dict expects a dict")
        return cls(data_dict=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"checkpoint directory not found: {path}")
        return cls(local_path=os.path.abspath(path))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls.from_dict(pickle.loads(blob))

    @classmethod
    def from_pytree(cls, tree: Any, **extra) -> "Checkpoint":
        """Snapshot a nested dict of tensors (params, optimizer state).
        Leaves are copied to the host when the directory form is written,
        not here, so this is cheap to call from inside a train loop."""
        return cls.from_dict({"__pytree__": tree, **extra})

    # -- conversions ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data_dict is not None:
            return dict(self._data_dict)
        # Directory form -> dict.
        path = self._local_path
        dict_file = os.path.join(path, _DICT_FILE)
        if os.path.exists(dict_file):
            with open(dict_file, "rb") as f:
                data = pickle.load(f)
        else:
            data = {}
        tree_meta = os.path.join(path, _PYTREE_META)
        if os.path.exists(tree_meta):
            data["__pytree__"] = _load_pytree(path)
        # Any loose user files are exposed by path, not inlined.
        return data

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = os.path.join(tempfile.gettempdir(),
                                f"rtt_checkpoint_{uuid.uuid4().hex[:12]}")
        os.makedirs(path, exist_ok=True)
        if self._local_path is not None:
            if os.path.abspath(path) != os.path.abspath(self._local_path):
                _copy_tree(self._local_path, path)
            return path
        data = dict(self._data_dict)
        tree = data.pop("__pytree__", None)
        if tree is not None:
            _save_pytree(tree, path)
        with open(os.path.join(path, _DICT_FILE), "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.to_dict(), protocol=pickle.HIGHEST_PROTOCOL)

    def to_pytree(self) -> Any:
        data = self.to_dict()
        if "__pytree__" not in data:
            raise ValueError("checkpoint holds no pytree")
        return data["__pytree__"]

    # -- URI storage ------------------------------------------------------
    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """Fetch a checkpoint from URI storage (file://, gs://, ...) into a
        fresh local directory (reference air/checkpoint.py:63 from_uri).
        The directory is reaped at interpreter exit — preemption-retry
        loops calling from_uri repeatedly must not fill local disk."""
        from ray_tpu_torch.air.storage import get_provider
        dest = os.path.join(tempfile.gettempdir(),
                            f"rtt_checkpoint_{uuid.uuid4().hex[:12]}")
        get_provider(uri).download_dir(uri, dest)
        _reap_at_exit(dest)
        return cls.from_directory(dest)

    def to_uri(self, uri: str) -> str:
        """Upload the directory form to URI storage and return the URI."""
        from ray_tpu_torch.air.storage import get_provider
        get_provider(uri).upload_dir(self.to_directory(), uri)
        return uri

    # -- misc -------------------------------------------------------------
    @property
    def path(self) -> Optional[str]:
        return self._local_path

    def as_pack(self) -> bytes:
        """Tar the directory form for shipping through the object store."""
        src = self.to_directory()
        with tempfile.NamedTemporaryFile(suffix=".tar", delete=False) as tf:
            tar_path = tf.name
        with tarfile.open(tar_path, "w") as tar:
            tar.add(src, arcname=".")
        with open(tar_path, "rb") as f:
            blob = f.read()
        os.unlink(tar_path)
        return blob

    @classmethod
    def from_pack(cls, blob: bytes) -> "Checkpoint":
        dest = os.path.join(tempfile.gettempdir(),
                            f"rtt_checkpoint_{uuid.uuid4().hex[:12]}")
        os.makedirs(dest, exist_ok=True)
        with tempfile.NamedTemporaryFile(suffix=".tar", delete=False) as tf:
            tf.write(blob)
            tar_path = tf.name
        with tarfile.open(tar_path) as tar:
            tar.extractall(dest, filter="data")
        os.unlink(tar_path)
        return cls.from_directory(dest)

    def __repr__(self):
        form = f"dir={self._local_path}" if self._local_path else "dict"
        return f"Checkpoint({form})"

    def __reduce__(self):
        # Serialize through the dict form so checkpoints travel through the
        # object store regardless of which node's filesystem they live on.
        return (Checkpoint.from_dict, (self.to_dict(),))


_REAP_DIRS: list = []


def _reap_at_exit(path: str) -> None:
    if not _REAP_DIRS:
        import atexit

        def _reap():
            for p in _REAP_DIRS:
                shutil.rmtree(p, ignore_errors=True)

        atexit.register(_reap)
    _REAP_DIRS.append(path)


# -- tensor tree <-> directory -------------------------------------------

def _save_pytree(tree: Any, path: str):
    leaves, spec = _tensor_tree.flatten(tree)
    tree_dir = os.path.join(path, _PYTREE_DIR)
    os.makedirs(tree_dir, exist_ok=True)
    infos = []
    for i, leaf in enumerate(leaves):
        blob, info = _tensor_tree.encode_leaf(leaf)
        with open(os.path.join(tree_dir, f"leaf_{i}.bin"), "wb") as f:
            f.write(blob)
        infos.append(info)
    with open(os.path.join(path, _PYTREE_META), "w") as f:
        json.dump({"num_leaves": len(leaves), "leaves": infos,
                   "structure": spec}, f)


def _load_pytree(path: str) -> Any:
    with open(os.path.join(path, _PYTREE_META)) as f:
        meta = json.load(f)
    tree_dir = os.path.join(path, _PYTREE_DIR)
    leaves = []
    for i, info in enumerate(meta["leaves"]):
        with open(os.path.join(tree_dir, f"leaf_{i}.bin"), "rb") as f:
            leaves.append(_tensor_tree.decode_leaf(f.read(), info))
    return _tensor_tree.unflatten(leaves, meta["structure"])


def _copy_tree(src: str, dst: str):
    for name in os.listdir(src):
        s, d = os.path.join(src, name), os.path.join(dst, name)
        if os.path.isdir(s):
            shutil.copytree(s, d, dirs_exist_ok=True)
        else:
            shutil.copy2(s, d)

"""Nested containers of tensors as flat leaves plus a JSON structure.

The port's checkpoints hold a train state as a nested dict of tensors
(params, an optimizer's ``state_dict()``, RNG states): the counterpart of
the JAX package's pytrees.  ``flatten`` walks dicts, lists and tuples in
order and gives the tensor and numpy leaves (in walk order) and a
JSON-able spec of everything else; ``unflatten`` rebuilds the tree from
the two.  A leaf is stored as its raw bytes with its dtype name and shape,
since numpy has no bf16: ``encode_leaf``/``decode_leaf``.  A decoded
tensor lands on the CPU; the caller moves it.

Dict keys may be str or int (an optimizer state is keyed by param index);
other leaves must be JSON values (numbers, strings, bools, None).
Importing this module imports no torch: a tree without tensors needs none.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Tuple

Spec = Any


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def flatten(tree: Any) -> Tuple[List[Any], Spec]:
    """(leaves, spec): tensors and numpy arrays become numbered leaves."""
    import numpy as np

    leaves: List[Any] = []

    def walk(node):
        if _is_tensor(node) or isinstance(node, (np.ndarray, np.generic)):
            leaves.append(node)
            return {"leaf": len(leaves) - 1}
        if isinstance(node, dict):
            items = []
            for k, v in node.items():
                if not isinstance(k, (str, int)) or isinstance(k, bool):
                    raise TypeError(f"checkpoint dict key {k!r} is not a "
                                    f"str or an int")
                items.append([k, walk(v)])
            return {"dict": items}
        if isinstance(node, (list, tuple)):
            return {"list" if isinstance(node, list) else "tuple":
                    [walk(v) for v in node]}
        if node is None or isinstance(node, (bool, int, float, str)):
            return {"value": node}
        raise TypeError(f"cannot checkpoint a {type(node).__name__} leaf "
                        f"(tensors, numpy arrays, JSON values)")

    return leaves, walk(tree)


def unflatten(leaves: List[Any], spec: Spec) -> Any:
    if "leaf" in spec:
        return leaves[spec["leaf"]]
    if "dict" in spec:
        return {k: unflatten(leaves, v) for k, v in spec["dict"]}
    if "list" in spec:
        return [unflatten(leaves, v) for v in spec["list"]]
    if "tuple" in spec:
        return tuple(unflatten(leaves, v) for v in spec["tuple"])
    return spec["value"]


def map_leaves(fn, tree: Any) -> Any:
    """``tree`` with every tensor and numpy leaf replaced by ``fn(leaf)``."""
    leaves, spec = flatten(tree)
    return unflatten([fn(x) for x in leaves], spec)


def encode_leaf(leaf: Any) -> Tuple[bytes, Dict[str, Any]]:
    """(raw bytes, {"kind", "dtype", "shape"}) of a tensor or numpy leaf."""
    import numpy as np

    if _is_tensor(leaf):
        import torch
        host = leaf.detach().cpu().contiguous()
        raw = host.reshape(-1).view(torch.uint8).numpy()
        return raw.tobytes(), {
            "kind": "tensor",
            "dtype": str(host.dtype).removeprefix("torch."),
            "shape": list(host.shape)}
    arr = np.ascontiguousarray(leaf)
    return arr.tobytes(), {"kind": "numpy", "dtype": arr.dtype.str,
                           "shape": list(arr.shape)}


def decode_leaf(blob: bytes, info: Dict[str, Any]) -> Any:
    import numpy as np

    shape = tuple(info["shape"])
    if info["kind"] == "numpy":
        return np.frombuffer(blob, dtype=np.dtype(info["dtype"])).reshape(
            shape).copy()
    import torch
    dtype = getattr(torch, info["dtype"])
    if not blob:
        return torch.empty(shape, dtype=dtype)
    flat = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)

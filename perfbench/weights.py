"""A configuration's sizes, its params' layout, and its weights made from the
seed on the device.

The layout is the port's (``ray_tpu_torch.models.gpt.param_shapes``: stacked
``[L, ...]`` layers, ``wqkv [L, D, 3, N, H]``, experts ``[L, E, ...]``),
written out here so that the reference can take the same weights without
importing the program; ``tests/test_perfbench_reference.py`` holds the two
layouts equal.  Weights are GPT-2's init (normal 0.02, the residual
projections ``wo`` 0.02 / sqrt(2 L), biases 0, layer-norm scales 1), drawn in
f32 by one call a leaf from a ``torch.Generator`` on the device, seeded from
the run's seed and the leaf's index, so that any one leaf can be made again.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

Tree = Dict[str, Any]


def sizes(config: Dict) -> Dict:
    """The harness's sizes of a configuration file (GPT-2's key names)."""
    D, N = config["n_embd"], config["n_head"]
    moe = config.get("moe") or {}
    return {
        "vocab_size": config["assumed"]["padded_vocab_size"],
        "token_vocab": config["vocab_size"],
        "max_seq_len": config["n_positions"],
        "num_layers": config["n_layer"],
        "num_heads": N,
        "embed_dim": D,
        "head_dim": D // N,
        "mlp_dim": config.get("n_inner") or 4 * D,
        "num_experts": moe.get("num_experts", 0),
        "expert_top_k": moe.get("expert_top_k", 0),
        "capacity_factor": moe.get("capacity_factor", 0.0),
        "moe_aux_coef": moe.get("aux_loss_coef", 0.0),
        "layer_norm_eps": config["layer_norm_epsilon"],
    }


def shape_tree(m: Dict) -> Tree:
    """The params as shapes, in the port's layout and leaf order."""
    D, H, M, L, V = (m["embed_dim"], m["head_dim"], m["mlp_dim"],
                     m["num_layers"], m["vocab_size"])
    N, E = m["num_heads"], m["num_experts"]

    def norm(*shape):
        return {"scale": shape, "bias": shape}

    if E:
        mlp = {"router": (L, D, E), "wi": (L, E, D, M), "bi": (L, E, M),
               "wo": (L, E, M, D), "bo": (L, E, D)}
    else:
        mlp = {"wi": (L, D, M), "bi": (L, M), "wo": (L, M, D), "bo": (L, D)}
    return {
        "wte": (V, D),
        "wpe": (m["max_seq_len"], D),
        "layers": {
            "ln1": norm(L, D),
            "attn": {"wqkv": (L, D, 3, N, H), "wo": (L, N, H, D),
                     "bo": (L, D)},
            "ln2": norm(L, D),
            "mlp": mlp,
        },
        "ln_f": norm(D),
    }


def named_leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from named_leaves(v, name)
        else:
            yield name, v


def n_params(m: Dict) -> int:
    return sum(math.prod(s) for _, s in named_leaves(shape_tree(m)))


def _leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * index + 1) % (1 << 63)


def make_leaf(m: Dict, seed: int, name: str, device) -> torch.Tensor:
    """One f32 leaf of the seed's weights, made on ``device``."""
    leaves = list(named_leaves(shape_tree(m)))
    index = [n for n, _ in leaves].index(name)
    shape = leaves[index][1]
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return torch.ones(shape, device=device)
    if last in ("bias", "bo", "bi"):
        return torch.zeros(shape, device=device)
    std = 0.02 / math.sqrt(2 * m["num_layers"]) if last == "wo" else 0.02
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, index))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std)


def make_params(m: Dict, seed: int, device) -> Tree:
    """Every leaf of the seed's weights, f32, on ``device``."""
    tree: Tree = {}
    for name, _ in named_leaves(shape_tree(m)):
        set_leaf(tree, name, make_leaf(m, seed, name, device))
    return tree


def set_leaf(tree: Tree, name: str, value) -> None:
    """Put ``value`` at the dotted ``name``, making the dicts on the way."""
    *path, last = name.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def slice_norms(name: str, t: torch.Tensor) -> torch.Tensor:
    """f64 L2 norms of a leaf's parts: one a layer for the stacked
    ``layers.*`` leaves, one for the others."""
    t = t.detach().double()
    if name.startswith("layers."):
        return t.reshape(t.shape[0], -1).norm(dim=1)
    return t.norm().reshape(1)

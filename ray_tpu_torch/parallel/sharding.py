"""Logical-axis sharding rules, mapped onto DTensor placements.

Port of ``ray_tpu/parallel/sharding.py``.  Arrays carry *logical* axis names
("batch", "embed", "mlp", "heads", ...) and a rule table maps each logical
axis to zero or more mesh axes.  ``LogicalAxisRules.spec_for`` returns the
reference's ``PartitionSpec`` as a plain tuple (one entry per array dim,
trailing ``None``s dropped); ``placements_for`` turns such a spec into one
DTensor placement per mesh dim: ``Shard(d)`` on each mesh dim that array
dim ``d`` is split over, ``Replicate()`` on the rest.

Two modes, as in the reference:

* GSPMD mode: params are ``DTensor``s placed by ``shard_params`` /
  ``init_sharded``, activations are redistributed at the models' logical
  constraint points (``with_logical_constraint``), and DTensor's sharding
  propagation emits the collectives between them.
* shard_map mode: ``shard_map`` runs a per-rank function on the local
  shards, with the mesh's dim names resolving to their process groups for
  the collectives of ``parallel.collectives`` (ring and Ulysses
  attention, MoE's ``ep_axis`` mode).

DTensors live on ``mesh.active_mesh``: the dims larger than 1 other than
pp and sp, which are mapped by hand (see ``MANUAL_AXES``).  So a rule
that maps "seq" to sp, or "layers" to pp, splits no DTensor: activations
stay whole along the sequence outside ring attention, and each pp rank
holds every layer (the pipeline runs its stage's slice,
``parallel/pipeline.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ray_tpu_torch.parallel.collectives import (gather_replicated,
                                                split_replicated)
from ray_tpu_torch.parallel.mesh import MANUAL_AXES, active_mesh, use_mesh

MeshAxes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: the mesh axes of each array dim (None, an axis
    name, or a tuple of names), as ``jax.sharding.PartitionSpec``.  A
    plain tuple, so it compares equal to the tuple of its entries."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


Spec = Tuple[MeshAxes, ...]


class LogicalAxisRules:
    """Ordered mapping logical-axis-name -> mesh axis (or axes, or None).

    The first rule whose mesh axes are still unused by the current spec wins,
    so rules act like t5x's `logical_axis_rules` priority list.
    """

    def __init__(self, rules: Sequence[Tuple[str, MeshAxes]]):
        self.rules = list(rules)

    def spec_for(self, logical_axes: Sequence[Optional[str]]) -> P:
        """The mesh axes of each dim of an array whose dims have these
        logical names (the reference's ``PartitionSpec`` entries)."""
        out: List[MeshAxes] = []
        used: set = set()
        for name in logical_axes:
            assignment: MeshAxes = None
            if name is not None:
                for lname, maxes in self.rules:
                    if lname != name or maxes is None:
                        continue
                    cand = (maxes,) if isinstance(maxes, str) else tuple(maxes)
                    if any(m in used for m in cand):
                        continue
                    assignment = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
            out.append(assignment)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    @staticmethod
    def for_transformer(spec=None) -> "LogicalAxisRules":
        """Standard Megatron-style layout over the MeshSpec axes.

        batch    -> (dp, fsdp)   activations' leading dim
        seq      -> sp           sequence/context parallelism
        embed    -> fsdp         ZeRO-3 weight sharding on the data axis
        heads    -> tp           attention heads (Megatron col-parallel)
        kv       -> None         head_dim stays replicated
        mlp      -> tp           FFN hidden (col-parallel in, row-parallel out)
        vocab    -> tp           embedding/LM-head vocab sharding
        expert   -> ep           MoE expert dim
        layers   -> pp           stacked-layer dim (pipeline stages)
        """
        return LogicalAxisRules([
            ("batch", ("dp", "fsdp")),
            ("seq", "sp"),
            ("embed", "fsdp"),
            ("heads", "tp"),
            ("kv", None),
            ("mlp", "tp"),
            ("vocab", "tp"),
            ("expert", "ep"),
            ("layers", "pp"),
            ("norm", None),
        ])


def placements_for(mesh, spec: Spec) -> List[Placement]:
    """One placement per dim of ``mesh`` for an array with mesh-axis
    ``spec``: ``Shard(d)`` on each mesh dim that array dim ``d`` is split
    over, ``Replicate()`` elsewhere.  ``mesh`` may be the active submesh
    of a full mesh (``active_mesh``): axes of the full mesh that it lacks
    have size 1 or are mapped by hand (``MANUAL_AXES``: pp, sp), and no
    DTensor is split over them.

    An array dim split over several mesh axes is split in JAX's element
    order (the first axis major) only when the axes follow the mesh's dim
    order, since DTensor splits over mesh dims left to right; other orders
    raise, as does an axis the mesh lacks or used twice."""
    names = list(mesh.mesh_dim_names or ())
    root_names = list(getattr(mesh, "_rt_root", mesh).mesh_dim_names or ())
    out: List[Placement] = [Replicate() for _ in names]
    used: set = set()
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if [a for a in axes if a not in root_names]:
            raise ValueError(f"mesh axes {axes} not all in the mesh "
                             f"{root_names}")
        if len(set(axes) & used) or len(set(axes)) < len(axes):
            raise ValueError(f"mesh axes {axes} used twice in {spec}")
        used.update(axes)
        order = [root_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"mesh axes {axes} of dim {dim} do not follow the mesh's "
                f"order {root_names}: DTensor would split the dim in "
                f"another element order than the spec says")
        for a in axes:
            if (a in names and a not in MANUAL_AXES
                    and mesh.size(names.index(a)) > 1):
                out[names.index(a)] = Shard(dim)
    return out


def logical_sharding(mesh, rules: LogicalAxisRules,
                     logical_axes: Sequence[Optional[str]]
                     ) -> List[Placement]:
    """The placements of an array with these logical axes on ``mesh``."""
    return placements_for(mesh, rules.spec_for(logical_axes))


def with_logical_constraint(x, rules: Optional[LogicalAxisRules],
                            logical_axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the placements its logical axes give on
    its own mesh (``lax.with_sharding_constraint`` by logical names); a
    plain tensor, or no rules, passes through."""
    if rules is None or not isinstance(x, DTensor):
        return x
    placements = logical_sharding(x.device_mesh, rules, logical_axes)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def _tree_map(fn: Callable, tree, *rest):
    if _is_leaf(tree):
        return fn(tree, *rest)
    return {k: _tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


def local_to_dtensor(x: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor of the global tensor ``x``, which every rank holds whole:
    each rank keeps its own shard (no communication)."""
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


def shard_params(params, mesh, rules: LogicalAxisRules, annotations):
    """Distribute a params tree by its per-leaf logical annotations
    (``annotations`` mirrors ``params`` with tuples of logical axis names,
    None for replicated dims): ``distribute_tensor`` from rank 0, as
    ``jax.device_put`` places one host array."""
    mesh = active_mesh(mesh)

    def place(p, ann):
        return distribute_tensor(p, mesh, logical_sharding(mesh, rules, ann))

    return _tree_map(place, params, annotations)


def init_sharded(init_fn: Callable, mesh, rules: LogicalAxisRules,
                 annotations, *args):
    """Params born sharded: every rank runs the same seeded ``init_fn(*args)``
    and keeps its own shard of each leaf (no communication), the port's
    counterpart of jitting the init with ``out_shardings``."""
    mesh = active_mesh(mesh)

    def place(p, ann):
        return local_to_dtensor(p, mesh,
                                logical_sharding(mesh, rules, ann))

    return _tree_map(place, init_fn(*args), annotations)


def _manual_splits(mesh, spec) -> List[Tuple[str, int]]:
    """(axis, array dim) of each axis of ``spec`` that ``shard_map`` maps
    by hand: a ``MANUAL_AXES`` axis of size > 1.  Such an axis must come
    after every DTensor axis of its dim, so the split keeps JAX's element
    order (DTensor's split first, then the hand split of each chunk)."""
    names = list(mesh.mesh_dim_names)
    out = []
    for dim, axes in enumerate(spec):
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        split = [a for a in axes
                 if a in names and mesh.size(names.index(a)) > 1]
        manual = [a in MANUAL_AXES for a in split]
        if manual != sorted(manual):
            raise ValueError(f"dim {dim} of {spec}: a hand-mapped axis "
                             f"({MANUAL_AXES}) before a DTensor axis")
        out += [(a, dim) for a, m in zip(split, manual) if m]
    return out


def shard_map(f: Callable, mesh, in_specs: Sequence[Optional[P]],
              out_specs: Union[P, Sequence[P]]) -> Callable:
    """``jax.shard_map`` over a DeviceMesh: ``f`` runs on each rank's local
    shards, with axis names resolving against ``mesh`` for the
    collectives.

    Each positional input with a spec is redistributed to it and passed as
    its local tensor: a DTensor as it is placed, a plain tensor as a global
    value that every rank holds whole (sliced locally, no communication).
    The hand-mapped axes (sp, pp) are sliced out of the local tensor, and
    gathered back into the outputs.  An input whose spec is None is
    passed unchanged.  The outputs come back as DTensors: one for a single
    ``P`` out spec, else a tuple.  Differentiable: the hand split's
    gradient is gathered whole, and the gathered output's gradient is
    each rank's slice, as every rank computes alike from the outputs."""
    single = isinstance(out_specs, P)
    outs = (out_specs,) if single else tuple(out_specs)
    act = active_mesh(mesh)

    def mapped(*args):
        local = []
        for x, spec in zip(args, in_specs):
            if spec is None or not isinstance(x, torch.Tensor):
                local.append(x)
                continue
            placements = placements_for(act, spec)
            if isinstance(x, DTensor):
                x = x.redistribute(act, placements)
            else:
                x = local_to_dtensor(x, act, placements)
            x = x.to_local()
            for axis, dim in _manual_splits(mesh, spec):
                x = split_replicated(x, axis, dim, mesh)
            local.append(x)
        with use_mesh(mesh):
            res = f(*local)
        res = (res,) if single else tuple(res)
        wrapped = []
        for r, spec in zip(res, outs):
            for axis, dim in reversed(_manual_splits(mesh, spec)):
                r = gather_replicated(r, axis, dim, mesh)
            wrapped.append(DTensor.from_local(
                r, act, placements_for(act, spec), run_check=False))
        return wrapped[0] if single else tuple(wrapped)

    return mapped


def per_rank(f: Callable, *args, dims: Sequence[int] = (0, 1)):
    """``f`` on each rank's local shards of its DTensor args, which keep
    their split on the tensor ``dims`` (as the first DTensor arg has it)
    and are gathered on every other dim; the outputs (a tensor or a tuple)
    come back as DTensors so placed.  With no DTensor arg, ``f(*args)``.

    For functions that work row by row, or head by head, on whole rows
    (attention over whole sequences, MoE routing, the cross-entropy over
    the vocabulary): ``f`` sees plain local tensors, so a custom op such
    as the flash kernels' needs no sharding rule.  Differentiable."""
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return f(*args)
    mesh = first.device_mesh
    kept = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in first.placements]
    res = f(*(a.redistribute(mesh, kept).to_local()
              if isinstance(a, DTensor) else a for a in args))
    if isinstance(res, torch.Tensor):
        return DTensor.from_local(res, mesh, kept, run_check=False)
    return tuple(DTensor.from_local(r, mesh, kept, run_check=False)
                 for r in res)


def gather_dims(x, dims: Sequence[int]):
    """x with its split on the tensor ``dims`` gathered; a plain tensor,
    or a DTensor not split on them, as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim in dims for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim in dims else p
        for p in x.placements])

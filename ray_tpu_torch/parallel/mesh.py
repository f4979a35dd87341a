"""Mesh construction over the ranks of a torch.distributed world.

Port of ``ray_tpu/parallel/mesh.py``.  Where the reference builds a
``jax.sharding.Mesh`` over devices, the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over ranks ``[0, n)`` of the
default process group, one rank per device, with one named mesh dim per
parallelism axis in ``AXIS_ORDER``.  Each mesh dim carries its own process
group (``mesh.get_group(name)``), which the collectives and the manual
(shard_map-style) ops run over.

Axis ordering is the reference's convention: the axes that carry the most
traffic (tp, sp) are innermost, so their groups hold neighbouring ranks
(the ranks of one host, on NVLink), while dp and pp ride the outer dims.
Size-1 axes stay in the mesh, so sharding rules are written once whatever
axes are active.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

# Innermost-last: the last mesh dims hold neighbouring ranks, so axes are
# ordered slowest-traffic-first, as in the reference.
AXIS_ORDER: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")

# The mesh whose dim names the collectives resolve inside a mapped region,
# as the axis names of ``jax.shard_map`` resolve against its mesh.
_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Resolve axis names against ``mesh`` inside the block (what
    ``parallel.sharding.shard_map`` does around the mapped function)."""
    token = _CURRENT_MESH.set(mesh)
    try:
        yield
    finally:
        _CURRENT_MESH.reset(token)


def current_mesh(mesh=None):
    """``mesh`` when given, else the mesh of the enclosing ``use_mesh``;
    raises when there is neither."""
    mesh = mesh if mesh is not None else _CURRENT_MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or call inside shard_map "
                           "(or use_mesh)")
    return mesh


def mesh_device_type(device_type: Optional[str] = None) -> str:
    """The device type a mesh is built on: ``"cuda"`` unless the caller
    asks for another, and a CUDA mesh raises without a card (the port
    never carries on quietly on the CPU)."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a ray_tpu_torch mesh runs on CUDA devices and none is "
            "available; pass device_type='cpu' to build it over CPU ranks "
            "(gloo)")
    return device_type


def device_mesh(device_type: Optional[str], ranks, names: Sequence[str]):
    """A ``DeviceMesh`` of ``ranks`` (an int array whose shape is the mesh
    shape) with dims ``names``, after checking that the default process
    group holds every rank.  Every rank of the world must call it (each
    mesh dim's groups are created collectively)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = mesh_device_type(device_type)
    ranks = torch.as_tensor(ranks, dtype=torch.int64)
    if not dist.is_initialized():
        raise RuntimeError("building a mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    if ranks.numel() > world:
        raise ValueError(f"the mesh needs {ranks.numel()} ranks, only "
                         f"{world} in the world")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


# Mesh axes the port maps by hand instead of placing DTensors on them: sp
# is ring attention's (``sharding.shard_map`` slices the sequence to each
# rank's chunk and gathers it back), and pp is the pipeline's
# (``parallel/pipeline.py``: every rank holds the whole layer stack and
# runs its stage's slice of it; the stage grads are summed over the mesh).
MANUAL_AXES: Tuple[str, ...] = ("pp", "sp")


def active_mesh(mesh):
    """The submesh on which the port places its DTensors: ``mesh``'s dims
    larger than 1 outside ``MANUAL_AXES`` (its last dim when there is
    none).  DTensor expands each op's sharding strategies over every mesh
    dim, at a cost exponential in their number, and on a dim that no
    tensor is split over it plans splits of its own (on a CPU, minutes of
    planning for one step on a 3-d mesh); so the mesh keeps all its named
    dims for the rules and the collectives, while the tensors live on the
    dims that split them.  Made once per mesh; the submesh knows its root
    (``sharding.placements_for`` reads it)."""
    act = getattr(mesh, "_rt_active", None)
    if act is not None:
        return act
    names = tuple(n for i, n in enumerate(mesh.mesh_dim_names)
                  if mesh.size(i) > 1 and n not in MANUAL_AXES) \
        or mesh.mesh_dim_names[-1:]
    if names == tuple(mesh.mesh_dim_names):
        act = mesh
    else:
        act = mesh[names if len(names) > 1 else names[0]]
        act._rt_root = mesh
    mesh._rt_active = act
    return act


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: sizes for each standard parallelism axis.

    Sizes of 1 are kept in the mesh (zero cost, lets sharding rules be
    written once regardless of which axes are active).
    """

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes.values())

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes over which the global batch is sharded."""
        return ("dp", "fsdp")

    @property
    def batch_shard_size(self) -> int:
        return self.dp * self.fsdp

    def build(self, device_type: Optional[str] = None):
        """The ``DeviceMesh`` over ranks ``[0, num_devices)`` with dims
        ``AXIS_ORDER`` (``"cuda"`` by default).  Raises when the world is
        smaller than ``num_devices``."""
        shape = tuple(self.axis_sizes.values())
        ranks = torch.arange(self.num_devices).reshape(shape)
        return device_mesh(device_type, ranks, AXIS_ORDER)

    @staticmethod
    def for_devices(n: int, *, tp: int = 1, pp: int = 1, sp: int = 1,
                    ep: int = 1, fsdp: Optional[int] = None) -> "MeshSpec":
        """Fill the remaining device budget with data parallelism."""
        used = tp * pp * sp * ep
        if n % used:
            raise ValueError(f"{n} devices not divisible by tp*pp*sp*ep={used}")
        rest = n // used
        if fsdp is None:
            fsdp, dp = rest, 1
        else:
            if rest % fsdp:
                raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
            dp = rest // fsdp
        return MeshSpec(dp=dp, fsdp=fsdp, pp=pp, ep=ep, sp=sp, tp=tp)


def mesh_shape_for_devices(n: int) -> Tuple[int, ...]:
    """Near-square 2D factorization of n (helper for ad-hoc meshes)."""
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    return (n // a, a)


def make_mesh(axis_sizes: Dict[str, int], device_type: Optional[str] = None):
    """A ``DeviceMesh`` from an arbitrary {axis: size} dict (order kept)
    over ranks ``[0, prod(sizes))``."""
    n = math.prod(axis_sizes.values())
    ranks = torch.arange(n).reshape(tuple(axis_sizes.values()))
    return device_mesh(device_type, ranks, tuple(axis_sizes))

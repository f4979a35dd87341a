"""Multi-slice meshes: dp across hosts, tp/sp/pp/ep/fsdp inside each host.

Port of ``ray_tpu/parallel/multislice.py``.  A slice is what one fast
interconnect domain holds: a TPU slice on ICI in the reference, the cards
of one host on NVLink here.  Only dp (one gradient reduction per step,
latency-tolerant) should cross the slower network between hosts, so the
OUTERMOST mesh axis enumerates slices and every inner-axis neighbourhood
stays inside one:

  * dp (gradient allreduce, once per step)   -> across hosts
  * fsdp/pp/ep/sp/tp (per-layer collectives)  -> inside a host

``slice_layout`` is the layout as a pure function of the ranks grouped by
host: ranks are ordered host-major, split into ``num_slices`` equal runs,
each run shaped into the inner axes, and (slice, dp_per_slice) folded into
the global dp axis.  ``slice_mesh`` builds the ``DeviceMesh`` from it, with
the hosts read from the world (each rank's host name) unless given.
``assert_slice_aligned`` checks the invariant against the hosts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, device_mesh

Hosts = Sequence[Sequence[int]]


def slice_layout(hosts: Hosts, *, num_slices: Optional[int] = None,
                 dp_per_slice: int = 1, fsdp: Optional[int] = None,
                 pp: int = 1, ep: int = 1, sp: int = 1, tp: int = 1
                 ) -> Tuple[np.ndarray, MeshSpec]:
    """(ranks [dp, fsdp, pp, ep, sp, tp], spec) for ranks grouped by host
    (``hosts[h]`` the ranks of host h).  ``num_slices`` defaults to the
    number of hosts (one slice per host); fsdp=None auto-fills the
    per-slice residual.  The spec has ``dp = num_slices * dp_per_slice``,
    so rules built for it apply unchanged."""
    ranks = [r for host in hosts for r in sorted(host)]
    if num_slices is None:
        num_slices = len(hosts)
    n = len(ranks)
    if n % num_slices:
        raise ValueError(f"{n} ranks not divisible into {num_slices} "
                         f"slices")
    per_slice = n // num_slices
    inner_used = dp_per_slice * pp * ep * sp * tp
    if per_slice % inner_used:
        raise ValueError(
            f"slice size {per_slice} not divisible by "
            f"dp_per_slice*pp*ep*sp*tp={inner_used}")
    resid = per_slice // inner_used
    if fsdp is None:
        fsdp = resid
    elif fsdp != resid:
        raise ValueError(f"fsdp={fsdp} but per-slice residual is {resid}")

    spec = MeshSpec(dp=num_slices * dp_per_slice, fsdp=fsdp, pp=pp, ep=ep,
                    sp=sp, tp=tp)
    # Slice-major, the inner axes within each slice, then (slice,
    # dp_per_slice) folded into the one global dp axis.
    inner_shape = (dp_per_slice, fsdp, pp, ep, sp, tp)
    arr = np.asarray(ranks, dtype=np.int64).reshape(
        (num_slices,) + inner_shape)
    return arr.reshape((num_slices * dp_per_slice,) + inner_shape[1:]), spec


def world_hosts() -> List[List[int]]:
    """The world's ranks grouped by host name, hosts in the order of their
    lowest rank (a collective: every rank calls it)."""
    import socket

    import torch.distributed as dist

    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    groups: Dict[str, List[int]] = {}
    for rank, name in enumerate(names):
        groups.setdefault(name, []).append(rank)
    return list(groups.values())


def slice_mesh(*, num_slices: Optional[int] = None, dp_per_slice: int = 1,
               fsdp: Optional[int] = None, pp: int = 1, ep: int = 1,
               sp: int = 1, tp: int = 1, hosts: Optional[Hosts] = None,
               device_type: Optional[str] = None):
    """Build a slice-aligned global mesh; returns (mesh, spec).  ``hosts``
    (ranks grouped by host) defaults to ``world_hosts()``; the mesh is on
    ``device_type`` (``"cuda"`` by default, as ``MeshSpec.build``)."""
    if hosts is None:
        hosts = world_hosts()
    ranks, spec = slice_layout(hosts, num_slices=num_slices,
                               dp_per_slice=dp_per_slice, fsdp=fsdp, pp=pp,
                               ep=ep, sp=sp, tp=tp)
    return device_mesh(device_type, ranks, AXIS_ORDER), spec


def assert_slice_aligned(mesh, num_slices: Optional[int] = None,
                         hosts: Optional[Hosts] = None) -> None:
    """Verify no inner-axis neighbourhood crosses a host boundary: for each
    dp-outer slice, all its ranks are on one host, so collectives on
    fsdp/pp/ep/sp/tp stay inside a host and only dp traffic crosses
    between hosts.  ``mesh`` is a DeviceMesh or its rank array; ``hosts``
    defaults to ``world_hosts()`` and ``num_slices`` to their number.  A
    no-op for one slice."""
    if hosts is None:
        hosts = world_hosts()
    if num_slices is None:
        num_slices = len(hosts)
    if num_slices <= 1:
        return
    ranks = np.asarray(getattr(mesh, "mesh", mesh))
    host_of = {r: h for h, group in enumerate(hosts) for r in group}
    dp = ranks.shape[0]
    if dp % num_slices:
        raise AssertionError(
            f"dp axis {dp} not divisible by num_slices {num_slices}")
    per = dp // num_slices
    for s in range(num_slices):
        on = {host_of[int(r)] for r in ranks[s * per:(s + 1) * per].flat}
        if len(on) != 1:
            raise AssertionError(
                f"slice {s} spans hosts {sorted(on)}: inner axes would put "
                f"per-layer collectives between hosts")


def dcn_axes() -> Tuple[str, ...]:
    """Mesh axes whose collectives cross hosts in a slice_mesh layout."""
    return ("dp",)


def ici_axes() -> Tuple[str, ...]:
    return tuple(a for a in AXIS_ORDER if a != "dp")

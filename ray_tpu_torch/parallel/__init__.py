"""ray_tpu_torch.parallel: mesh construction, sharding rules, collectives.

Port of ``ray_tpu/parallel``.  The reference's
recipe carries over: pick a mesh over the devices, annotate arrays with
logical axes, and let the framework emit the collectives.  Here the mesh
is a ``torch.distributed`` ``DeviceMesh`` over ranks (one per card), the
annotations become DTensor placements, and the collectives run over each
mesh dim's process group (NCCL on the card, gloo on the CPU):

    spec = MeshSpec(dp=2, fsdp=2, tp=2)        # 8 ranks
    mesh = spec.build()                         # "cuda"; "cpu" for gloo
    rules = LogicalAxisRules.for_transformer(spec)
    params = shard_params(params, mesh, rules, gpt_param_axes(cfg))
    step = make_train_step(cfg, optimizer, rules=rules, mesh=mesh)

Axes (any may be 1):
    dp    data parallel           — batch sharding, gradient all-reduce
    fsdp  fully-sharded DP (ZeRO) — batch + parameter sharding on one axis
    tp    tensor parallel         — hidden/heads sharding (Megatron layout)
    pp    pipeline parallel       — layer stages, the GPipe and 1F1B
                                    schedules of ``parallel.pipeline``
    sp    sequence/context        — ring attention over the sequence
    ep    expert parallel         — MoE expert sharding
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshSpec,
    make_mesh,
    mesh_shape_for_devices,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    LogicalAxisRules,
    P,
    init_sharded,
    logical_sharding,
    placements_for,
    shard_map,
    shard_params,
    with_logical_constraint,
)
from ray_tpu_torch.parallel.multislice import (  # noqa: F401
    assert_slice_aligned,
    dcn_axes,
    ici_axes,
    slice_layout,
    slice_mesh,
)
from ray_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    barrier_sum,
    ppermute_ring,
    psum_scatter,
)

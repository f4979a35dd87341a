"""Rank functions for the port's multi-rank CPU tests (gloo gangs).

``ray_tpu_torch.parallel.gang.run_gang`` starts each gang in fresh
processes, which import this module to find the function: so it imports
torch and the port only, never JAX (the tests compare what rank 0 returns
with the JAX package in the pytest process).  Each function builds its
meshes with ``device_type="cpu"`` and returns numpy arrays and numbers.
"""

import contextlib
import os
import tempfile

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel import (LogicalAxisRules, MeshSpec, P,
                                    all_gather, all_reduce, all_to_all,
                                    barrier_sum, init_sharded, make_mesh,
                                    ppermute_ring, psum_scatter, shard_map,
                                    shard_params, with_logical_constraint)
from ray_tpu_torch.parallel.gang import run_gang
from ray_tpu_torch.parallel.sharding import placements_for

CPU = "cpu"


@contextlib.contextmanager
def one_gang_at_a_time():
    """Hold a lock file in the temp dir for the block.  Each rank of a gang
    takes a core, so two gangs of parallel test workers at once stretch
    each other past their deadlines: the tests run their gangs, and the
    dryrun twin's, one at a time."""
    import fcntl
    path = os.path.join(tempfile.gettempdir(), "rt_torch_gang.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run(fn, world_size, args=(), timeout_s=120.0):
    """``run_gang`` under ``one_gang_at_a_time`` (its deadline starts once
    the lock is held)."""
    with one_gang_at_a_time():
        return run_gang(fn, world_size, args, timeout_s=timeout_s)


def _np(x):
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().numpy()


# ------------------------------------------------------------ parallel

def parallel_world8(rank, world, paged):
    """tests/test_torch_parallel.py on 8 ranks."""
    out = {}
    mesh = MeshSpec(dp=2, fsdp=2, tp=2).build(CPU)
    out["names"] = tuple(mesh.mesh_dim_names)
    out["sizes"] = {n: mesh.size(i) for i, n in enumerate(out["names"])}
    try:
        MeshSpec(dp=16).build(CPU)
    except ValueError as e:
        out["too_small"] = str(e)

    xm = make_mesh({"x": 8}, CPU)
    x = torch.arange(8.0)
    spec = (P("x"),)
    for op in ("sum", "mean", "max", "min"):
        out[f"all_reduce_{op}"] = _np(shard_map(
            lambda v, op=op: all_reduce(v, "x", op), xm, spec, P("x"))(x))
    out["all_gather"] = _np(shard_map(lambda v: all_gather(v, "x"), xm,
                                      spec, P(None))(x))
    out["ppermute"] = _np(shard_map(lambda v: ppermute_ring(v, "x"), xm,
                                    spec, P("x"))(x))
    out["barrier"] = int(shard_map(lambda v: v + barrier_sum("x"), xm, spec,
                                   P("x"))(x.int()).full_tensor().sum())
    # ppermute's gradient is the inverse rotation of the cotangent.
    xg = torch.arange(8.0, requires_grad=True)
    w = torch.arange(8.0) ** 2
    y = shard_map(lambda v: ppermute_ring(v, "x", shift=3), xm, spec,
                  P("x"))(xg)
    (y.full_tensor() * w).sum().backward()
    out["ppermute_value"], out["ppermute_grad"] = _np(y), _np(xg.grad)

    # shard_params / init_sharded on tp=2 x fsdp=4
    spec2 = MeshSpec(tp=2, fsdp=4)
    mesh2 = spec2.build(CPU)
    rules = LogicalAxisRules.for_transformer(spec2)
    ann = {"w": ("embed", "mlp"), "b": ("mlp",)}

    def init():
        return {"w": torch.arange(128.0).reshape(8, 16),
                "b": torch.ones(16)}

    a = init_sharded(init, mesh2, rules, ann)
    b = shard_params(init(), mesh2, rules, ann)
    out["w_local"] = tuple(b["w"].to_local().shape)
    out["b_local"] = tuple(b["b"].to_local().shape)
    out["same_placements"] = (a["w"].placements == b["w"].placements
                              and a["b"].placements == b["b"].placements)
    out["init_sharded_w"], out["shard_params_w"] = _np(a["w"]), _np(b["w"])
    # A constraint redistributes a DTensor (embed -> fsdp is taken by
    # batch here) and passes a plain tensor through.
    act = with_logical_constraint(
        b["w"], rules, ("batch", "mlp"))
    out["constraint_local"] = tuple(act.to_local().shape)
    out["constraint_value"] = _np(act)
    plain = torch.ones(3)
    out["plain_passes"] = with_logical_constraint(
        plain, rules, ("batch",)) is plain
    try:
        placements_for(mesh2, P(("tp", "fsdp")))
    except ValueError as e:
        out["order"] = str(e)

    # GQA paged attention split over KV heads, no collective.
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   sharded_paged_attention)
    pm = make_mesh({"model": 8}, CPU)
    args = [torch.from_numpy(a) for a in paged]
    fn = sharded_paged_attention(pm, model_axis="model")
    out["paged"] = _np(fn(*args))
    out["paged_plain"] = _np(paged_attention(*args))
    return out if rank == 0 else None


def parallel_world4(rank, world, y):
    """The 4-rank checks of tests/test_parallel.py."""
    xm = make_mesh({"x": 4}, CPU)
    x = torch.arange(16.0).reshape(4, 4)        # each rank holds a row
    out = {"psum_scatter": _np(shard_map(
        lambda v: psum_scatter(v[0], "x")[None], xm, (P("x"),), P("x"))(x))}
    yt = torch.from_numpy(y)

    def roundtrip(v):
        t = all_to_all(v, "x", split_axis=1, concat_axis=0)
        return all_to_all(t, "x", split_axis=0, concat_axis=1)

    out["all_to_all"] = _np(shard_map(roundtrip, xm, (P("x"),), P("x"))(yt))

    # Gradients through each differentiable collective: the loss weighs
    # the output's elements by (index)^2.
    for name, fn in (
            ("psum_scatter", lambda v: psum_scatter(v[0], "x")[None]),
            ("all_gather", lambda v: all_gather(v[0], "x")[None]),
            ("all_to_all", lambda v: all_to_all(v, "x", 1, 0)),
            ("all_reduce", lambda v: all_reduce(v, "x"))):
        xg = torch.arange(16.0).reshape(4, 4).requires_grad_(True)
        y = shard_map(fn, xm, (P("x"),), P("x"))(xg).full_tensor()
        w = (torch.arange(float(y.numel())) ** 2).reshape(y.shape)
        (y * w).sum().backward()
        out[f"{name}_grad"] = xg.grad.numpy()
    return out if rank == 0 else None


# ------------------------------------------------------ ring attention

def _ring(q, k, v, mesh, grad=False):
    from ray_tpu_torch.ops.ring_attention import ring_attention
    q, k, v = (torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v))
    o = ring_attention(q, k, v, mesh)
    if not grad:
        return _np(o)
    o.full_tensor().sum().backward()
    return _np(o), q.grad.numpy()


def ring_world8(rank, world, sp8, dp2sp4):
    out = {"sp8": _ring(*sp8, MeshSpec(sp=8).build(CPU)),
           "dp2_sp4": _ring(*dp2sp4, MeshSpec(dp=2, sp=4).build(CPU))}
    return out if rank == 0 else None


def ring_world4(rank, world, grads, ulysses, sp1):
    from ray_tpu_torch.ops.ring_attention import (make_ring_attention_fn,
                                                  ulysses_attention)
    out = {}
    out["grads_out"], out["grads_q"] = _ring(*grads, MeshSpec(sp=4).build(
        CPU), grad=True)
    um = make_mesh({"sp": 4}, CPU)
    spec = P(None, "sp", None, None)
    q, k, v = (torch.from_numpy(a) for a in ulysses)
    out["ulysses"] = _np(shard_map(ulysses_attention, um,
                                   (spec, spec, spec), spec)(q, k, v))
    # sp = 1: one causal block, no ring step; make_ring_attention_fn
    # refuses the mesh
    dp4 = MeshSpec(dp=4).build(CPU)
    out["sp1"] = _ring(*sp1, dp4)
    try:
        make_ring_attention_fn(dp4)
    except ValueError as e:
        out["sp1_refused"] = str(e)
    return out if rank == 0 else None


# ------------------------------------------------------------------ MoE

def _moe_gpt_cfg(**kw):
    from ray_tpu_torch.models import GPTConfig
    base = dict(vocab_size=128, max_seq_len=32, num_layers=2, num_heads=2,
                embed_dim=32, dtype=torch.float32, num_experts=4,
                expert_top_k=2)
    base.update(kw)
    return GPTConfig(**base)


def moe_world8(rank, world, tree, tokens, x, p):
    """dp=2 x ep=4: MoE GPT's forward sharded, moe_mlp in GSPMD mode on
    that mesh, and moe_mlp in ep_axis mode under shard_map."""
    from ray_tpu_torch.models import params_from_jax
    from ray_tpu_torch.models.gpt import gpt_forward_with_aux, gpt_param_axes
    from ray_tpu_torch.ops.moe import moe_mlp
    from ray_tpu_torch.parallel.sharding import local_to_dtensor
    from ray_tpu_torch.parallel.mesh import active_mesh
    from ray_tpu_torch.parallel.sharding import logical_sharding

    out = {}
    cfg = _moe_gpt_cfg()
    spec = MeshSpec(dp=2, ep=4)
    mesh = spec.build(CPU)
    rules = LogicalAxisRules.for_transformer(spec)
    params = shard_params(params_from_jax(tree, cfg, device=CPU), mesh,
                          rules, gpt_param_axes(cfg))
    logits, aux = gpt_forward_with_aux(params, torch.from_numpy(tokens), cfg,
                                       rules)
    out["logits"], out["aux"] = _np(logits), float(_np(aux))

    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    act = active_mesh(mesh)
    axes = {"router": ("embed", None), "wi": ("expert", "embed", "mlp"),
            "bi": ("expert", "mlp"), "wo": ("expert", "mlp", "embed"),
            "bo": ("expert", "embed")}
    ps = shard_params(pt, mesh, rules, axes)
    xs = local_to_dtensor(xt, act, logical_sharding(
        act, rules, ("batch", "seq", "embed")))

    def lc(a, ax):
        return with_logical_constraint(a, rules, ax)

    y, aux = moe_mlp(xs, ps, top_k=2, capacity_factor=1.25, lc=lc)
    out["gspmd_y"], out["gspmd_aux"] = _np(y), float(_np(aux))

    def ep_mode(x, router, wi, bi, wo, bo):
        return moe_mlp(x, {"router": router, "wi": wi, "bi": bi, "wo": wo,
                           "bo": bo}, top_k=2, capacity_factor=1.25,
                       ep_axis="ep")

    rep, exp = P(), P("ep")
    y, aux = shard_map(ep_mode, mesh, (rep, rep, exp, exp, exp, exp),
                       (P(), P()))(xt, pt["router"], pt["wi"], pt["bi"],
                                   pt["wo"], pt["bo"])
    out["ep_y"], out["ep_aux"] = _np(y), float(_np(aux))
    return out if rank == 0 else None


# ------------------------------------------------------- sharded models

def _train(make_state, step_fn, cfg, axes, spec, tokens, steps,
           optimizer):
    """Losses of ``steps`` steps from the params ``make_state()`` returns,
    sharded over ``spec`` (or not, for None)."""
    params = make_state()
    rules = mesh = None
    if spec is not None:
        mesh = spec.build(CPU)
        rules = LogicalAxisRules.for_transformer(spec)
        params = shard_params(params, mesh, rules, axes(cfg))
    from ray_tpu_torch.models.gpt import _leaves
    leaves = [q.requires_grad_(True) for q in _leaves(params)]
    step = step_fn(cfg, optimizer(leaves), rules=rules, mesh=mesh)
    batch = {"tokens": torch.from_numpy(tokens)}
    return [float(step(params, batch)["loss"]) for _ in range(steps)]


# The parts of the sharded-models test, each its own 8-rank gang under its
# own deadline: one gang for all of them outgrew its 120 s deadline under
# load, and failed every case.
MODEL_PARTS = ("gpt_decreases_1d", "gpt_decreases_3d", "llama_decreases",
               "match", "flash", "ring")


def models_world8(rank, world, part, gpt_tree, llama_tree, batch8, batch8_7,
                  batch4, ring_qkv):
    """One ``part`` of ``MODEL_PARTS`` of tests/test_torch_sharded_models.py
    on 8 ranks; rank 0 returns its results."""
    from ray_tpu_torch.autotune import dispatch
    from ray_tpu_torch.models import (GPTConfig, LlamaConfig,
                                      params_from_jax)
    from ray_tpu_torch.models.gpt import gpt_init, gpt_param_axes
    from ray_tpu_torch.models.gpt import make_train_step as gpt_step
    from ray_tpu_torch.models.llama import (llama_init, llama_param_axes,
                                            make_train_step as llama_step)

    tiny = dict(vocab_size=128, max_seq_len=32, num_layers=2,
                dtype=torch.float32)
    gcfg = GPTConfig(num_heads=2, embed_dim=16, **tiny)
    lcfg = LlamaConfig(num_heads=4, num_kv_heads=2, embed_dim=16,
                       mlp_dim=48, **tiny)

    def adam(leaves):
        return torch.optim.Adam(leaves, lr=1e-2)

    def sgd(leaves):
        return torch.optim.SGD(leaves, lr=1e-2)

    out = {}
    gpt_meshes = {
        "gpt_decreases_1d": (("dp8", MeshSpec(dp=8)),
                             ("fsdp8", MeshSpec(fsdp=8))),
        "gpt_decreases_3d": (("dp2_fsdp2_tp2", MeshSpec(dp=2, fsdp=2, tp=2)),
                             ("fsdp2_sp2_tp2", MeshSpec(fsdp=2, sp=2, tp=2)))}
    if part in gpt_meshes:
        out["gpt_decreases"] = {
            name: _train(lambda: gpt_init(0, gcfg, device=CPU), gpt_step,
                         gcfg, gpt_param_axes, spec, batch8, 5, adam)
            for name, spec in gpt_meshes[part]}
    elif part == "llama_decreases":
        out["llama_decreases"] = {
            name: _train(lambda: llama_init(0, lcfg, device=CPU), llama_step,
                         lcfg, llama_param_axes, spec, batch8, 5, adam)
            for name, spec in (
                ("dp8", MeshSpec(dp=8)),
                ("dp2_fsdp2_tp2", MeshSpec(dp=2, fsdp=2, tp=2)))}
    elif part == "match":
        # Same weights (the JAX init), same batch, two SGD steps: sharded
        # against one device.
        for fam, cfg, tree, axes, step in (
                ("gpt", gcfg, gpt_tree, gpt_param_axes, gpt_step),
                ("llama", lcfg, llama_tree, llama_param_axes, llama_step)):
            out[f"{fam}_match"] = {
                name: _train(lambda: params_from_jax(tree, cfg, device=CPU),
                             step, cfg, axes, spec, batch8_7, 2, sgd)[-1]
                for name, spec in (("single", None),
                                   ("dp8", MeshSpec(dp=8)),
                                   ("tp2_fsdp4", MeshSpec(tp=2, fsdp=4)))}
    elif part == "flash":
        # The flash op on a mesh, under remat "dots" and the blocked head.
        fcfg = GPTConfig(num_heads=2, embed_dim=16, attention="flash",
                         remat=True, remat_policy="dots", ce_block=8, **tiny)
        out["flash_match"] = {
            name: _train(lambda: params_from_jax(gpt_tree, fcfg, device=CPU),
                         gpt_step, fcfg, gpt_param_axes, spec, batch8_7, 2,
                         sgd)[-1]
            for name, spec in (("single", None),
                               ("dp2_fsdp2_tp2",
                                MeshSpec(dp=2, fsdp=2, tp=2)))}
    elif part == "ring":
        rcfg = GPTConfig(num_heads=2, embed_dim=16, attention="ring", **tiny)
        out["ring_trains"] = _train(
            lambda: gpt_init(0, rcfg, device=CPU), gpt_step, rcfg,
            gpt_param_axes, MeshSpec(fsdp=2, sp=2, tp=2), batch4, 4, adam)

        # The dispatcher's ring variant (mirrors tests/test_autotune.py:272).
        mesh = MeshSpec(dp=2, sp=4).build(CPU)
        q, k, v = (torch.from_numpy(a) for a in ring_qkv)
        out["dispatch_ring"] = _np(dispatch.attention(
            q, k, v, causal=True, variant="ring", mesh=mesh))
        kd = {"B": 2, "S": 32, "N": 2, "H": 8, "dtype": "float32",
              "causal": True}
        out["ring_applicable"] = dispatch.applicable_variants(
            kd, torch.device(CPU), mesh)
        os.environ["RT_AUTOTUNE_CACHE"] = os.path.join(
            tempfile.mkdtemp(prefix="rt_gang_cache_"), "autotune.jsonl")
        rec = dispatch.tune_attention(2, 32, 2, 8, "float32", device=CPU,
                                      mesh=mesh, variants=("ring", "dense"))
        out["ring_tuned"] = sorted(rec["meta"]["timings"])
    else:
        raise ValueError(f"no part {part!r} (have {MODEL_PARTS})")
    return out if rank == 0 else None


# ------------------------------------------------------------------ data

def data_sharded_ingest(rank, world, rows, specs):
    """``Dataset.iter_device_batches(sharding=(mesh, spec))`` on a CPU
    mesh dp=2 x tp=2 in local mode: for each spec, each batch's type,
    placements, local shard and full tensor, as rank 0 sees them (every
    rank takes part in ``full_tensor``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    rt.init(local_mode=True)
    try:
        mesh = make_mesh({"dp": 2, "tp": 2}, CPU)
        ds = rd.from_numpy(rows, parallelism=4)
        out = {}
        for name, spec in specs.items():
            got = []
            for b in ds.iter_device_batches(batch_size=8,
                                            sharding=(mesh, P(*spec))):
                x = b["data"]
                got.append({"type": type(x).__name__,
                            "placements": [(type(p).__name__,
                                            getattr(p, "dim", None))
                                           for p in x.placements],
                            "local": x.to_local().numpy().copy(),
                            "full": x.full_tensor().numpy().copy()})
            out[name] = got
        return out
    finally:
        rt.shutdown()


def fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")
    torch.distributed.barrier()         # the others wait for rank 1
    return rank


def hang(rank, world):
    torch.distributed.barrier()
    if rank == 1:
        import time
        time.sleep(600)                 # a rank that never finishes
    return rank


# ------------------------------------------------------------- pipeline

def _pp_cfg(**kw):
    from ray_tpu_torch.models import GPTConfig
    base = dict(vocab_size=128, max_seq_len=32, num_layers=4, num_heads=2,
                embed_dim=32, dtype=torch.float32)
    base.update(kw)
    return GPTConfig(**base)


def _pp_params(tree, cfg):
    from ray_tpu_torch.models import params_from_jax
    from ray_tpu_torch.models.gpt import _leaves
    params = params_from_jax(tree, cfg, device=CPU)
    for p in _leaves(params):
        p.requires_grad_(True)
    return params


def _named(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _named(v, name)
        else:
            yield name, v


def _pp_grads(fn, case, cfg, spec, M):
    """(loss, grads as the params' tree of numpy arrays) of one backward of
    the pipelined loss ``fn`` on the case's (JAX params, tokens)."""
    from ray_tpu_torch.models.gpt import _leaves
    tree, tokens = case
    params = _pp_params(tree, cfg)
    loss = fn(params, {"tokens": torch.from_numpy(tokens)}, cfg,
              spec.build(CPU), num_microbatches=M)
    loss.backward()
    grads = {name: p.grad.float().numpy() for name, p in _named(params)}
    assert len(grads) == len(list(_leaves(params)))
    return float(loss), grads


def _pp_loss(fn, case, cfg, spec, M):
    tree, tokens = case
    with torch.no_grad():
        return float(fn(_pp_params(tree, cfg),
                        {"tokens": torch.from_numpy(tokens)}, cfg,
                        spec.build(CPU), num_microbatches=M))


def pipeline_world8(rank, world, setup, moe, moe_train, ring):
    """tests/test_torch_pipeline.py's 8-rank cases: GPipe and 1F1B loss and
    grads over pp=2 x dp=4, the pipelined forward's logits, MoE stages over
    pp=2 x ep=2 x dp=2 (loss; one training step), both schedules' MoE
    grads over pp=2 x dp=2 x tp=2, ring stages over pp=2 x sp=2 x dp=2.  Every rank returns a digest of its grads, so the test
    sees that they all hold the same whole gradient."""
    from ray_tpu_torch.parallel import pipeline as pl
    from ray_tpu_torch.models.gpt import _leaves

    out = {}
    cfg = _pp_cfg()
    pp2dp4 = MeshSpec(dp=4, pp=2)
    out["gpipe"] = _pp_grads(pl.gpt_loss_pipelined, setup, cfg, pp2dp4, 4)
    out["1f1b"] = _pp_grads(pl.gpt_loss_1f1b, setup, cfg, pp2dp4, 4)
    tree, tokens = setup
    logits, aux = pl.gpt_forward_pipelined(
        _pp_params(tree, cfg), torch.from_numpy(tokens[:, :-1]), cfg,
        pp2dp4.build(CPU), num_microbatches=4)
    out["forward"] = (logits.numpy(), float(aux))

    mcfg = _pp_cfg(num_experts=4, expert_top_k=2)
    moe_mesh = MeshSpec(dp=2, pp=2, ep=2)
    out["moe"] = _pp_loss(pl.gpt_loss_pipelined, moe, mcfg, moe_mesh, 4)
    tree, tokens = moe_train
    params = _pp_params(tree, mcfg)
    before = {n: t.detach().clone() for n, t in _named(params["layers"])}
    opt = torch.optim.AdamW(list(_leaves(params)), lr=1e-3,
                            weight_decay=1e-4)
    step = pl.make_pipeline_train_step(mcfg, opt, moe_mesh.build(CPU),
                                       num_microbatches=4)
    m = step(params, {"tokens": torch.from_numpy(tokens)})
    out["moe_train"] = (float(m["loss"]), {
        n: float((t.detach() - before[n]).abs().max())
        for n, t in _named(params["layers"]) if n.startswith("mlp.")})

    # 1F1B's aux cotangent and its division by a redundant axis (tp, on
    # which every rank repeats its work), against GPipe's autograd
    acfg = _pp_cfg(num_experts=4, expert_top_k=2, moe_aux_coef=0.5)
    spec = MeshSpec(dp=2, pp=2, tp=2)
    out["moe_1f1b"] = {name: _pp_grads(fn, moe, acfg, spec, 4)
                       for name, fn in (("gpipe", pl.gpt_loss_pipelined),
                                        ("1f1b", pl.gpt_loss_1f1b))}

    rcfg = _pp_cfg(max_seq_len=64, attention="ring")
    out["ring"] = _pp_grads(pl.gpt_loss_pipelined, ring, rcfg,
                            MeshSpec(dp=2, pp=2, sp=2), 4)
    digest = {k: (v[0], {n: float((g.astype("float64") ** 2).sum())
                         for n, g in v[1].items()})
              for k, v in out.items() if k in ("gpipe", "1f1b", "ring")}
    return out if rank == 0 else digest


def pipeline_world4(rank, world, odd, flash, bf16):
    """The 4-rank cases (pp=2 x dp=2): an odd microbatch count (M=3), flash
    stages (the plain versions here), 1F1B in the default bf16 compute
    dtype, and the shape checks."""
    from ray_tpu_torch.parallel import pipeline as pl

    out = {}
    spec = MeshSpec(dp=2, pp=2)
    cfg = _pp_cfg()
    out["odd"] = _pp_loss(pl.gpt_loss_pipelined, odd, cfg, spec, 3)
    out["flash"] = _pp_loss(pl.gpt_loss_pipelined, flash,
                            _pp_cfg(attention="flash"), spec, 4)
    bcfg = _pp_cfg(dtype=torch.bfloat16)
    loss, grads = _pp_grads(pl.gpt_loss_1f1b, bf16, bcfg, spec, 4)
    out["bf16"] = (loss, {n: bool(np.isfinite(g).all())
                          for n, g in grads.items()})
    tree, tokens = odd
    errors = {}
    for name, c, m, rows in (("layers", _pp_cfg(num_layers=3), 3, 12),
                             ("batch", cfg, 5, 12), ("data", cfg, 4, 12)):
        try:
            pl.gpt_loss_pipelined(_pp_params(tree, cfg),
                                  {"tokens": torch.from_numpy(
                                      tokens[:rows])}, c, spec.build(CPU),
                                  num_microbatches=m)
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out if rank == 0 else None


def pipeline_learns(rank, world, case, M, schedule, steps, lr):
    """Losses of ``steps`` AdamW steps (optax.adamw's settings) of a
    pipelined train step over pp=2 x dp=(world / 2)."""
    from ray_tpu_torch.models.gpt import _leaves
    from ray_tpu_torch.parallel import pipeline as pl
    cfg = _pp_cfg()
    tree, tokens = case
    params = _pp_params(tree, cfg)
    make = (pl.make_1f1b_train_step if schedule == "1f1b"
            else pl.make_pipeline_train_step)
    step = make(cfg, torch.optim.AdamW(list(_leaves(params)), lr=lr,
                                       weight_decay=1e-4),
                MeshSpec(dp=world // 2, pp=2).build(CPU), num_microbatches=M)
    batch = {"tokens": torch.from_numpy(tokens)}
    return [float(step(params, batch)["loss"]) for _ in range(steps)]


def pipeline_memory(rank, world, case, M):
    """Each schedule's activation bytes (``schedule_activation_bytes``)
    over pp=2 x dp=(world / 2)."""
    from ray_tpu_torch.parallel import pipeline as pl
    cfg = _pp_cfg()
    tree, tokens = case
    return pl.schedule_activation_bytes(
        _pp_params(tree, cfg), {"tokens": torch.from_numpy(tokens)}, cfg,
        MeshSpec(dp=world // 2, pp=2).build(CPU), num_microbatches=M)


# --------------------------------------------------------- DCP checkpoint

def dcp_world8(rank, world, root):
    """tests/test_torch_orbax_checkpoint.py on 8 ranks: a sharded save and
    restore on dp=2 x fsdp=2 x tp=2, then the envelope on dp=8."""
    from ray_tpu_torch.train.torch import (TorchCheckpoint, restore_sharded,
                                           save_sharded)
    out = {}
    spec = MeshSpec(dp=2, fsdp=2, tp=2)
    mesh = spec.build(CPU)
    rules = LogicalAxisRules.for_transformer(spec)
    axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    tree = shard_params({"w": torch.arange(64.0).reshape(8, 8),
                         "b": torch.ones(8)}, mesh, rules, axes)
    path = os.path.join(root, "ck")
    save_sharded(path, tree)
    # Restore onto the SAME shardings: shards land in place.
    target = shard_params({"w": torch.zeros(8, 8), "b": torch.zeros(8)},
                          mesh, rules, axes)
    restored = restore_sharded(path, target=target)
    out["same_placements"] = all(
        restored[k].placements == tree[k].placements for k in tree)
    out["w"], out["b"] = _np(restored["w"]), _np(restored["b"])
    out["w_local_equal"] = bool(torch.equal(restored["w"].to_local(),
                                            tree["w"].to_local()))
    # Without a target: whole tensors on the CPU.
    flat = restore_sharded(path)
    out["flat_w"] = flat["w"].numpy()
    out["flat_is_plain"] = not isinstance(flat["w"], DTensor)

    MeshSpec(dp=8).build(CPU)
    state = {"p": torch.full((16, 4), 3.0)}
    ckpt = TorchCheckpoint.from_sharded_state(
        state, path=os.path.join(root, "env"), step=7)
    out["meta"] = ckpt.meta()
    out["p"] = ckpt.load_state()["p"].numpy()
    return out

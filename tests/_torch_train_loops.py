"""Train loops that the port's trainer tests run in the cluster's workers.

The tests that hold these loops to the JAX package import JAX; the workers
must not (they import the module of each loop they run), so the loops live
here, in a module that imports no JAX and nothing of ``ray_tpu``.  Every
loop runs on the CPU (``device="cpu"``) and reports through the session.
"""

import numpy as np

from ray_tpu_torch.air import session


def loop_allreduce(config):
    """Each rank contributes its rank to an all-reduce over the world the
    trainer set up (the reference's cross-process psum)."""
    import torch
    import torch.distributed as dist

    assert dist.is_initialized()
    x = torch.full((2,), float(dist.get_rank()))
    dist.all_reduce(x)
    session.report({"psum": float(x[0]),
                    "num_processes": dist.get_world_size(),
                    "backend": dist.get_backend(),
                    "rank": session.get_world_rank()})


def loop_dp_regression(config):
    """A data-parallel step: per-rank batches of 64 rows (the reference's
    ``local * 8`` on its 8 virtual devices), grads averaged across the
    world by DDP (the reference's pmean inside the differentiated loss)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train.torch import prepare_model

    rank = dist.get_rank()
    model = prepare_model(torch.nn.Linear(4, 1, bias=False), device="cpu")
    with torch.no_grad():
        model.module.weight.zero_()
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    gen = torch.Generator().manual_seed(rank)
    xs = torch.randn((64, 4), generator=gen)
    true_w = torch.tensor([1.0, -2.0, 3.0, 0.5])
    ys = (xs @ true_w)[:, None]
    for _ in range(60):
        opt.zero_grad()
        loss = torch.mean((model(xs) - ys) ** 2)
        loss.backward()
        opt.step()
    mean_loss = loss.detach().clone()
    dist.all_reduce(mean_loss)
    w = model.module.weight.detach()[0]
    session.report({"loss": float(mean_loss) / dist.get_world_size(),
                    "w_err": float((w - true_w).abs().max())})


def loop_slice_mesh_gpt(config):
    """GPT step over a slice-aligned mesh from inside the trainer: dp
    crosses the worker processes, params (given as the JAX init's numpy
    tree) born sharded, each rank feeding its own rows of the batch.
    Reports the step's loss (before the update) and the whole batch."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import (GPTConfig, gpt_param_axes,
                                      make_train_step, params_from_jax)
    from ray_tpu_torch.models.gpt import _leaves
    from ray_tpu_torch.parallel import (LogicalAxisRules,
                                        assert_slice_aligned, init_sharded,
                                        slice_mesh)
    from ray_tpu_torch.parallel.mesh import active_mesh
    from ray_tpu_torch.parallel.sharding import logical_sharding

    world = session.get_world_size()
    rank = session.get_world_rank()
    mesh, spec = slice_mesh(num_slices=world, device_type="cpu")
    assert_slice_aligned(mesh, world)
    rules = LogicalAxisRules.for_transformer(spec)
    cfg = GPTConfig(dtype=torch.float32, **config["cfg"])
    params = init_sharded(
        lambda: params_from_jax(config["params"], cfg, device="cpu"), mesh,
        rules, gpt_param_axes(cfg))
    opt = torch.optim.AdamW([p.requires_grad_(True) for p in _leaves(params)],
                            lr=1e-3, weight_decay=1e-4)
    step = make_train_step(cfg, opt, rules=rules, mesh=mesh)
    gb = max(2, spec.batch_shard_size)
    local = np.random.RandomState(rank).randint(
        0, cfg.vocab_size, (gb // world, cfg.max_seq_len + 1))
    act = active_mesh(mesh)
    tokens = DTensor.from_local(
        torch.from_numpy(local), act,
        logical_sharding(act, rules, ("batch", None)), run_check=False)
    loss = float(step(params, {"tokens": tokens})["loss"])
    session.report({"loss": loss, "dp": spec.dp, "procs": world,
                    "rows": local.tolist()})


def loop_gpt_train(config):
    """The port's training step in one worker: a small GPT from the JAX
    init's numpy tree, AdamW(3e-4, b2 0.95, wd 1e-4), one report a step."""
    import torch

    from ray_tpu_torch.models import (GPTConfig, make_train_state,
                                      make_train_step, params_from_jax)
    from ray_tpu_torch.models.gpt import _leaves

    cfg = GPTConfig(dtype=torch.float32, **config["cfg"])
    params, opt = make_train_state(0, cfg, learning_rate=3e-4,
                                   weight_decay=1e-4, device="cpu")
    start = params_from_jax(config["params"], cfg, device="cpu")
    with torch.no_grad():
        for leaf, value in zip(_leaves(params), _leaves(start)):
            leaf.copy_(value)
    step = make_train_step(cfg, opt)
    for toks in config["batches"]:
        m = step(params, {"tokens": torch.from_numpy(np.asarray(toks))})
        session.report({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})

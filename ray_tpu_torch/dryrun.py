"""A multi-rank dry run of the port's sharded training step.

The twin of ``dryrun_multichip`` in the repo's ``__graft_entry__.py``: the
stages ``main`` (a GPT train step over dp/fsdp/pp/sp/tp, ring attention
when sp > 1), ``moe`` (MoE GPT over ep=2), ``multislice`` (the ranks
split into two hosts, dp across them) and ``pipeline`` (the reference's
``dryrun_pipeline``: GPipe and 1F1B train steps over pp) each run as a
gang of ``n`` ranks (``parallel.gang.run_gang``: fresh processes, a
file-store rendezvous), one after another under one shared deadline, and
print their loss lines.  The ``rl`` stage (PPO with its learner over
``n`` devices for two ``train()`` calls) runs last in this process, as
the reference's does: the dp learner is one process over n devices, not
a gang (n cards on ``"cuda"``, n virtual shards on ``"cpu"``).

``device_type`` is ``"cuda"`` by default (NCCL, one card per rank: it
raises without ``n`` cards); ``"cpu"`` runs gloo ranks on the CPU.

    python -m ray_tpu_torch.dryrun 8 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

WAITING: Dict[str, str] = {}
DEADLINE_S = 280.0


def _device(device_type: str) -> str:
    return "cuda" if device_type == "cuda" else "cpu"


def _adamw(params, lr: float = 1e-3):
    """``optax.adamw(lr)``'s settings (b2 0.999, eps 1e-8, decay 1e-4)."""
    import torch

    from ray_tpu_torch.models.gpt import _leaves
    leaves = [p.requires_grad_(True) for p in _leaves(params)]
    return torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-4)


def _main_stage(rank: int, world: int, device_type: str) -> str:
    """The full training step over an n-rank mesh: tp, sp and pp each take
    a factor of 2 when available, the rest goes to fsdp."""
    import torch

    from ray_tpu_torch.models.gpt import (GPTConfig, gpt_init,
                                          gpt_param_axes, make_train_step)
    from ray_tpu_torch.parallel import LogicalAxisRules, MeshSpec
    from ray_tpu_torch.parallel.sharding import shard_params

    rem = world
    tp = 2 if rem % 2 == 0 and rem >= 2 else 1
    rem //= tp
    sp = 2 if rem % 2 == 0 and rem >= 2 else 1
    rem //= sp
    pp = 2 if rem % 2 == 0 and rem >= 2 else 1
    rem //= pp
    spec = MeshSpec(dp=1, fsdp=rem, pp=pp, sp=sp, tp=tp)
    mesh = spec.build(device_type)
    rules = LogicalAxisRules.for_transformer(spec)
    cfg = GPTConfig(vocab_size=256, max_seq_len=128, num_layers=4,
                    num_heads=4, embed_dim=64, dtype=torch.float32,
                    attention="ring" if sp > 1 else "dense")
    params = shard_params(gpt_init(0, cfg, device=_device(device_type)),
                          mesh, rules, gpt_param_axes(cfg))
    step = make_train_step(cfg, _adamw(params), rules=rules, mesh=mesh)
    batch = {"tokens": torch.ones((max(2, spec.batch_shard_size), 129),
                                  dtype=torch.long)}
    loss = float(step(params, batch)["loss"])
    return (f"dryrun_multichip(n={world}): mesh={spec.axis_sizes} "
            f"loss={loss:.4f}")


def _moe_stage(rank: int, world: int, device_type: str) -> str:
    import torch

    from ray_tpu_torch.models.gpt import (GPTConfig, gpt_init,
                                          gpt_param_axes, make_train_step)
    from ray_tpu_torch.parallel import LogicalAxisRules, MeshSpec
    from ray_tpu_torch.parallel.sharding import shard_params

    spec = MeshSpec(dp=world // 2, ep=2)
    mesh = spec.build(device_type)
    rules = LogicalAxisRules.for_transformer(spec)
    cfg = GPTConfig(vocab_size=256, max_seq_len=64, num_layers=2,
                    num_heads=4, embed_dim=64, dtype=torch.float32,
                    num_experts=4, expert_top_k=2)
    params = shard_params(gpt_init(0, cfg, device=_device(device_type)),
                          mesh, rules, gpt_param_axes(cfg))
    step = make_train_step(cfg, _adamw(params), rules=rules, mesh=mesh)
    tokens = np.random.RandomState(0).randint(0, 256, (2 * spec.dp, 65))
    loss = float(step(params, {"tokens": torch.from_numpy(tokens)})["loss"])
    return f"moe dryrun: ep=2 x dp={spec.dp} E=4 top-2 loss={loss:.4f}"


def _multislice_stage(rank: int, world: int, device_type: str) -> str:
    """Two hosts of n/2 ranks each: a slice-aligned mesh (dp across the
    hosts, tp and fsdp inside each), params born sharded, and each host
    feeding only its own rows of the batch."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.gpt import (GPTConfig, gpt_init,
                                          gpt_param_axes, make_train_step)
    from ray_tpu_torch.parallel import LogicalAxisRules
    from ray_tpu_torch.parallel.mesh import active_mesh
    from ray_tpu_torch.parallel.multislice import (assert_slice_aligned,
                                                   slice_mesh)
    from ray_tpu_torch.parallel.sharding import (init_sharded,
                                                 logical_sharding)

    nhosts, n_local = 2, world // 2
    hosts = [list(range(h * n_local, (h + 1) * n_local))
             for h in range(nhosts)]
    tp = 2 if n_local % 2 == 0 else 1
    mesh, spec = slice_mesh(num_slices=nhosts, tp=tp, hosts=hosts,
                            device_type=device_type)
    assert_slice_aligned(mesh, nhosts, hosts)
    rules = LogicalAxisRules.for_transformer(spec)
    cfg = GPTConfig(vocab_size=256, max_seq_len=128, num_layers=2,
                    num_heads=4, embed_dim=64, dtype=torch.float32)
    dev = _device(device_type)
    params = init_sharded(lambda: gpt_init(0, cfg, device=dev), mesh, rules,
                          gpt_param_axes(cfg))
    step = make_train_step(cfg, _adamw(params), rules=rules, mesh=mesh)

    # This host's rows of the global batch, and this rank's share of them
    # along fsdp: the DTensor is made from each rank's local rows.
    global_b = max(2 * spec.batch_shard_size, 4)
    host = rank // n_local
    rows = torch.from_numpy(np.random.RandomState(host).randint(
        0, 256, (global_b // nhosts, 129))).to(dev)
    fsdp_idx = mesh.get_local_rank("fsdp")
    act = active_mesh(mesh)
    tokens = DTensor.from_local(rows.chunk(spec.fsdp)[fsdp_idx], act,
                                logical_sharding(act, rules,
                                                 ("batch", None)),
                                run_check=False)
    loss = float(step(params, {"tokens": tokens})["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"multislice loss {loss} not finite")
    return (f"multislice dryrun: {nhosts} hosts x {n_local} ranks, "
            f"mesh={spec.axis_sizes} (dp crosses hosts) loss={loss:.4f}")


def _pipeline_stage(rank: int, world: int, device_type: str) -> str:
    """The reference's ``dryrun_pipeline``: one GPipe train step each of
    dense and flash stages over pp=2 x dp, and of MoE stages over pp=2 x
    ep=2 x dp (n % 4 == 0), each loss within 1e-3 of the unpipelined
    loss; then a 1F1B step at M = 16 likewise, with the activation memory
    of both schedules (``schedule_activation_bytes``).  One line each."""
    import torch

    from ray_tpu_torch.models.gpt import (GPTConfig, _leaves, gpt_init,
                                          gpt_loss)
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.parallel.pipeline import (make_1f1b_train_step,
                                                 make_pipeline_train_step,
                                                 schedule_activation_bytes)

    dev = _device(device_type)
    dense = GPTConfig(vocab_size=256, max_seq_len=64, num_layers=4,
                      num_heads=4, embed_dim=64, dtype=torch.float32,
                      attention="dense")
    lines = []

    def one(cfg, spec, tag, mbs=4, make_step=make_pipeline_train_step):
        mesh = spec.build(device_type)
        params = gpt_init(0, cfg, device=dev)
        tokens = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (mbs * spec.batch_shard_size, 65))
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        with torch.no_grad():
            ref = float(gpt_loss(params, batch, cfg))
        step = make_step(cfg, _adamw(params), mesh, num_microbatches=mbs)
        got = float(step(params, batch)["loss"])
        if not abs(got - ref) < 1e-3:
            raise RuntimeError(f"pipeline {tag}: loss {got} against the "
                               f"unpipelined {ref}")
        lines.append(f"pipeline dryrun[{tag}]: mesh={spec.axis_sizes} "
                     f"M={mbs} loss={got:.4f} (matches reference "
                     f"{ref:.4f})")
        return mesh, batch

    one(dense, MeshSpec(dp=world // 2, pp=2), "dense pp x dp")
    one(dataclasses.replace(dense, attention="flash"),
        MeshSpec(dp=world // 2, pp=2), "flash pp x dp")
    if world % 4 == 0:
        one(dataclasses.replace(dense, num_experts=4, expert_top_k=2),
            MeshSpec(dp=world // 4, pp=2, ep=2), "moe pp x ep")
    else:
        lines.append("pipeline dryrun[moe pp x ep] SKIPPED (needs n % 4 "
                     "== 0)")

    # 1F1B: GPipe's numerics with O(pp) activation memory, measured on
    # each schedule's forward at a microbatch count where it matters.
    M = 16
    spec = MeshSpec(dp=world // 2, pp=2)
    mesh, batch = one(dense, spec, "1f1b pp x dp", mbs=M,
                      make_step=make_1f1b_train_step)
    params = gpt_init(0, dense, device=dev)
    for p in _leaves(params):
        p.requires_grad_(True)
    mem = schedule_activation_bytes(params, batch, dense, mesh,
                                    num_microbatches=M)
    lines[-1] += (f"; activation memory {mem['1f1b'] / 1e6:.2f}MB vs gpipe "
                  f"{mem['gpipe'] / 1e6:.2f}MB "
                  f"({mem['gpipe'] / max(mem['1f1b'], 1):.1f}x less)")
    return "\n".join(lines)


def _rl_stage(n: int, device_type: str) -> str:
    """The reference's ``_dryrun_rl``: PPO's minibatch SGD with the
    learner over n devices (shard grads averaged each step), two
    ``train()`` calls on CartPole."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8,
                      rollout_fragment_length=32)
            .training(num_sgd_iter=2, sgd_minibatch_size=64)
            .resources(num_learner_devices=n, device=_device(device_type))
            .debugging(seed=0).build())
    r1 = algo.train()
    r2 = algo.train()
    algo.stop()
    loss = r2.get("learner_total_loss", float("nan"))
    if not np.isfinite(loss):
        raise RuntimeError(f"rl dryrun loss {loss} not finite")
    return (f"rl dryrun: PPO learner dp={n} loss={loss:.4f} "
            f"reward={r2.get('episode_reward_mean', 0):.1f} "
            f"(step1 reward={r1.get('episode_reward_mean', 0):.1f})")


STAGES: Dict[str, Callable[[int, int, str], str]] = {
    "main": _main_stage, "moe": _moe_stage, "multislice": _multislice_stage,
    "pipeline": _pipeline_stage}
# Stages that run in this process over n devices: (n, device_type) -> line.
IN_PROCESS: Dict[str, Callable[[int, str], str]] = {"rl": _rl_stage}


def _skip_reason(name: str, n: int) -> Optional[str]:
    if name == "moe" and n % 2:
        return f"n={n} odd; ep needs an even split"
    if name == "multislice" and (n < 4 or n % 2):
        return f"needs even n>=4, got {n}"
    if name == "pipeline" and n % 2:
        return f"n={n} odd; pp needs an even split"
    return None


def dryrun_multichip(n_devices: int, device_type: Optional[str] = None,
                     stages: Optional[List[str]] = None) -> Dict[str, str]:
    """Run the stages (all by default): the gang stages as gangs of
    ``n_devices`` ranks, one after another under one deadline, then the
    in-process ``rl`` stage; print and return each stage's loss line.
    Raises on the first stage that fails or runs out of time."""
    from ray_tpu_torch.parallel.gang import run_gang
    from ray_tpu_torch.parallel.mesh import mesh_device_type

    device_type = mesh_device_type(device_type)
    backend = "nccl" if device_type == "cuda" else "gloo"
    deadline = time.monotonic() + DEADLINE_S
    lines = {}
    for name in stages or list(STAGES) + list(IN_PROCESS):
        reason = _skip_reason(name, n_devices)
        if reason:
            lines[name] = f"{name} dryrun SKIPPED ({reason})"
        elif name in IN_PROCESS:
            lines[name] = IN_PROCESS[name](n_devices, device_type)
        else:
            out = run_gang(STAGES[name], n_devices, (device_type,),
                           timeout_s=max(1.0, deadline - time.monotonic()),
                           backend=backend)
            lines[name] = out[0]
        for line in lines[name].splitlines():
            print(f"[{name}] {line}", flush=True)
    for name, why in WAITING.items():
        print(f"[{name}] not run: {why}", flush=True)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default: NCCL, one card per rank) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()

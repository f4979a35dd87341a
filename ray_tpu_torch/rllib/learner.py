"""Multi-device RL learner plumbing: data-parallel policy updates in one
process.

Port of ``ray_tpu/rllib/learner.py``.  Design analog: reference
``rllib/execution/multi_gpu_learner_thread.py:20`` and
``rllib/core/rl_trainer/trainer_runner.py:21`` -- N learner GPUs, each
loading a batch shard, gradients allreduced, one weight copy broadcast
back to rollout workers.

The JAX package's learner is one ``shard_map`` program over a ``("dp",)``
mesh.  Here it is one process too: the train batch splits into n equal
row shards, shard i on ``cuda:i`` (or, with ``device="cpu"``, n virtual
shards on the CPU, as the reference's tests use 8 virtual CPU devices);
each minibatch step computes every shard's grads on its device from its
replica of the params, averages them on the first device (the reference's
``lax.pmean``) and takes one optimizer step there, and the new params are
copied to the other devices.  No process gang and no DDP: the learner
stays where the policy is.  Rollout workers remain host-CPU actors; weight
broadcast reuses ``WorkerSet.sync_weights``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch


def learner_devices(num_devices: int, device: torch.device
                    ) -> List[torch.device]:
    """The n devices of a dp learner whose policy lives on ``device``: the
    first n cards, or n virtual shards on the CPU."""
    n = int(num_devices or 1)
    if device.type == "cpu":
        return [device] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(
            f"num_learner_devices={n} but only {visible} devices visible")
    if n == 1:
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


def perm_gens(seed: int, n: int) -> List[torch.Generator]:
    """One CPU permutation generator a shard, seeded from (seed, shard)."""
    return [torch.Generator().manual_seed((seed << 8) + i) for i in range(n)]


def trim_batch(batch: Dict[str, np.ndarray], multiple: int
               ) -> Dict[str, np.ndarray]:
    """Trim every leading dim to a multiple of the shard count so shards
    are equal (dropping <multiple trailing rows, same as the reference's
    per-GPU loader truncation)."""
    if multiple <= 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    keep = (n // multiple) * multiple
    if keep == n:
        return batch
    if keep == 0:
        raise ValueError(f"batch of {n} rows cannot shard over "
                         f"{multiple} learner devices")
    return {k: v[:keep] for k, v in batch.items()}


def shard_rows(batch: Dict[str, np.ndarray], n: int
               ) -> List[Dict[str, np.ndarray]]:
    """n contiguous equal row blocks (``PartitionSpec("dp")``)."""
    rows = next(iter(batch.values())).shape[0] // n
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            for i in range(n)]


def dp_value_and_grad(loss_fn: Callable, params, shard_batches: Sequence,
                      devices: Sequence[torch.device]
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 List[torch.Tensor]]:
    """``loss_fn(params, batch) -> (loss, stats)`` on every shard, from
    the params' replica on the shard's device; the shards' stats and grads
    averaged on the first device (the ``pmean``)."""
    from ray_tpu_torch.rllib.policy import tree_map, value_and_grad
    primary = devices[0]
    stats_all, grads_all = [], []
    for batch, dev in zip(shard_batches, devices):
        replica = params if dev == primary else tree_map(
            lambda t, d=dev: t.to(d), params)
        stats, grads = value_and_grad(lambda p, b=batch: loss_fn(p, b),
                                      replica)
        stats_all.append(stats)
        grads_all.append(grads)
    if len(devices) == 1:
        return stats_all[0], grads_all[0]
    n = len(devices)
    grads = [sum(g[i].to(primary) for g in grads_all) / n
             for i in range(len(grads_all[0]))]
    stats = {k: sum(s[k].to(primary) for s in stats_all) / n
             for k in stats_all[0]}
    return stats, grads

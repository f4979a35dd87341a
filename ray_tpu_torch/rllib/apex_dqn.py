"""Ape-X DQN: distributed prioritized experience replay.

Port of ``ray_tpu/rllib/apex_dqn.py``.  Design analog: reference
``rllib/algorithms/apex_dqn/apex_dqn.py`` (Horgan et al. 2018): many rollout workers with per-worker exploration
epsilons feed sharded prioritized-replay ACTORS; the learner samples from
the shards asynchronously, pushes updated priorities back, and
broadcasts fresh weights on an interval.  The learner is DQN's
double-Q/huber update on ``config["device"]``, in the driver's process;
the rollout workers and the replay shards are card-less actors
(``num_cpus`` only, so the raylet gives them ``CUDA_VISIBLE_DEVICES=""``)
around the columnar numpy ``PrioritizedReplayBuffer``.  Sampling, priority
updates (numpy TD errors, never a card's tensor) and weight broadcast all
ride the normal actor transport.

Per-worker epsilons follow the paper: eps_i = base^(1 + i/(N-1) * alpha)
with base=0.4, alpha=7 — worker 0 explores at 0.4, the last at ~0.0016,
so the replay pool always mixes broad exploration with near-greedy
trajectories.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ApexDQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(ApexDQN)
        self._config.update({
            "policy": "dqn",
            "hiddens": (64, 64),
            "lr": 5e-4,
            "train_batch_size": 64,
            "buffer_size": 50_000,          # per shard
            "num_replay_shards": 2,
            "learning_starts": 1000,        # total across shards
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
            "target_network_update_freq": 50,    # learner updates
            "num_train_iters": 8,           # updates per training_step
            "broadcast_interval": 4,        # updates between weight pushes
            "double_q": True,
            "apex_epsilon_base": 0.4,
            "apex_epsilon_alpha": 7.0,
            "rollout_fragment_length": 16,
            "num_envs_per_worker": 4,
            "num_rollout_workers": 2,
            "gamma": 0.99,
        })


class ReplayShard:
    """Actor wrapping one prioritized replay shard (reference: the
    replay actors of apex_dqn's execution plan)."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self._buf = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                            seed=seed)

    def add(self, batch: SampleBatch) -> int:
        self._buf.add(batch)
        return len(self._buf)

    def sample(self, n: int, beta: float):
        if len(self._buf) < n:
            return None
        return self._buf.sample(n, beta=beta)

    def update_priorities(self, idx, td) -> None:
        self._buf.update_priorities(np.asarray(idx), np.asarray(td))

    def size(self) -> int:
        return len(self._buf)

    def visible_cards(self) -> str:
        """The shard's ``CUDA_VISIBLE_DEVICES`` ("" on a card-less
        actor)."""
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def _pin_epsilon(e: float):
    """Constant-epsilon pin shipped to a rollout worker (the Ape-X
    ladder replaces the annealed schedule)."""
    def fn(worker):
        worker.policy.config["epsilon_initial"] = e
        worker.policy.config["epsilon_final"] = e
        return e
    return fn


class ApexDQN(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "dqn")
        n_workers = config.get("num_rollout_workers", 2)
        if n_workers < 1:
            raise ValueError("ApexDQN needs num_rollout_workers >= 1")
        super().setup(config)
        c = self.config
        # Pin each worker's epsilon to the Ape-X ladder (constant per
        # worker, not annealed — the ladder IS the exploration schedule).
        base = c.get("apex_epsilon_base", 0.4)
        alpha = c.get("apex_epsilon_alpha", 7.0)
        n = len(self.workers.remote_workers)
        eps = [base ** (1 + (i / max(1, n - 1)) * alpha)
               for i in range(n)]

        self._worker_eps = eps
        ray_tpu_torch.get([w.apply.remote(_pin_epsilon(e))
                           for w, e in zip(self.workers.remote_workers, eps)],
                          timeout=120)

        shard_cls = ray_tpu_torch.remote(num_cpus=0.25)(ReplayShard)
        self.replay_shards: List[Any] = [
            shard_cls.remote(c.get("buffer_size", 50_000),
                             c.get("prioritized_replay_alpha", 0.6),
                             c.get("seed", 0) + i)
            for i in range(c.get("num_replay_shards", 2))]
        self._shard_rr = 0
        self._inflight: Dict[str, Any] = {}
        self._updates = 0
        self._since_target = 0
        # ms of each shard.sample round trip (the learner waits on it
        # before every update).
        self.sample_ms: List[float] = []
        self.workers.ready()
        self._reconcile_workers()

    def _reconcile_workers(self) -> None:
        """Every live worker must have exactly one in-flight sample and
        its ladder epsilon.  Also covers workers REPLACED by
        restore_unhealthy_workers: the fresh actor gets its slot's
        epsilon re-pinned (a restored policy would otherwise revert to
        the annealed default) and a first sample issued."""
        inflight_ids = {id(w) for _, w in self._inflight.values()}
        for i, w in enumerate(self.workers.remote_workers):
            if id(w) not in inflight_ids:
                e = self._worker_eps[i % len(self._worker_eps)]
                w.apply.remote(_pin_epsilon(e))   # ordered before sample
                ref = w.sample.remote()
                self._inflight[ref.hex()] = (ref, w)

    def _harvest(self) -> int:
        """Move completed sample batches into replay shards and re-issue
        the workers immediately (the async heart of Ape-X)."""
        refs = [r for r, _ in self._inflight.values()]
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
        moved = 0
        live = {id(w) for w in self.workers.remote_workers}
        for ref in done:
            _, worker = self._inflight.pop(ref.hex())
            try:
                batch = ray_tpu_torch.get(ref)
            except Exception:
                # worker died mid-sample; Algorithm.step's restore path
                # replaces it and _reconcile_workers re-enlists it
                continue
            self._timesteps_total += batch.count
            moved += batch.count
            shard = self.replay_shards[self._shard_rr
                                       % len(self.replay_shards)]
            self._shard_rr += 1
            shard.add.remote(batch)      # fire-and-forget
            if id(worker) in live:
                nref = worker.sample.remote()
                self._inflight[nref.hex()] = (nref, worker)
        self._reconcile_workers()
        return moved

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        policy = self.workers.local_worker.policy
        stats: Dict[str, Any] = {}
        target_adds = c.get("learning_starts", 1000)
        # Fill phase: block until the shards hold enough experience.
        import time as _time
        deadline = _time.monotonic() + 300
        while _time.monotonic() < deadline:
            self._harvest()
            if sum(self._shard_sizes()) >= target_adds:
                break
            _time.sleep(0.05)

        n_updates = 0
        update_deadline = _time.monotonic() + 300
        while n_updates < c.get("num_train_iters", 8):
            if _time.monotonic() > update_deadline:
                raise TimeoutError(
                    "ApexDQN made no learner progress in 300s "
                    f"(shard sizes: {self._shard_sizes()})")
            self._harvest()
            shard = self.replay_shards[self._updates
                                       % len(self.replay_shards)]
            t0 = _time.perf_counter()
            train = ray_tpu_torch.get(shard.sample.remote(
                c.get("train_batch_size", 64),
                c.get("prioritized_replay_beta", 0.4)), timeout=60)
            self.sample_ms.append((_time.perf_counter() - t0) * 1e3)
            if train is None:
                _time.sleep(0.05)
                continue
            stats = policy.learn_on_batch(train)
            shard.update_priorities.remote(          # fire-and-forget
                train["batch_indexes"], stats.pop("td_errors"))
            n_updates += 1
            self._updates += 1
            self._since_target += 1
            if self._since_target >= c.get(
                    "target_network_update_freq", 50):
                policy.update_target()
                self._since_target = 0
            if self._updates % c.get("broadcast_interval", 4) == 0:
                self.workers.sync_weights()
        return {"info": {"learner": stats},
                "num_updates": self._updates,
                "worker_epsilons": self._worker_eps,
                **{f"learner_{k}": v for k, v in stats.items()
                   if np.isscalar(v)}}

    def _shard_sizes(self) -> List[int]:
        return ray_tpu_torch.get([s.size.remote()
                                  for s in self.replay_shards], timeout=60)

    def cleanup(self) -> None:
        for s in self.replay_shards:
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass
        super().cleanup()

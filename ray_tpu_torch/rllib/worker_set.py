"""WorkerSet: local learner-side worker + remote rollout actors.

Port of ``ray_tpu/rllib/worker_set.py``.  The local worker's policy is the
learner and runs on ``config["device"]``; the remote rollout workers are
card-less actors (``num_cpus`` only, so the raylet gives them
``CUDA_VISIBLE_DEVICES=""``) built with ``device="cpu"``, as the JAX
package's are host-CPU actors.  Design analog: reference ``rllib/evaluation/worker_set.py:77`` (local +
remote workers, ``sync_weights`` broadcast, ``probe_unhealthy_workers`` /
restore via ``rllib/utils/actor_manager.py``).  Weights travel through the
object store once per broadcast (one put, N gets).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch

logger = logging.getLogger(__name__)


class WorkerSet:
    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self._remote_cls = ray_tpu_torch.remote(
            num_cpus=config.get("num_cpus_per_worker", 1),
            max_restarts=0)(RolloutWorker)
        # Local worker exists even with 0 remotes (it holds the reference
        # policy the learner updates).
        self.local_worker = RolloutWorker(config, worker_index=0)
        if getattr(self.local_worker.policy, "recurrent", False) and \
                config.get("num_rollout_workers", 0) > 0:
            # Recurrent fragments are [T, n] with per-fragment state;
            # concat_samples would join them along TIME while state_in
            # joins along envs — silently corrupting sequences.  Fail at
            # config time instead of deep inside the update.
            raise ValueError(
                "recurrent policies sample with the local worker only; "
                "set num_rollout_workers=0 (cross-worker fragment concat "
                "is not wired)")
        self.remote_workers: List[Any] = []
        for i in range(config.get("num_rollout_workers", 0)):
            self.remote_workers.append(self._make_remote(i + 1))
        self._worker_indices = list(
            range(1, len(self.remote_workers) + 1))
        # Experience output (reference: config.offline_data(output=...)
        # attaching an OutputWriter to sampling): every sampled batch is
        # also persisted as a dataset shard for offline training.
        self._output_writer = None
        if config.get("output"):
            from ray_tpu_torch.rllib.offline import DatasetWriter
            self._output_writer = DatasetWriter(config["output"])
        # Client-server RL (reference: PolicyServerInput as config.input):
        # external simulator processes drive episodes over TCP; sample()
        # returns their experiences instead of rollout-worker batches.
        self.server_input = None
        if config.get("input") == "policy_server":
            from ray_tpu_torch.rllib.policy_server import PolicyServerInput
            self.server_input = PolicyServerInput(
                self.local_worker.policy, config)

    def _make_remote(self, index: int):
        return self._remote_cls.remote(dict(self.config, device="cpu"),
                                       index)

    def ready(self, timeout: float = 120.0) -> None:
        """Block until every remote worker answers a ping (actor creation +
        the torch import can take seconds; probing before that would
        misread 'starting' as 'unhealthy')."""
        if self.remote_workers:
            ray_tpu_torch.get([w.ping.remote() for w in self.remote_workers],
                        timeout=timeout)

    # -- sampling ---------------------------------------------------------
    def synchronous_sample(self) -> SampleBatch:
        """One round of parallel sampling across all workers (reference
        rollout_ops.synchronous_parallel_sample)."""
        if self.server_input is not None:
            batch = self.server_input.sample()
            if self._output_writer is not None:
                self._output_writer.write(batch)
            return batch
        if not self.remote_workers:
            batch = self.local_worker.sample()
        else:
            refs = [w.sample.remote() for w in self.remote_workers]
            batches = ray_tpu_torch.get(refs, timeout=300.0)
            batch = SampleBatch.concat_samples(batches)
        if self._output_writer is not None:
            self._output_writer.write(batch)
        return batch

    def collect_metrics(self) -> Dict[str, Any]:
        rewards: List[float] = []
        lens: List[int] = []
        if self.server_input is not None:
            # matches synchronous_sample's precedence: with a policy
            # server, rollout workers never sample, so their metrics
            # would be permanently empty
            m = self.server_input.get_metrics()
            rewards.extend(m["episode_rewards"])
            lens.extend(m["episode_lens"])
        elif self.remote_workers:
            for m in ray_tpu_torch.get(
                    [w.get_metrics.remote() for w in self.remote_workers],
                    timeout=60.0):
                rewards.extend(m["episode_rewards"])
                lens.extend(m["episode_lens"])
        else:
            m = self.local_worker.get_metrics()
            rewards.extend(m["episode_rewards"])
            lens.extend(m["episode_lens"])
        return {"episode_rewards": rewards, "episode_lens": lens}

    # -- weight sync ------------------------------------------------------
    def sync_weights(self) -> None:
        """Broadcast the local worker's weights to all remote workers."""
        if not self.remote_workers:
            return
        ref = ray_tpu_torch.put(self.local_worker.get_weights())
        ray_tpu_torch.get([w.set_weights.remote(ref)
                     for w in self.remote_workers], timeout=60.0)

    # -- fault tolerance --------------------------------------------------
    def probe_unhealthy_workers(self, timeout: float = 5.0) -> List[int]:
        """Indices (into remote_workers) of workers that fail a ping."""
        if not self.remote_workers:
            return []
        refs = {w.ping.remote(): i
                for i, w in enumerate(self.remote_workers)}
        ready, not_ready = ray_tpu_torch.wait(
            list(refs), num_returns=len(refs), timeout=timeout)
        bad = {refs[r] for r in not_ready}
        for r in ready:
            try:
                ray_tpu_torch.get(r)
            except Exception:
                bad.add(refs[r])
        return sorted(bad)

    def restore_unhealthy_workers(self, indices: List[int]) -> int:
        """Replace dead workers with fresh actors carrying current weights."""
        if not indices:
            return 0
        weights_ref = ray_tpu_torch.put(self.local_worker.get_weights())
        for i in indices:
            old = self.remote_workers[i]
            try:
                ray_tpu_torch.kill(old)
            except Exception:
                pass
            w = self._make_remote(i + 1)
            w.set_weights.remote(weights_ref)
            self.remote_workers[i] = w
            logger.warning("restored rollout worker %d", i + 1)
        return len(indices)

    def foreach_worker(self, fn: Callable) -> List[Any]:
        """fn(worker) on local + all remotes (reference
        worker_set.foreach_worker)."""
        out = [fn(self.local_worker)]
        if self.remote_workers:
            out.extend(ray_tpu_torch.get(
                [w.apply.remote(fn) for w in self.remote_workers],
                timeout=120.0))
        return out

    def stop(self) -> None:
        if self.server_input is not None:
            self.server_input.stop()
        for w in self.remote_workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.remote_workers = []

    def __len__(self) -> int:
        return len(self.remote_workers)

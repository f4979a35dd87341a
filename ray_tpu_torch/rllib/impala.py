"""IMPALA: asynchronous actors + V-trace off-policy correction.

Port of ``ray_tpu/rllib/impala.py``.  Design analog: reference
``rllib/algorithms/impala/impala.py:533`` (training_step drains completed
sample futures and immediately re-issues them — actors never block on the
learner) with the learner-side prefetch pipeline of
``execution/multi_gpu_learner_thread.py:20`` /
``_MultiGPULoaderThread:187``: a host loader thread moves the next batch
to the device while the current update runs.

On a card the loader copies each batch from pinned host memory with
``non_blocking=True`` on a side stream (``data/device_ingest.py``'s
``PinnedCopier``): the learner's stream waits on the copy's event before
it reads the batch, and a pinned buffer is written again only once its
previous copy has completed.  V-trace is a reversed time loop; the actors
are card-less host-CPU processes whose stale-policy drift is exactly
what V-trace's rho/c clipping corrects.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import (Categorical, OptaxAdam, TorchPolicy,
                                        ac_forward, ac_init, stats_to_floats,
                                        to_tensors, tree_leaves,
                                        tree_to_numpy, tree_unflatten)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ACTION_LOGP, DONES,
                                              OBS, REWARDS, SampleBatch)


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(Impala)
        self._config.update({
            "policy": "impala",
            "hiddens": (64, 64),
            "lr": 6e-4,
            "gamma": 0.99,
            "vtrace_rho_clip": 1.0,
            "vtrace_c_clip": 1.0,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "grad_clip": 40.0,
            "broadcast_interval": 1,      # weight sync every N updates
            "num_batches_per_step": 4,    # learner updates per training_step
            "rollout_fragment_length": 64,
            "num_envs_per_worker": 8,
            "num_rollout_workers": 2,
        })


def vtrace(behavior_logp, target_logp, rewards, dones, values, bootstrap,
           gamma, rho_clip=1.0, c_clip=1.0):
    """V-trace targets (Espeholt et al. 2018), batch-major [B, T] inputs.
    Returns (vs targets [B, T], pg advantages [B, T]), both detached."""
    with torch.no_grad():
        ratio = torch.exp(target_logp - behavior_logp)
        rho = torch.clamp(ratio, max=rho_clip)
        c = torch.clamp(ratio, max=c_clip)
        not_done = 1.0 - dones.to(torch.float32)
        # values_{t+1} with bootstrap at the end, zeroed across
        # terminations.
        values_next = torch.cat([values[:, 1:], bootstrap[:, None]],
                                dim=1) * not_done
        deltas = rho * (rewards + gamma * values_next - values)
        acc = torch.zeros_like(deltas[:, 0])
        out = [None] * deltas.shape[1]
        for t in reversed(range(deltas.shape[1])):
            acc = deltas[:, t] + gamma * not_done[:, t] * c[:, t] * acc
            out[t] = acc
        vs = values + torch.stack(out, dim=1)
        vs_next = torch.cat([vs[:, 1:], bootstrap[:, None]],
                            dim=1) * not_done
        pg_adv = rho * (rewards + gamma * vs_next - values)
    return vs, pg_adv


_COLUMNS = (OBS, ACTIONS, ACTION_LOGP, REWARDS, DONES, "bootstrap_obs")


def _host_columns(batch) -> Dict[str, np.ndarray]:
    """The columns the learner reads, in the dtypes it reads them."""
    return {
        OBS: np.asarray(batch[OBS], np.float32),
        ACTIONS: np.asarray(batch[ACTIONS]),
        ACTION_LOGP: np.asarray(batch[ACTION_LOGP], np.float32),
        REWARDS: np.asarray(batch[REWARDS], np.float32),
        DONES: np.asarray(batch[DONES]),
        "bootstrap_obs": np.asarray(batch["bootstrap_obs"], np.float32),
    }


def _to_device(batch: SampleBatch, device) -> Dict[str, torch.Tensor]:
    return to_tensors(_host_columns(batch), torch.device(device))


class ImpalaPolicy(TorchPolicy):
    """Actor-critic policy with a V-trace update.  With
    ``num_learner_devices=n`` the batch's B rows split into n shards whose
    grads are averaged before the one optimizer step (``learner.py``)."""

    sequence_style = True

    def __init__(self, obs_dim: int, action_space, config: Dict[str, Any],
                 seed: int = 0):
        from ray_tpu_torch.rllib.learner import learner_devices
        if action_space.kind != "discrete":
            raise ValueError("this IMPALA implementation is discrete-only")
        self._setup(action_space, config, seed)
        self.params = ac_init(self._init_gen, obs_dim, action_space.n,
                              tuple(config.get("hiddens", (64, 64))),
                              device=self.device)
        self._opt = OptaxAdam(tree_leaves(self.params),
                              config.get("lr", 6e-4),
                              clip=config.get("grad_clip", 40.0))
        self._gamma = config.get("gamma", 0.99)
        self._rho_clip = config.get("vtrace_rho_clip", 1.0)
        self._c_clip = config.get("vtrace_c_clip", 1.0)
        self._vf_coeff = config.get("vf_loss_coeff", 0.5)
        self._ent_coeff = config.get("entropy_coeff", 0.01)
        self._n_learn = int(config.get("num_learner_devices", 1) or 1)
        self._devices = learner_devices(self._n_learn, self.device)

    @torch.no_grad()
    def _act(self, params, gen, obs):
        pi, _ = ac_forward(params, obs)
        actions = Categorical.sample(gen, pi)
        return actions, Categorical.logp(pi, actions)

    def compute_actions(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        a, logp = self._act(self.params, self._act_gen, self._obs(obs))
        return {ACTIONS: a.cpu().numpy(), ACTION_LOGP: logp.cpu().numpy()}

    def _forward(self, p, batch):
        """-> (logp [B, T], entropy [B*T], v [B, T], vs, pg_adv)."""
        B, T = batch[REWARDS].shape
        flat_obs = batch[OBS].reshape((B * T,) + batch[OBS].shape[2:])
        pi, v = ac_forward(p, flat_obs)
        logp_bt = Categorical.logp(pi, batch[ACTIONS].reshape((B * T,))
                                   ).reshape(B, T)
        entropy = Categorical.entropy(pi)
        v = v.reshape(B, T)
        _, boot_v = ac_forward(p, batch["bootstrap_obs"])
        vs, pg_adv = vtrace(batch[ACTION_LOGP], logp_bt.detach(),
                            batch[REWARDS], batch[DONES], v.detach(),
                            boot_v.detach(), self._gamma, self._rho_clip,
                            self._c_clip)
        return logp_bt, entropy, v, vs, pg_adv

    def _loss(self, p, batch):
        logp_bt, entropy, v, vs, pg_adv = self._forward(p, batch)
        pg_loss = -torch.mean(logp_bt * pg_adv)
        return self._total(pg_loss, v, vs, entropy)

    def _total(self, pg_loss, v, vs, entropy):
        vf_loss = 0.5 * torch.mean((vs - v) ** 2)
        ent = torch.mean(entropy)
        total = pg_loss + self._vf_coeff * vf_loss - self._ent_coeff * ent
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent, "total_loss": total}

    def _grads(self, batch) -> Tuple[Dict[str, torch.Tensor],
                                     List[torch.Tensor]]:
        """Stats and grads of one update on ``batch`` (numpy columns or
        tensors), averaged over the learner's shards."""
        from ray_tpu_torch.rllib.learner import (dp_value_and_grad,
                                                 shard_rows, trim_batch)
        batch = {k: batch[k] for k in _COLUMNS} \
            if isinstance(batch[OBS], torch.Tensor) else _host_columns(batch)
        if self._n_learn > 1:
            batch = trim_batch(batch, self._n_learn)
        shards = [{k: torch.as_tensor(v).to(d) for k, v in s.items()}
                  for s, d in zip(shard_rows(batch, self._n_learn),
                                  self._devices)]
        return dp_value_and_grad(self._loss, self.params, shards,
                                 self._devices)

    def learn_on_batch(self, batch) -> Dict[str, float]:
        """``batch`` is device-resident when the loader thread put it."""
        stats, grads = self._grads(batch)
        self.params = tree_unflatten(self.params, self._opt.step(
            tree_leaves(self.params), grads))
        return stats_to_floats(stats)

    def loss_and_grads(self, batch) -> Tuple[Dict[str, float], Dict]:
        """The stats and grads (numpy tree) ``learn_on_batch(batch)``
        would step with, from the current params; changes nothing."""
        stats, grads = self._grads(batch)
        return stats_to_floats(stats), tree_to_numpy(
            tree_unflatten(self.params, grads))


class _LoaderThread(threading.Thread):
    """Host->device prefetch: moves the next host batch to the device
    while the learner updates on the current one (reference
    _MultiGPULoaderThread:187).  On a card a queued item is a pending
    copy that ``hand_over`` makes safe for the learner's stream."""

    def __init__(self, in_q: "queue.Queue", out_q: "queue.Queue", device):
        super().__init__(daemon=True, name="impala-loader")
        self.in_q = in_q
        self.out_q = out_q
        self.device = device
        self._stop_event = threading.Event()
        self._copier = None
        if device.type == "cuda":
            from ray_tpu_torch.data.device_ingest import PinnedCopier
            self._copier = PinnedCopier(device)

    def _put(self, item) -> None:
        while not self._stop_event.is_set():
            try:
                self.out_q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def run(self):
        while not self._stop_event.is_set():
            try:
                item = self.in_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                self._put(None)
                return
            arrays = _host_columns(item)
            if self._copier is None:
                self._put(to_tensors(arrays, self.device))
            else:
                self._put(self._copier.submit(arrays))

    def hand_over(self, item) -> Dict[str, torch.Tensor]:
        return item if self._copier is None else \
            self._copier.hand_over(item)

    def stop(self) -> None:
        """End the thread and drop every queued batch (and with them the
        device memory they hold)."""
        self._stop_event.set()
        self.join(timeout=10.0)
        for q in (self.in_q, self.out_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class Impala(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        config = dict(config)
        config.setdefault("policy", "impala")
        super().setup(config)
        self._host_q: "queue.Queue" = queue.Queue(maxsize=4)
        self._device_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._loader = _LoaderThread(self._host_q, self._device_q,
                                     self.workers.local_worker.policy.device)
        self._loader.start()
        self._inflight: Dict[str, Any] = {}   # ref hex -> (ref, worker)
        self._in_pipeline = 0                 # batches put but not consumed
        self._updates = 0
        self.loader_wait_ms: List[float] = []  # learner's wait per batch
        self.workers.ready()
        self._kick_all()

    def _kick_all(self):
        for w in self.workers.remote_workers:
            ref = w.sample.remote()
            self._inflight[ref.hex()] = (ref, w)

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch
        c = self.config
        stats: Dict[str, float] = {}
        n_batches = 0
        policy = self.workers.local_worker.policy
        target = c.get("num_batches_per_step", 4)
        while n_batches < target:
            if self._inflight:
                # Harvest completed fragments ahead of need (bounded): the
                # loader thread then moves batch k+1 to the device while
                # the learner updates on batch k — a single-batch drain
                # would serialize loader and learner.  The pipeline depth
                # cap matters: host_q/device_q are bounded, and a blocking
                # host_q.put from this (learner) thread with the loader
                # blocked on device_q.put is a deadlock.
                PIPELINE_DEPTH = 2
                refs = [r for r, _ in self._inflight.values()]
                if self._in_pipeline == 0:
                    done, _ = ray_tpu_torch.wait(refs, num_returns=1,
                                                 timeout=120)
                    if not done:
                        # Nothing completed within the poll window
                        # (starved host): re-poll rather than blocking on
                        # an empty device queue forever.
                        continue
                elif self._in_pipeline <= PIPELINE_DEPTH:
                    done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                                 timeout=0)
                else:
                    done = []
                done = done[:max(0, PIPELINE_DEPTH + 1 -
                                 self._in_pipeline)]
                for ref in done:
                    _, worker = self._inflight.pop(ref.hex())
                    batch = ray_tpu_torch.get(ref)
                    b, t = batch[REWARDS].shape
                    self._timesteps_total += b * t
                    self._host_q.put(batch)
                    self._in_pipeline += 1
                    # Re-issue IMMEDIATELY: the actor never idles waiting
                    # for the learner (the async heart of IMPALA).
                    nref = worker.sample.remote()
                    self._inflight[nref.hex()] = (nref, worker)
            else:  # no remote workers: sample locally
                self._host_q.put(self.workers.local_worker.sample())
                self._in_pipeline += 1
            t0 = time.perf_counter()
            device_batch = self._loader.hand_over(self._device_q.get())
            self.loader_wait_ms.append((time.perf_counter() - t0) * 1e3)
            self._in_pipeline -= 1
            stats = policy.learn_on_batch(device_batch)
            n_batches += 1
            self._updates += 1
            if self._updates % c.get("broadcast_interval", 1) == 0:
                self.workers.sync_weights()
        return {"info": {"learner": stats}, "num_updates": self._updates,
                **{f"learner_{k}": v for k, v in stats.items()}}

    def cleanup(self) -> None:
        self._loader.stop()
        super().cleanup()

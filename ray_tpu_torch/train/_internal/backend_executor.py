"""BackendExecutor: drives a training run over a WorkerGroup.

Port of ``ray_tpu/train/_internal/backend_executor.py`` (reference
``python/ray/train/_internal/backend_executor.py:43``: placement-group
creation (:138), rank assignment (:245), start_training (:315),
worker-failure handling (:510,571)).  A lost worker means the whole gang
restarts from the last checkpoint.  With ``use_gpu`` the gang's bundles
ask for ``GPU``: a worker that replaces a killed one is placed on the card
its predecessor frees, once the raylet has reaped the dead process (a
card is never leased while a dead holder's process still has it).

Gang supervision: besides surfacing RPC errors from ``get_next``, the
executor subscribes to the GCS ``"actors"`` pubsub channel and trips a
death event the moment ANY gang actor is recorded dead — ranks wedged
inside a collective waiting on the dead peer can't report an error, so
the watch (not the RPC path) is what bounds detection latency.  Recovery
tears the whole gang down, verifies the latest checkpoint's manifest +
CRCs before trusting it (falling back to the previous intact sibling),
and restarts with exponential backoff under a bounded budget
(``FailureConfig.max_failures`` or ``RT_TRAIN_MAX_RECOVERIES``).  A
planned preemption handoff (worker exits clean after a final checkpoint)
restarts the gang WITHOUT burning budget.

``shutdown()`` may come from another thread while the training loop
runs (Tune stopping a trainer's trial): it closes the executor, so a
recovery in flight places no new gang, and the teardown runs once.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train import metrics as train_metrics
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train._internal import checkpoint_store
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.util.placement_group import (
    placement_group, remove_placement_group)

logger = logging.getLogger(__name__)


class TrainBackendError(RuntimeError):
    pass


class TrainingWorkerError(RuntimeError):
    """A worker died or the train fn raised; carries the remote traceback.
    ``preempted`` marks a planned handoff (worker exited clean after a
    preemption notice) — recovery restarts without burning budget."""

    def __init__(self, msg: str, traceback_str: str = "",
                 preempted: bool = False):
        super().__init__(msg + ("\n" + traceback_str if traceback_str else ""))
        self.traceback_str = traceback_str
        self.preempted = preempted


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig,
                 max_failures: int = 0):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()()
        self._scaling = scaling_config
        self._max_failures = max_failures
        self._num_failures = 0
        self._pg = None
        self._group: Optional[WorkerGroup] = None
        self._pending: List[Any] = []
        self._finished: List[bool] = []
        self._latest_checkpoint: Optional[Checkpoint] = None
        # Gang death watch (GCS actors-channel pubsub): set the moment any
        # gang actor is recorded dead, with the dead actors' records.
        self._death_event = threading.Event()
        self._dead_actors: List[dict] = []
        self._watch_cb: Optional[Callable] = None
        self._closed = False
        self._teardown_lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------
    def _check_open(self):
        """Raise, tearing down what start() placed so far, once
        shutdown() has closed the executor."""
        if self._closed:
            self._teardown_group()
            raise TrainBackendError("the executor is shut down")

    def start(self):
        self._check_open()
        sc = self._scaling
        # Head bundle (trainer_resources) first, then one bundle per worker
        # (reference backend_executor.py:138).
        bundles = sc.as_placement_group_bundles()
        worker_offset = len(bundles) - sc.num_workers
        pg = self._pg = placement_group(bundles,
                                        strategy=sc.placement_strategy)
        if not pg.ready(timeout=60.0):
            self._teardown_group()
            raise TrainBackendError(
                f"placement group for {sc.num_workers} x {sc.bundle()} "
                "could not be scheduled (insufficient cluster resources)")
        self._check_open()
        self._group = WorkerGroup(sc.num_workers, sc.bundle(),
                                  placement_group=pg,
                                  bundle_offset=worker_offset)
        self._check_open()
        for w in self._group.workers:
            w.actor.set_context.remote(
                world_rank=w.rank,
                world_size=sc.num_workers,
                local_rank=w.local_rank,
                local_world_size=self._group.local_world_size(w.ip),
                node_rank=w.node_rank,
            )
        self._start_death_watch()
        self._backend.on_start(self._group, self._backend_config)

    def _start_death_watch(self):
        """Subscribe to GCS actor-lifecycle events for THIS gang.  The
        callback runs on the core's pubsub thread: record + set the event,
        nothing else.  Events published while a control-plane partition is
        open are not replayed, so the RPC error path below remains the
        backstop — the watch only bounds detection latency."""
        self._death_event.clear()
        self._dead_actors = []
        gang_ids = {w.actor_id for w in self._group.workers if w.actor_id}
        dead, ev = self._dead_actors, self._death_event

        def _on_actor_event(data, _ids=gang_ids):
            try:
                if data.get("event") != "dead":
                    return
                actor = data.get("actor") or {}
                if actor.get("actor_id") in _ids:
                    dead.append(actor)
                    ev.set()
            except Exception:
                pass

        try:
            from ray_tpu_torch.util import pubsub
            pubsub.subscribe("actors", _on_actor_event)
            self._watch_cb = _on_actor_event
        except Exception:
            # No pubsub (e.g. core not fully up): RPC errors still surface
            # worker death, just without the early collective-hang escape.
            self._watch_cb = None

    def _stop_death_watch(self):
        if self._watch_cb is not None:
            try:
                from ray_tpu_torch.util import pubsub
                pubsub.unsubscribe("actors", self._watch_cb)
            except Exception:
                pass
            self._watch_cb = None

    def start_training(self, train_fn: Callable,
                       config: Optional[Dict[str, Any]] = None,
                       checkpoint: Optional[Checkpoint] = None):
        if self._group is None:
            raise TrainBackendError("executor not started")
        self._backend.on_training_start(self._group, self._backend_config)
        if checkpoint is not None:
            self._latest_checkpoint = checkpoint
        refs = [w.actor.start_training.remote(
                    train_fn, config, self._latest_checkpoint)
                for w in self._group.workers]
        ray_tpu_torch.get(refs)
        self._finished = [False] * len(self._group)
        self._train_fn = train_fn
        self._config = config

    # -- result pump ------------------------------------------------------
    def get_next_results(self) -> Optional[List[Dict[str, Any]]]:
        """One bundle of per-worker reports for the same iteration, or None
        when every worker's train fn returned (reference
        backend_executor.py:414: all-or-nothing consistency check)."""
        if all(self._finished):
            return None
        out: List[Optional[Dict[str, Any]]] = [None] * len(self._group)
        # Issue one get_next per live worker and collect via wait() so an
        # error raised on any rank surfaces immediately, even while other
        # ranks hang inside a collective waiting for the dead peer
        # (reference backend_executor uses ray.wait the same way).
        ref_to_rank = {}
        for i, w in enumerate(self._group.workers):
            if not self._finished[i]:
                ref_to_rank[w.actor.get_next.remote()] = i
        remaining = list(ref_to_rank)
        preempted_rank: Optional[int] = None
        while remaining:
            ready, remaining = ray_tpu_torch.wait(
                remaining, num_returns=len(remaining), timeout=5.0)
            for ref in ready:
                i = ref_to_rank[ref]
                try:
                    kind, payload, extra = ray_tpu_torch.get(ref)
                except Exception as e:
                    raise TrainingWorkerError(
                        f"worker rank={i} died during training: {e}") from e
                if kind == "error":
                    raise TrainingWorkerError(
                        f"train loop failed on rank={i}: {payload}",
                        extra or "")
                if kind == "preempted":
                    # Keep draining this round's ready refs (a final
                    # checkpoint-bearing report may ride in the same
                    # batch) before signalling the planned handoff.
                    preempted_rank = i
                    self._finished[i] = True
                    continue
                if kind == "done":
                    self._finished[i] = True
                    continue
                metrics, ckpt = payload, extra
                if ckpt is not None and i == 0:
                    # Rank-0 checkpoint wins (reference keeps rank-0's).
                    self._latest_checkpoint = ckpt
                out[i] = metrics
            if preempted_rank is not None:
                raise TrainingWorkerError(
                    f"worker rank={preempted_rank} exited on a preemption "
                    "notice (planned handoff)", preempted=True)
            if self._death_event.is_set() and remaining:
                # The GCS recorded a gang death; ranks still pending may be
                # wedged in a collective and will never answer.  In-flight
                # results from this round are already drained above.
                names = ", ".join(
                    (a.get("name") or a.get("actor_id", "?")[:12])
                    for a in self._dead_actors) or "?"
                raise TrainingWorkerError(
                    f"gang worker death recorded by GCS ({names}); "
                    "tearing down the group")
        if all(self._finished):
            return None
        live = [m for m in out if m is not None]
        if live and len(live) != sum(1 for f in self._finished if not f):
            raise TrainBackendError(
                "workers reported unevenly: every live worker must call "
                "session.report() the same number of times")
        return live if live else None

    # -- recovery ---------------------------------------------------------
    def _failure_budget(self) -> int:
        """Restart budget: FailureConfig.max_failures when set, else the
        RT_TRAIN_MAX_RECOVERIES env (-1 = unbounded, 0 = fail fast)."""
        if self._max_failures != 0:
            return self._max_failures
        try:
            return int(os.environ.get("RT_TRAIN_MAX_RECOVERIES", "0"))
        except ValueError:
            return 0

    def _recovery_backoff_s(self) -> float:
        """Exponential backoff before restart attempt N (base doubles per
        consecutive failure, capped) so a crash-looping gang can't hammer
        the scheduler."""
        try:
            base = float(os.environ.get("RT_TRAIN_RECOVERY_BACKOFF_S", "0.5"))
            cap = float(os.environ.get(
                "RT_TRAIN_RECOVERY_BACKOFF_MAX_S", "30"))
        except ValueError:
            base, cap = 0.5, 30.0
        if base <= 0:
            return 0.0
        return min(cap, base * (2 ** max(0, self._num_failures - 1)))

    def recover(self, train_fn: Callable,
                config: Optional[Dict[str, Any]],
                *, preempted: bool = False) -> bool:
        """Tear down and restart the gang from the latest VERIFIED
        checkpoint.  Returns False when the failure budget is exhausted
        or the executor is shut down.  A planned preemption handoff
        restarts without burning budget."""
        if self._closed:
            return False
        if preempted:
            train_metrics.bump("preemptions")
            logger.info("planned preemption handoff; restarting gang from "
                        "the latest checkpoint")
        else:
            self._num_failures += 1
            budget = self._failure_budget()
            if budget >= 0 and self._num_failures > budget:
                logger.error(
                    "train worker failure %d exceeds restart budget %d; "
                    "giving up", self._num_failures, budget)
                return False
            train_metrics.bump("train_recoveries")
            backoff = self._recovery_backoff_s()
            logger.warning(
                "train worker failure %d/%s; restarting group in %.1fs",
                self._num_failures,
                budget if budget >= 0 else "inf", backoff)
            if backoff > 0:
                time.sleep(backoff)
        self._latest_checkpoint = self._verified_checkpoint(
            self._latest_checkpoint)
        self._teardown_group()
        self.start()
        self.start_training(train_fn, config, self._latest_checkpoint)
        return True

    def _verified_checkpoint(self,
                             ckpt: Optional[Checkpoint]
                             ) -> Optional[Checkpoint]:
        """Gate restarts on checkpoint integrity: a directory-form
        checkpoint in CheckpointStore layout (has MANIFEST.json) must pass
        manifest + CRC verification before the gang reuses it; on failure
        fall back to the newest intact sibling, else restart from scratch.
        Dict-form checkpoints (in-memory, can't be torn by a crash) pass
        through untouched."""
        if ckpt is None or ckpt.path is None:
            return ckpt
        path = ckpt.path
        if not os.path.exists(
                os.path.join(path, checkpoint_store.MANIFEST_NAME)):
            return ckpt   # not store-format; nothing to verify against
        try:
            checkpoint_store.verify_checkpoint_dir(path)
            return ckpt
        except checkpoint_store.CorruptCheckpointError as e:
            train_metrics.bump("ckpt_corrupt_skipped")
            logger.warning(
                "latest checkpoint failed verification (%s); falling back "
                "to the previous intact one", e)
        root = os.path.dirname(os.path.abspath(path))
        try:
            store = checkpoint_store.CheckpointStore(root)
            for step in reversed(store.list_steps()):
                cand = os.path.join(root, f"ckpt-{step:012d}")
                if os.path.abspath(cand) == os.path.abspath(path):
                    continue
                try:
                    checkpoint_store.verify_checkpoint_dir(cand)
                    return Checkpoint.from_directory(cand)
                except checkpoint_store.CorruptCheckpointError:
                    train_metrics.bump("ckpt_corrupt_skipped")
        except OSError:
            pass
        logger.warning(
            "no intact checkpoint found under %s; restarting from scratch",
            root)
        return None

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._latest_checkpoint

    @property
    def num_failures(self) -> int:
        return self._num_failures

    def _teardown_group(self):
        with self._teardown_lock:
            self._stop_death_watch()
            group, self._group = self._group, None
            pg, self._pg = self._pg, None
        if group is not None:
            try:
                self._backend.on_shutdown(group, self._backend_config)
            except Exception:
                pass
            group.shutdown()
        if pg is not None:
            try:
                remove_placement_group(pg)
            except Exception:
                pass

    def shutdown(self):
        self._closed = True
        self._teardown_group()

"""TrialRunner: the Tune experiment event loop.

Port of ``ray_tpu/tune/execution/trial_runner.py``. Design analog: reference
``python/ray/tune/execution/trial_runner.py:327`` (step:969 -- start pending
trials, collect one ready result, feed searcher + scheduler, apply
decisions) and ``ray_trial_executor.py:191`` (trial actors). Experiment
state snapshots every ``checkpoint_period`` steps mirror
_ExperimentCheckpointManager (trial_runner.py:136) for Tuner.restore.
A ``"GPU"`` key in the trainable's resources becomes the trial actor's
``num_gpus`` (the JAX package maps ``"TPU"`` to ``num_tpus``); a trial
without it sees no card.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import cloudpickle
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.tune.experiment.trial import (
    ERROR, PENDING, RUNNING, TERMINATED, Trial)
from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler, TrialScheduler)
from ray_tpu_torch.tune.search.searcher import Searcher

logger = logging.getLogger(__name__)


class _TrialActor:
    """Actor body hosting one Trainable instance."""

    def __init__(self, trainable_blob: bytes, config: Dict[str, Any],
                 trial_id: str, trial_name: str):
        cls = cloudpickle.loads(trainable_blob)
        self._t = cls(config, trial_id=trial_id, trial_name=trial_name)

    def train(self) -> Dict[str, Any]:
        return self._t.train()

    def save(self):
        return self._t.save()

    def restore(self, ckpt):
        self._t.restore(ckpt)

    def reset(self, new_config: Dict[str, Any]) -> bool:
        ok = self._t.reset_config(new_config)
        if ok:
            self._t.config = new_config
        return ok

    def request_stop(self):
        self._t.stop()
        return True


class TrialRunner:
    def __init__(self,
                 trainable_cls,
                 searcher: Searcher,
                 scheduler: Optional[TrialScheduler] = None,
                 metric: Optional[str] = None,
                 mode: str = "max",
                 max_concurrent: Optional[int] = None,
                 stop: Optional[Dict[str, Any]] = None,
                 max_failures: int = 0,
                 experiment_name: str = "exp",
                 storage_path: Optional[str] = None,
                 checkpoint_period: int = 10,
                 reuse_actors: bool = False,
                 sync_uri: Optional[str] = None,
                 sync_period_s: float = 5.0):
        self._trainable_cls = trainable_cls
        self._trainable_blob = cloudpickle.dumps(trainable_cls)
        self._searcher = searcher
        self._scheduler = scheduler or FIFOScheduler()
        self._scheduler.set_search_properties(metric, mode)
        self._metric = metric
        self._mode = mode
        self._max_concurrent = max_concurrent or 8
        self._stop = stop or {}
        self._max_failures = max_failures
        self._experiment_name = experiment_name
        self._storage_path = storage_path
        self._checkpoint_period = checkpoint_period
        self._reuse_actors = reuse_actors
        # Experiment-dir sync to URI storage (reference tune/syncer.py):
        # every experiment-state save is mirrored to sync_uri, debounced to
        # one upload per sync_period_s, with a forced final sync.
        self._sync_uri = sync_uri
        self._sync_period_s = sync_period_s
        self._last_sync = 0.0
        self.trials: List[Trial] = []
        self._exploit_requests: List[Tuple[Trial, Trial, Dict]] = []
        self._searcher_exhausted = False
        self._steps = 0
        self._resources = trainable_cls.default_resource_request({})

    # -- scheduler callback surface --------------------------------------
    def live_trials(self) -> List[Trial]:
        return [t for t in self.trials if t.status == RUNNING]

    def request_exploit(self, victim: Trial, donor: Trial,
                        new_config: Dict[str, Any]):
        self._exploit_requests.append((victim, donor, new_config))

    # -- main loop --------------------------------------------------------
    def step(self):
        self._maybe_add_trials()
        self._start_pending()
        self._process_one_result()
        self._apply_exploits()
        self._steps += 1
        if self._storage_path and \
                self._steps % self._checkpoint_period == 0:
            self.save_experiment_state()
            self._maybe_sync()

    def is_finished(self) -> bool:
        return (self._searcher_exhausted
                and all(t.is_finished() for t in self.trials))

    def run_until_done(self):
        while not self.is_finished():
            self.step()
        if self._storage_path:
            self.save_experiment_state()
            self._maybe_sync(force=True)

    def _maybe_sync(self, force: bool = False):
        if not self._sync_uri or not self._storage_path:
            return
        now = time.time()
        if not force and now - self._last_sync < self._sync_period_s:
            return
        self._last_sync = now
        from ray_tpu_torch.air.storage import get_provider
        try:
            get_provider(self._sync_uri).upload_dir(self._storage_path,
                                                    self._sync_uri)
        except Exception:
            logger.warning("experiment sync to %s failed", self._sync_uri,
                           exc_info=True)

    # -- internals --------------------------------------------------------
    def _maybe_add_trials(self):
        if self._searcher_exhausted:
            return
        while len([t for t in self.trials if not t.is_finished()]) < \
                self._max_concurrent:
            tid = f"{len(self.trials):05d}"
            cfg = self._searcher.suggest(tid)
            if cfg is None:
                # Exhausted vs. backpressured: a searcher with a known
                # budget is done once it's met; any searcher is done when
                # it returns None with no trials still in flight (custom
                # Searchers need not implement total_suggestions).
                total = self._searcher.total_suggestions
                if (total is not None and len(self.trials) >= total) or \
                        all(t.is_finished() for t in self.trials):
                    self._searcher_exhausted = True
                break
            trial = Trial(cfg, trial_id=tid,
                          experiment_name=self._experiment_name)
            self.trials.append(trial)
            self._scheduler.on_trial_add(self, trial)

    def _start_pending(self):
        running = len(self.live_trials())
        for trial in self.trials:
            if running >= self._max_concurrent:
                break
            if trial.status != PENDING:
                continue
            self._start_trial(trial)
            running += 1

    def _start_trial(self, trial: Trial,
                     restore_from: Optional[Checkpoint] = None):
        actor_cls = ray_tpu_torch.remote(_TrialActor)
        opts = {"num_cpus": self._resources.get("CPU", 1.0),
                "max_concurrency": 2}
        if self._resources.get("GPU"):
            opts["num_gpus"] = self._resources["GPU"]
        trial.actor = actor_cls.options(**opts).remote(
            self._trainable_blob, trial.config, trial.trial_id,
            trial.trial_name)
        ckpt = restore_from or trial.checkpoint
        if ckpt is not None:
            ray_tpu_torch.get(trial.actor.restore.remote(ckpt))
        trial.status = RUNNING
        trial.pending_ref = trial.actor.train.remote()

    def _process_one_result(self):
        refs = [t.pending_ref for t in self.trials
                if t.status == RUNNING and t.pending_ref is not None]
        if not refs:
            return
        # Process every ready result this step: draining a single trial's
        # queue would starve the others and break population-relative
        # schedulers (PBT/median) that compare concurrent progress.
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=10.0)
        if not ready:
            return
        ready_set, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                    timeout=0.05)
        batch = ready_set or ready
        # Rotate processing order each step: lockstep trials otherwise hit
        # every ASHA rung in trial order, and the first arrival at an empty
        # rung always survives -- rotation restores the asynchrony the
        # schedulers assume.
        rot = self._steps % len(batch)
        for ref in batch[rot:] + batch[:rot]:
            self._handle_result_ref(ref)

    def _handle_result_ref(self, ref):
        trial = next((t for t in self.trials if t.pending_ref == ref), None)
        if trial is None:
            return
        try:
            result = ray_tpu_torch.get(ref)
        except Exception as e:  # actor died or train raised
            self._on_trial_error(trial, e)
            return
        trial.pending_ref = None
        result.setdefault("trial_id", trial.trial_id)
        result["config"] = trial.config

        if result.get("done"):
            # A bare terminal signal keeps the last reported metrics
            # (reference merges the final result into last_result).
            merged = dict(trial.last_result)
            merged.update(result)
            trial.last_result = merged
            self._complete_trial(trial, merged)
            return
        trial.last_result = result
        trial.metrics_history.append(result)
        self._searcher.on_trial_result(trial.trial_id, result)
        decision = self._scheduler.on_trial_result(self, trial, result)
        if self._should_stop(result):
            decision = TrialScheduler.STOP
        if decision == TrialScheduler.STOP:
            self._checkpoint_trial(trial)
            self._complete_trial(trial, result)
        else:
            trial.pending_ref = trial.actor.train.remote()

    def _should_stop(self, result: Dict[str, Any]) -> bool:
        # Reference semantics (tune/stopper MaximumIterationStopper et al.):
        # stop when result[key] >= threshold, regardless of optimization
        # mode -- thresholds are ceilings on monotone counters/metrics.
        return any(key in result and result[key] >= threshold
                   for key, threshold in self._stop.items())

    def _checkpoint_trial(self, trial: Trial):
        try:
            trial.checkpoint = ray_tpu_torch.get(trial.actor.save.remote())
        except Exception:
            pass

    def _complete_trial(self, trial: Trial, result: Dict[str, Any]):
        self._checkpoint_trial(trial)
        self._searcher.on_trial_complete(trial.trial_id, result)
        self._scheduler.on_trial_complete(self, trial, result)
        self._stop_actor(trial)
        trial.status = TERMINATED

    def _on_trial_error(self, trial: Trial, error: Exception):
        trial.num_failures += 1
        self._stop_actor(trial)
        if trial.num_failures <= self._max_failures:
            logger.warning("trial %s failed (%d/%d), restarting",
                           trial.trial_id, trial.num_failures,
                           self._max_failures)
            trial.status = PENDING
            return
        trial.error = str(error)
        trial.status = ERROR
        self._searcher.on_trial_complete(trial.trial_id, error=True)
        self._scheduler.on_trial_error(self, trial)

    def _stop_actor(self, trial: Trial):
        if trial.actor is not None:
            try:
                ray_tpu_torch.get(trial.actor.request_stop.remote(), timeout=5.0)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        trial.pending_ref = None

    def _apply_exploits(self):
        reqs, self._exploit_requests = self._exploit_requests, []
        for victim, donor, new_config in reqs:
            if victim.status != RUNNING or donor.status != RUNNING:
                continue
            try:
                donor_ckpt = ray_tpu_torch.get(donor.actor.save.remote())
            except Exception:
                continue
            logger.info("PBT exploit: %s <- %s", victim.trial_id,
                        donor.trial_id)
            # Drain the victim's in-flight step, then replace it.
            try:
                if victim.pending_ref is not None:
                    ray_tpu_torch.get(victim.pending_ref)
            except Exception:
                pass
            victim.pending_ref = None
            victim.config = new_config
            if self._reuse_actors and victim.actor is not None:
                # In-place exploit: reset_config + restore on the live
                # actor (reference reuse_actors fast path).
                try:
                    if ray_tpu_torch.get(
                            victim.actor.reset.remote(new_config)):
                        ray_tpu_torch.get(
                            victim.actor.restore.remote(donor_ckpt))
                        victim.pending_ref = victim.actor.train.remote()
                        continue
                except Exception:
                    pass
            self._stop_actor(victim)
            victim.status = PENDING
            self._start_trial(victim, restore_from=donor_ckpt)

    # -- experiment checkpointing -----------------------------------------
    def save_experiment_state(self):
        os.makedirs(self._storage_path, exist_ok=True)
        state = {
            "experiment_name": self._experiment_name,
            "timestamp": time.time(),
            "trials": [t.state_dict() for t in self.trials],
        }
        tmp = os.path.join(self._storage_path, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            f.write(cloudpickle.dumps(state))
        os.replace(tmp, os.path.join(self._storage_path,
                                     "experiment_state.pkl"))
        with open(os.path.join(self._storage_path,
                               "experiment_state.json"), "w") as f:
            json.dump({"experiment_name": self._experiment_name,
                       "trials": [
                           {k: v for k, v in t.state_dict().items()
                            if k != "checkpoint"}
                           for t in self.trials]}, f, indent=2, default=str)

    def restore_experiment_state(self, path: str):
        with open(os.path.join(path, "experiment_state.pkl"), "rb") as f:
            state = cloudpickle.loads(f.read())
        self.trials = [Trial.from_state(s, state["experiment_name"])
                       for s in state["trials"]]
        # Unfinished trials restart (from their last checkpoint if any).
        for t in self.trials:
            if not t.is_finished():
                t.status = PENDING
        self._searcher_exhausted = True  # configs already materialized

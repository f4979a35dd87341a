"""Tuner: the user-facing tuning entry point.

Port of ``ray_tpu/tune/tuner.py``. Design analog: reference
``python/ray/tune/tuner.py`` (Tuner.fit:249 -> tune.run -> TrialRunner loop)
plus ``Tuner.restore`` for experiment resume. Accepts a function, a
Trainable subclass, or a train.BaseTrainer (wrapped via as_trainable,
mirroring base_trainer.py:500).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Type, Union

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air.storage import is_uri
from ray_tpu_torch.tune.execution.trial_runner import TrialRunner
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trainable import Trainable, wrap_function
from ray_tpu_torch.tune.tune_config import TuneConfig


def _to_trainable_cls(trainable) -> Type[Trainable]:
    from ray_tpu_torch.train.base_trainer import BaseTrainer
    if isinstance(trainable, BaseTrainer):
        return trainable.as_trainable()
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable):
        return wrap_function(trainable)
    raise TypeError(f"cannot tune {type(trainable)}")


def _mirror_dir(uri: str, fresh: bool = False) -> str:
    """Local mirror for a synced experiment URI.

    Keyed by (uri, pid) so concurrent same-URI runs on one machine don't
    interleave writes; ``fresh=True`` wipes any leftover state first (a new
    run must not inherit a previous experiment's files)."""
    import atexit
    import hashlib
    import shutil
    import tempfile
    h = hashlib.sha1(uri.encode()).hexdigest()[:12]
    d = os.path.join(tempfile.gettempdir(),
                     f"rtt_tune_mirror_{h}_{os.getpid()}")
    if fresh:
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    # The mirror is a full experiment copy; reap it at interpreter exit so
    # repeated URI-storage runs don't accumulate copies in /tmp (same
    # pattern as Checkpoint.from_uri's download dirs).
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    return d


class Tuner:
    def __init__(self,
                 trainable: Union[Callable, Type[Trainable], Any],
                 *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _restore_path: Optional[str] = None):
        self._trainable_cls = _to_trainable_cls(trainable)
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restore_path = _restore_path

    @classmethod
    def restore(cls, path: str, trainable,
                *, tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its storage directory or
        URI (file://, gs://, ... — the experiment is downloaded first, so
        no surviving node needs a local copy).  Pass the original
        tune_config/run_config so stop criteria and schedulers apply to
        the resumed trials as well."""
        return cls(trainable, tune_config=tune_config,
                   run_config=run_config, _restore_path=path)

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        searcher = tc.search_alg
        if searcher is None:
            searcher = BasicVariantGenerator(
                self._param_space, num_samples=tc.num_samples, seed=tc.seed)
        elif isinstance(searcher, Searcher):
            searcher.set_search_properties(tc.metric, tc.mode or "max",
                                           self._param_space)
            # Open-ended searchers (TPE/GP) honor num_samples like the
            # reference: cap total suggestions.
            if tc.num_samples and searcher.total_suggestions is None:
                from ray_tpu_torch.tune.search.searcher import BudgetedSearcher
                searcher = BudgetedSearcher(searcher, tc.num_samples)

        name = self._run_config.name or "tune_experiment"
        storage = self._run_config.storage_path
        restore_path = self._restore_path
        sync_uri = None
        if storage:
            storage = (storage.rstrip("/") + "/" + name
                       if is_uri(storage) else os.path.join(storage, name))
        elif restore_path:
            # Resumed experiments keep checkpointing where they left off.
            storage = restore_path
        if storage and is_uri(storage):
            # URI storage: run against a local mirror, sync every
            # experiment-state save (reference tune/syncer.py).  A resume
            # from a URI first pulls the experiment down — the local mirror
            # may live on a node that never saw the original run.
            sync_uri = storage
            storage = _mirror_dir(sync_uri, fresh=True)
            if restore_path:
                from ray_tpu_torch.air.storage import get_provider
                get_provider(sync_uri).download_dir(sync_uri, storage)
                restore_path = storage
        elif restore_path and is_uri(restore_path):
            # URI restore combined with local (or absent) storage_path:
            # still download the experiment before reading state from it.
            from ray_tpu_torch.air.storage import get_provider
            local = _mirror_dir(restore_path, fresh=True)
            get_provider(restore_path).download_dir(restore_path, local)
            restore_path = local
            if not storage:
                storage = local

        runner = TrialRunner(
            self._trainable_cls,
            searcher=searcher,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode or "max",
            max_concurrent=tc.max_concurrent_trials,
            stop=self._run_config.stop,
            max_failures=self._run_config.failure_config.max_failures,
            experiment_name=name,
            storage_path=storage,
            reuse_actors=tc.reuse_actors,
            sync_uri=sync_uri,
        )
        if restore_path:
            runner.restore_experiment_state(restore_path)
        runner.run_until_done()
        return ResultGrid(
            [self._trial_to_result(t) for t in runner.trials],
            metric=tc.metric, mode=tc.mode or "max")

    @staticmethod
    def _trial_to_result(trial: Trial) -> Result:
        return Result(
            metrics=trial.last_result or None,
            checkpoint=trial.checkpoint,
            error=RuntimeError(trial.error) if trial.error else None,
            metrics_history=trial.metrics_history,
        )

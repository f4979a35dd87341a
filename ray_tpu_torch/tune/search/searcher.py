"""Searcher contract + ConcurrencyLimiter.

Port of ``ray_tpu/tune/search/searcher.py``. Design analog: reference
``python/ray/tune/search/searcher.py`` (Searcher with
suggest/on_trial_complete) and ``search/concurrency_limiter.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Searcher:
    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: str,
                              config: Dict[str, Any]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config, None when exhausted/backpressured."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False):
        pass

    @property
    def total_suggestions(self) -> Optional[int]:
        """How many configs this searcher will emit, if known."""
        return None


class ConcurrencyLimiter(Searcher):
    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live = set()

    def set_search_properties(self, metric, mode, config):
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    @property
    def total_suggestions(self):
        return self.searcher.total_suggestions


class BudgetedSearcher(Searcher):
    """Caps an open-ended searcher (TPE/GP suggest forever) at
    ``num_samples`` trials — the reference applies num_samples to any
    search_alg the same way (tune.run num_samples semantics)."""

    def __init__(self, searcher: Searcher, max_trials: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_trials = max_trials
        self._issued = 0

    def set_search_properties(self, metric, mode, config):
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id):
        if self._issued >= self.max_trials:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._issued += 1
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self.searcher.on_trial_complete(trial_id, result, error)

    @property
    def total_suggestions(self):
        return self.max_trials

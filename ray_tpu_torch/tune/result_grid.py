"""ResultGrid: the return value of Tuner.fit().

Port of ``ray_tpu/tune/result_grid.py``. Design analog: reference
``python/ray/tune/result_grid.py`` (ResultGrid with
get_best_result/get_dataframe).
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.air.result import Result


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str] = None,
                 mode: str = "max"):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set in TuneConfig or here)")
        candidates = [r for r in self._results
                      if r.error is None and metric in (r.metrics or {})]
        if not candidates:
            raise RuntimeError("no completed trial reported "
                               f"metric '{metric}'")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return (max if mode == "max" else min)(candidates, key=key)

    def get_dataframe(self):
        import pandas as pd
        return pd.DataFrame([r.metrics or {} for r in self._results])

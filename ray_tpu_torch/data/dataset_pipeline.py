"""DatasetPipeline: windowed, optionally repeating execution.

Port of ``ray_tpu/data/dataset_pipeline.py``.  Design analog: reference ``python/ray/data/dataset_pipeline.py:64`` --
a pipeline is a sequence of windows (small Datasets); per-window transforms
run while downstream consumes earlier windows, overlapping ingest with
compute (the host->device input pipelining pattern, SURVEY.md §7 hard part (d)).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

from ray_tpu_torch.data.dataset import Dataset


class DatasetPipeline:
    def __init__(self, windows: List[Dataset],
                 stages: Optional[List[Callable[[Dataset], Dataset]]] = None,
                 repeat: Optional[int] = 1):
        self._windows = windows
        self._stages = list(stages or [])
        self._repeat = repeat

    @classmethod
    def from_dataset(cls, ds: Dataset, blocks_per_window: int,
                     repeat: Optional[int] = 1) -> "DatasetPipeline":
        windows = []
        refs = ds._blocks
        for i in range(0, len(refs), blocks_per_window):
            windows.append(Dataset(refs[i:i + blocks_per_window]))
        return cls(windows or [Dataset([])], repeat=repeat)

    def _with_stage(self, stage) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, self._stages + [stage],
                               self._repeat)

    def map(self, fn, **kw):
        return self._with_stage(lambda ds: ds.map(fn, **kw))

    def map_batches(self, fn, **kw):
        return self._with_stage(lambda ds: ds.map_batches(fn, **kw))

    def filter(self, fn, **kw):
        return self._with_stage(lambda ds: ds.filter(fn, **kw))

    def flat_map(self, fn, **kw):
        return self._with_stage(lambda ds: ds.flat_map(fn, **kw))

    def random_shuffle_each_window(self, **kw):
        return self._with_stage(lambda ds: ds.random_shuffle(**kw))

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, self._stages, times)

    def iter_windows(self) -> Iterator[Dataset]:
        """Apply stages lazily; launch window k+1's tasks before consuming
        window k so stage execution overlaps consumption."""
        epoch = 0
        while self._repeat is None or epoch < self._repeat:
            pending: Optional[Dataset] = None
            for w in self._windows:
                nxt = w
                for stage in self._stages:
                    nxt = stage(nxt)  # tasks launch eagerly
                if pending is not None:
                    yield pending
                pending = nxt
            if pending is not None:
                yield pending
            epoch += 1

    def iter_rows(self) -> Iterator[Any]:
        for w in self.iter_windows():
            yield from w.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for w in self.iter_windows():
            yield from w.iter_batches(**kw)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def __repr__(self):
        return (f"DatasetPipeline(windows={len(self._windows)}, "
                f"stages={len(self._stages)}, repeat={self._repeat})")

"""Distributed datasets (Ray Data equivalent).

Port of ``ray_tpu/data``.  Design analog: reference ``python/ray/data/`` -- Dataset (dataset.py:146),
blocks as objects in the shared store (block.py), lazy-free eager stage
execution as remote tasks (_internal/compute.py TaskPoolStrategy /
ActorPoolStrategy), read_api.py datasources, DatasetPipeline
(dataset_pipeline.py:64).  ``iter_batches`` yields host numpy,
``iter_device_batches`` puts it on the card through pinned, double-buffered
copies, and ``split`` aligns shards with a train worker gang.
"""

from ray_tpu_torch.data.dataset import (
    ActorPoolStrategy,
    AggregateFn,
    Count,
    Dataset,
    GroupedData,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A001 - mirrors reference API name
    range_tensor,
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)

from ray_tpu_torch.data.push_shuffle import RandomAccessDataset

__all__ = [
    "ActorPoolStrategy", "AggregateFn", "Count", "Dataset", "DatasetPipeline",
    "GroupedData", "Max", "Mean", "Min", "RandomAccessDataset", "Std", "Sum",
    "from_arrow", "from_items", "from_numpy", "from_pandas", "range",
    "range_tensor",
    "read_binary_files", "read_csv", "read_json", "read_numpy", "read_parquet", "read_text",
]

from ray_tpu_torch._private.usage_stats import record_library_usage as _rlu
_rlu("data")
del _rlu

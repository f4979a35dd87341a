"""Blocks: the unit of distributed data.

Port of ``ray_tpu/data/block.py`` (reference ``python/ray/data/block.py``:
Block = Arrow table / pandas / simple list partition, BlockMetadata,
BlockAccessor).  Three block forms, normalized by BlockAccessor:

  * ``pyarrow.Table``   — the columnar workhorse (zero-copy slice/take,
    native sort, cheap size accounting); what readers and shuffles produce.
  * dict of numpy arrays — tensor blocks for numeric batch pipelines.
  * list of rows        — fallback for arbitrary Python objects.

Arrow tables serialize through the object store via the pickle-5 buffer
protocol, so a block slice/transfer never copies through Python row lists.
Blocks are host data: a ``map_batches`` function may return torch tensors
on the CPU, which become numpy arrays, and a tensor on a card is an error
(``batch_to_block``).  pyarrow and pandas are imported only by the
functions that use them.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


def _is_arrow(block) -> bool:
    try:
        import pyarrow as pa
    except ImportError:
        return False
    return isinstance(block, pa.Table)


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Any] = None

    @staticmethod
    def for_block(block) -> "BlockMetadata":
        acc = BlockAccessor(block)
        return BlockMetadata(num_rows=acc.num_rows(),
                             size_bytes=acc.size_bytes(),
                             schema=acc.schema())


class BlockAccessor:
    """Uniform view over arrow-table, column-dict, and row-list blocks."""

    def __init__(self, block):
        self._block = block
        self._is_arrow = _is_arrow(block)
        self._is_columnar = (not self._is_arrow) and isinstance(block, dict)

    def num_rows(self) -> int:
        if self._is_arrow:
            return self._block.num_rows
        if self._is_columnar:
            if not self._block:
                return 0
            return len(next(iter(self._block.values())))
        return len(self._block)

    def size_bytes(self) -> int:
        if self._is_arrow:
            return int(self._block.nbytes)
        if self._is_columnar:
            return int(sum(np.asarray(v).nbytes
                           for v in self._block.values()))
        try:
            import sys
            return sum(sys.getsizeof(r) for r in self._block[:64]) * \
                max(1, len(self._block) // max(1, len(self._block[:64])))
        except Exception:
            return 0

    def schema(self):
        if self._is_arrow:
            return {f.name: str(f.type) for f in self._block.schema}
        if self._is_columnar:
            return {k: str(np.asarray(v).dtype)
                    for k, v in self._block.items()}
        if self._block and isinstance(self._block[0], dict):
            return sorted(self._block[0].keys())
        return type(self._block[0]).__name__ if self._block else None

    def rows(self) -> List[Any]:
        if self._is_arrow:
            return self._block.to_pylist()
        if self._is_columnar:
            keys = list(self._block.keys())
            n = self.num_rows()
            return [{k: self._block[k][i] for k in keys}
                    for i in range(n)]
        return list(self._block)

    def slice(self, start: int, end: int):
        if self._is_arrow:
            return self._block.slice(start, end - start)  # zero-copy
        if self._is_columnar:
            return {k: v[start:end] for k, v in self._block.items()}
        return self._block[start:end]

    def take(self, indices) -> Any:
        """Row gather by integer indices, preserving the block form."""
        if self._is_arrow:
            return self._block.take(np.asarray(indices, np.int64))
        if self._is_columnar:
            idx = np.asarray(indices, np.int64)
            return {k: np.asarray(v)[idx] for k, v in self._block.items()}
        return [self._block[int(i)] for i in indices]

    def to_numpy_batch(self) -> Dict[str, np.ndarray]:
        """Batch form handed to map_batches(batch_format='numpy')."""
        if self._is_arrow:
            return {name: col.to_numpy(zero_copy_only=False)
                    for name, col in zip(self._block.column_names,
                                         self._block.columns)}
        if self._is_columnar:
            return {k: np.asarray(v) for k, v in self._block.items()}
        if self._block and isinstance(self._block[0], dict):
            keys = self._block[0].keys()
            return {k: np.asarray([r[k] for r in self._block])
                    for k in keys}
        return {"value": np.asarray(self._block)}

    def to_arrow(self):
        """Convert any block form to a pyarrow.Table."""
        import pyarrow as pa
        if self._is_arrow:
            return self._block
        if self._is_columnar:
            return pa.table({k: np.asarray(v)
                             for k, v in self._block.items()})
        if self._block and isinstance(self._block[0], dict):
            return pa.Table.from_pylist(self._block)
        return pa.table({"value": list(self._block)})

    def to_pandas(self):
        import pandas as pd
        if self._is_arrow:
            return self._block.to_pandas()
        if self._is_columnar:
            return pd.DataFrame(
                {k: list(v) for k, v in self._block.items()})
        if self._block and isinstance(self._block[0], dict):
            return pd.DataFrame(self._block)
        return pd.DataFrame({"value": self._block})


def _host_array(value) -> np.ndarray:
    """A column of a returned batch as numpy.  A torch tensor must lie on
    the CPU (torch is looked up, never imported: a batch holds no tensor
    unless its function imported torch)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise TypeError(
                f"map_batches fn returned a tensor on {value.device}; blocks "
                f"are host data, so move it to the CPU in the fn")
        return value.detach().numpy()
    return np.asarray(value)


def batch_to_block(batch) -> Any:
    """Normalize a map_batches return value into a block."""
    if _is_arrow(batch):
        return batch
    if isinstance(batch, dict):
        return {k: _host_array(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return {"value": batch}
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(batch, torch.Tensor):
        return {"value": _host_array(batch)}
    if isinstance(batch, list):
        return batch
    pd = sys.modules.get("pandas")
    if pd is not None and isinstance(batch, pd.DataFrame):
        return {c: batch[c].to_numpy() for c in batch.columns}
    raise TypeError(f"map_batches fn returned unsupported type "
                    f"{type(batch)} (want dict/ndarray/DataFrame/"
                    f"pyarrow.Table/list/CPU torch.Tensor)")

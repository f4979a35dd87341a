"""Dataset creation APIs.

Port of ``ray_tpu/data/read_api.py``.  Design analog: reference ``python/ray/data/read_api.py`` (range:80,
from_items, read_parquet/csv/json via datasource classes at
read_datasource:235).  File reads fan out one task per file.
"""

from __future__ import annotations

import builtins
from typing import Any, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockMetadata
from ray_tpu_torch.data.dataset import Dataset


def _put_blocks(blocks: List[Any]) -> Dataset:
    refs = [ray_tpu_torch.put(b) for b in blocks]
    return Dataset(refs, [BlockMetadata.for_block(b) for b in blocks])


def _split_seq(seq, parallelism):
    n = len(seq)
    parallelism = max(1, min(parallelism, n or 1))
    per = n // parallelism
    extra = n % parallelism
    out, i = [], 0
    for p in builtins.range(parallelism):
        take = per + (1 if p < extra else 0)
        out.append(seq[i:i + take])
        i += take
    return out


def from_items(items: List[Any], *, parallelism: int = 16) -> Dataset:
    return _put_blocks(_split_seq(list(items), parallelism))


def range(n: int, *, parallelism: int = 16) -> Dataset:  # noqa: A001
    return from_items(list(builtins.range(n)), parallelism=parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = 16) -> Dataset:
    splits = _split_seq(np.arange(n), parallelism)
    blocks = []
    for s in splits:
        data = np.broadcast_to(
            s.reshape((len(s),) + (1,) * len(shape)),
            (len(s),) + tuple(shape)).copy()
        blocks.append({"data": data})
    return _put_blocks(blocks)


def from_numpy(arr: np.ndarray, *, parallelism: int = 16) -> Dataset:
    chunks = np.array_split(arr, max(1, min(parallelism, len(arr) or 1)))
    return _put_blocks([{"data": c} for c in chunks if len(c)])


def from_pandas(df, *, parallelism: int = 4) -> Dataset:
    n = len(df)
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1, dtype=int)
    blocks = []
    for a, b in builtins.zip(bounds[:-1], bounds[1:]):
        part = df.iloc[a:b]
        blocks.append({c: part[c].to_numpy() for c in part.columns})
    return _put_blocks(blocks)


# -- file readers (one task per file) -------------------------------------

def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    import os
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if suffix is None or f.endswith(suffix)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files under {paths}")
    return out


def _read_csv_file(path):
    import pandas as pd
    df = pd.read_csv(path)
    return {c: df[c].to_numpy() for c in df.columns}


def _read_json_file(path):
    import pandas as pd
    df = pd.read_json(path, orient="records", lines=True)
    return {c: df[c].to_numpy() for c in df.columns}


def _read_parquet_file(path):
    # Native arrow block: no pandas round-trip, zero-copy column slicing
    # downstream (reference: parquet datasource yields Arrow tables).
    import pyarrow.parquet as pq
    return pq.read_table(path)


def _read_numpy_file(path):
    return {"data": np.load(path)}


def _read_text_file(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def _read_files(paths, reader, suffix) -> Dataset:
    files = _expand_paths(paths, suffix)
    task = ray_tpu_torch.remote(reader)
    return Dataset([task.remote(f) for f in files])


def read_csv(paths, **_) -> Dataset:
    return _read_files(paths, _read_csv_file, ".csv")


def read_json(paths, **_) -> Dataset:
    return _read_files(paths, _read_json_file, ".json")


def read_parquet(paths, **_) -> Dataset:
    return _read_files(paths, _read_parquet_file, ".parquet")


def read_numpy(paths, **_) -> Dataset:
    return _read_files(paths, _read_numpy_file, ".npy")


def read_text(paths, **_) -> Dataset:
    return _read_files(paths, _read_text_file, None)


def _read_binary_file(path, include_paths):
    with open(path, "rb") as f:
        data = f.read()
    return [{"path": path, "bytes": data} if include_paths
            else {"bytes": data}]


def read_binary_files(paths, *, include_paths: bool = False,
                      **_) -> Dataset:
    """One row per file with its raw bytes (reference:
    ``ray.data.read_binary_files``)."""
    files = _expand_paths(paths, None)
    task = ray_tpu_torch.remote(_read_binary_file)
    return Dataset([task.remote(f, include_paths) for f in files])


def from_arrow(tables, *, parallelism: int = 0) -> Dataset:
    """Dataset from pyarrow Table(s) (reference: ray.data.from_arrow).

    Default: one block per table.  ``parallelism`` > number of tables
    re-slices them (zero-copy) into ~parallelism blocks."""
    import pyarrow as pa
    if isinstance(tables, pa.Table):
        tables = [tables]
    tables = list(tables)
    if parallelism > len(tables):
        per = max(1, parallelism // max(1, len(tables)))
        out = []
        for t in tables:
            rows = t.num_rows
            bounds = np.linspace(0, rows, per + 1, dtype=int)
            out.extend(t.slice(a, b - a)
                       for a, b in builtins.zip(bounds[:-1], bounds[1:])
                       if b > a)
        tables = out or tables
    return Dataset([ray_tpu_torch.put(t) for t in tables])

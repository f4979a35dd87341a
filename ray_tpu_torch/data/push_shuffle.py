"""Push-based shuffle + random-access dataset serving.

Port of ``ray_tpu/data/push_shuffle.py``.  Design analogs:
  * ``python/ray/data/_internal/push_based_shuffle.py:330``
    (PushBasedShufflePlan): instead of one merge wave that pulls every
    map shard at once (O(blocks) fan-in, peak memory ~ the whole
    dataset on the merge side), map tasks run in bounded ROUNDS and
    their shards are pushed into per-output merger actors that fold
    them in incrementally — merge work pipelines behind map work and a
    merger holds at most its accumulated output plus one round of
    shards.
  * ``python/ray/data/random_access_dataset.py:23`` (RandomAccessDataset):
    sort by key, partition across serving actors, O(log n) point
    lookups against in-memory sorted columns.
"""

from __future__ import annotations

import bisect
from typing import Any, List, Optional

import numpy as np

import ray_tpu_torch


# ------------------------------------------------------- push shuffle

class _ShuffleMerger:
    """Accumulates shards for ONE output partition, folding each round
    into a single block (bounded memory; the fold is columnar)."""

    def __init__(self):
        self._acc = None

    def add(self, *shards) -> int:
        from ray_tpu_torch.data.dataset import _merge_blocks_local
        blocks = ([self._acc] if self._acc is not None else []) + \
            [s for s in shards if s is not None]
        if blocks:
            self._acc = _merge_blocks_local(blocks)
        from ray_tpu_torch.data.block import BlockAccessor
        return BlockAccessor(self._acc).num_rows() if self._acc is not None \
            else 0

    def finalize(self, seed: int):
        from ray_tpu_torch.data.block import BlockAccessor
        if self._acc is None:
            return []
        acc = BlockAccessor(self._acc)
        idx = np.random.default_rng(seed).permutation(acc.num_rows())
        out = acc.take(idx)
        self._acc = None
        return out


def push_based_shuffle(blocks: List[Any], *, seed: int,
                       round_size: Optional[int] = None) -> List[Any]:
    """Shuffle ``blocks`` (object refs) into ``len(blocks)`` output refs.

    Pipelined rounds: while the mergers fold round k's shards, round
    k+1's partition maps are already running — the driver only ever
    holds one round of intermediate shard refs, so peak intermediate
    memory is ~(round_size / num_blocks) of the dataset instead of all
    of it.
    """
    from ray_tpu_torch.data.dataset import _shuffle_partition

    n = len(blocks)
    if n <= 1:
        from ray_tpu_torch.data.dataset import _shuffle_merge
        merge_task = ray_tpu_torch.remote(_shuffle_merge)
        return [merge_task.remote(seed, b) for b in blocks]
    # Cap the merger-actor gang by cluster size: mergers are
    # zero-CPU-reserving (bursty folds), but each is still a process —
    # a 100-block shuffle must not demand 100 live actors on a 2-CPU
    # box.  Fewer mergers than blocks just means wider output
    # partitions (the reference's merge-task scheduling makes the same
    # trade).
    try:
        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 2))
    except Exception:
        cpus = 2
    n_out = max(2, min(n, 2 * cpus))
    round_size = round_size or max(2, min(n, 8))
    part_task = ray_tpu_torch.remote(_shuffle_partition)
    merger_cls = ray_tpu_torch.remote(num_cpus=0)(_ShuffleMerger)
    mergers = [merger_cls.remote() for _ in range(n_out)]

    all_adds = []
    for lo in range(0, n, round_size):
        round_blocks = blocks[lo:lo + round_size]
        parts = [part_task.options(num_returns=n_out).remote(
                     b, n_out, seed + lo + i)
                 for i, b in enumerate(round_blocks)]
        if n_out == 1:
            parts = [[p] for p in parts]
        # Push this round's shards at the mergers; the shard refs die
        # with this loop iteration, so the store reclaims them as soon
        # as each merger has folded its column of the round.
        all_adds.extend(m.add.remote(*[parts[i][j]
                                       for i in range(len(parts))])
                        for j, m in enumerate(mergers))
    # Barrier over EVERY round's adds: a failed fold must surface as an
    # exception, not as silently missing rows in the output.
    ray_tpu_torch.get(all_adds)
    merged = [m.finalize.remote(seed + 104729 + j)
              for j, m in enumerate(mergers)]
    if n_out == n:
        return merged
    # Fewer mergers than input blocks: re-split each merger's output so
    # the shuffle preserves the dataset's block count (downstream
    # block-aligned ops — zip, split gangs — rely on it).
    split_task = ray_tpu_torch.remote(_split_block_even)
    out: List[Any] = []
    base, extra = divmod(n, n_out)
    for j, ref in enumerate(merged):
        q = base + (1 if j < extra else 0)
        if q <= 1:
            out.append(ref)
        else:
            out.extend(split_task.options(num_returns=q).remote(ref, q))
    return out


def _split_block_even(block, q: int):
    """Slice one block into q near-equal row ranges (tuple of blocks)."""
    from ray_tpu_torch.data.block import BlockAccessor
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    bounds = [rows * i // q for i in range(q + 1)]
    return tuple(acc.slice(bounds[i], bounds[i + 1]) for i in range(q))


# -------------------------------------------------- random-access serving

class _ServerActor:
    """Holds one contiguous key-sorted partition in memory and answers
    point lookups with binary search."""

    def __init__(self, key: str, block):
        from ray_tpu_torch.data.block import BlockAccessor
        self._acc = BlockAccessor(block)
        cols = self._acc.to_numpy_batch()
        self._key_col = np.asarray(cols[key])
        self._cols = cols

    def get(self, key_value):
        i = int(np.searchsorted(self._key_col, key_value))
        if i >= len(self._key_col) or self._key_col[i] != key_value:
            return None
        return {k: v[i].item() if hasattr(v[i], "item") else v[i]
                for k, v in self._cols.items()}

    def multiget(self, key_values):
        return [self.get(k) for k in key_values]

    def num_rows(self) -> int:
        return len(self._key_col)


class RandomAccessDataset:
    """Serve point lookups over a Dataset (reference
    ``random_access_dataset.py``): sorts by ``key``, splits across
    ``num_workers`` actors, routes each lookup by partition boundary.

    >>> rad = RandomAccessDataset(ds, "id", num_workers=2)
    >>> ray_tpu_torch.get(rad.get_async(42))   # row dict or None
    >>> rad.multiget([1, 2, 3])
    """

    def __init__(self, dataset, key: str, *, num_workers: int = 2):
        self._key = key
        sorted_ds = dataset.sort(key)
        parts = sorted_ds.split(num_workers, equal=True)
        from ray_tpu_torch.data.dataset import _merge_blocks
        merge_task = ray_tpu_torch.remote(_merge_blocks)
        server_cls = ray_tpu_torch.remote(num_cpus=0.25)(_ServerActor)
        self._servers = []
        self._lower_bounds: List[Any] = []
        for p in parts:
            block_ref = (p._blocks[0] if len(p._blocks) == 1
                         else merge_task.remote(*p._blocks))
            self._servers.append(server_cls.remote(key, block_ref))
        # Partition boundaries: first key of each partition (driver-side
        # metadata read; small).
        for p in parts:
            rows = p.take(1)
            self._lower_bounds.append(rows[0][key] if rows else None)

    def _route(self, key_value) -> int:
        bounds = [b for b in self._lower_bounds if b is not None]
        i = bisect.bisect_right(bounds, key_value) - 1
        return max(0, i)

    def get_async(self, key_value):
        """ObjectRef of the row dict (None when absent)."""
        return self._servers[self._route(key_value)].get.remote(key_value)

    def multiget(self, key_values) -> List[Any]:
        """Batched lookups, one actor call per touched partition."""
        by_server: dict = {}
        for pos, kv in enumerate(key_values):
            by_server.setdefault(self._route(kv), []).append((pos, kv))
        out: List[Any] = [None] * len(key_values)
        refs = {s: self._servers[s].multiget.remote([kv for _, kv in items])
                for s, items in by_server.items()}
        for s, items in by_server.items():
            vals = ray_tpu_torch.get(refs[s])
            for (pos, _), v in zip(items, vals):
                out[pos] = v
        return out

    def stats(self) -> dict:
        rows = ray_tpu_torch.get([s.num_rows.remote() for s in self._servers])
        return {"num_partitions": len(self._servers),
                "rows_per_partition": rows}

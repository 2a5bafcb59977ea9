"""Ordered merge of sorted shards (the merge-exchange consumer).

Reference: operator/MergeOperator.java + util/MergeSortedPages.java + the
distributed-sort doc (docs/src/main/sphinx/admin/dist-sort.rst): each worker
produces a sorted shard; the single consumer merges them preserving order.

Host substitution: the reference streams pages through a binary-heap merge;
here the shards are dense host columns, so the merge is a vectorized stable
radix pass (np.lexsort) over the concatenated shard keys with the same
direction/NULL/NaN encoding the device sort uses (ops/common.py
_key_with_null_order).  Stability across the concatenation preserves shard
order for ties, which is exactly the heap-merge tie rule.  Dictionary codes
compare like their strings (StringDictionary code == rank) provided all
shards share a dictionary — true for shards of one stacked batch.

Port of trino_tpu/ops/merge.py: the shards are the port's Batches, whose
tensors are read on the host (`.cpu().numpy()`); the merged Batch holds CPU
tensors.  Array and map channels ride along as payload (their lengths with
them; shards of one stacked batch share the element width); as sort keys
they raise, as the analyzer rejects ORDER BY on them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.ops.common import SortKey


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _np_key_parts(col: Column, ascending: bool, nulls_first: bool):
    """(rank or None, [value_keys least->most significant]) mirroring
    ops/common._key_with_null_order.  Long decimals contribute two keys
    (low limb in unsigned order, then high limb)."""
    if col.lengths is not None:
        raise NotImplementedError(f"merge key of type {col.type.name}")
    data = _np(col.data)
    if data.ndim == 2:  # long-decimal limb planes
        hi = data[:, 0]
        lo = data[:, 1] ^ np.int64(-(2**63))  # unsigned order
        if not ascending:
            hi, lo = ~hi, ~lo
        rank = None
        if col.valid is not None:
            rank = np.where(
                _np(col.valid),
                np.zeros(len(data), dtype=np.int8),
                np.asarray(-2 if nulls_first else 2, np.int8),
            )
        return rank, [lo, hi]
    if data.dtype == np.bool_:
        data = data.astype(np.int8)
    rank = None
    if np.issubdtype(data.dtype, np.floating):
        nan = np.isnan(data)
        value_key = np.where(nan, np.asarray(0, data.dtype), data)
        if not ascending:
            value_key = -value_key
        rank = np.where(nan, 1 if ascending else -1, 0).astype(np.int8)
    else:
        value_key = data if ascending else ~data
    if col.valid is not None:
        base = rank if rank is not None else np.zeros(len(data), dtype=np.int8)
        rank = np.where(
            _np(col.valid), base, np.asarray(-2 if nulls_first else 2, np.int8)
        )
    return rank, [value_key]


def merge_sorted_shards(shards: Sequence[Batch], keys: Sequence[SortKey]) -> Batch:
    """Merge per-worker sorted host shards into one sorted host Batch.
    Shards must be compacted (live rows only) and sorted by `keys`."""
    if not shards:
        raise ValueError("no shards to merge")
    nonempty = [s for s in shards if s.capacity]
    if not nonempty:
        return shards[0]  # zero-row result keeps its (empty) schema
    shards = nonempty
    if len(shards) == 1:
        return shards[0]
    # np.lexsort: last key in the sequence is primary -> feed keys reversed,
    # each as (value, rank) with rank more significant than value
    lex_cols: list[np.ndarray] = []
    for k in reversed(list(keys)):
        parts = [
            _np_key_parts(s.columns[k.channel], k.ascending, k.nulls_first)
            for s in shards
        ]
        n_keys = max(len(p[1]) for p in parts)
        for ki in range(n_keys):
            lex_cols.append(
                np.concatenate([p[1][min(ki, len(p[1]) - 1)] for p in parts])
            )
        if any(p[0] is not None for p in parts):
            lex_cols.append(
                np.concatenate(
                    [
                        p[0]
                        if p[0] is not None
                        else np.zeros(s.capacity, dtype=np.int8)
                        for p, s in zip(parts, shards)
                    ]
                )
            )
    order = np.lexsort(lex_cols) if lex_cols else np.arange(
        sum(s.capacity for s in shards)
    )
    cols = []
    for ch in range(shards[0].width):
        first = shards[0].columns[ch]
        parts = [s.columns[ch] for s in shards]
        lengths = None
        if any(p.lengths is not None for p in parts):
            from trino_tpu_torch.columnar.batch import pad_elements

            parts = pad_elements([p.to("cpu") for p in parts])
            lengths = torch.from_numpy(np.concatenate([_np(p.lengths) for p in parts])[order])
        data = np.concatenate([_np(p.data) for p in parts])[order]
        if any(p.valid is not None for p in parts):
            valid = torch.from_numpy(
                np.concatenate(
                    [
                        _np(p.valid)
                        if p.valid is not None
                        else np.ones(s.capacity, dtype=bool)
                        for p, s in zip(parts, shards)
                    ]
                )[order]
            )
        else:
            valid = None
        cols.append(
            Column(torch.from_numpy(data), first.type, valid, first.dictionary, lengths)
        )
    mask = np.concatenate([_np(s.mask()) for s in shards])[order]
    return Batch(cols, torch.from_numpy(mask))

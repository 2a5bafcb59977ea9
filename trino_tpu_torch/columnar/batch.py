"""Batch: the engine's Page (reference: spi/Page.java:31).

Port of trino_tpu/columnar/batch.py.  A Batch is a tuple of
equal-capacity Columns on one device plus an optional boolean row mask.
Capacities are powers of two and filtering ANDs the mask (never
reallocates); operators that need dense input compact explicitly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar.column import Column, pad_slots, take_table


class Batch:
    __slots__ = ("columns", "row_mask")

    def __init__(self, columns: Sequence[Column], row_mask=None):
        self.columns = tuple(columns)
        self.row_mask = row_mask  # None => all rows live

    # -- shape ---------------------------------------------------------------

    @property
    def capacity(self) -> int:
        if self.columns:
            return self.columns[0].capacity
        if self.row_mask is not None:
            return self.row_mask.shape[0]
        return 0

    @property
    def width(self) -> int:
        return len(self.columns)

    @property
    def device(self) -> torch.device:
        if self.columns:
            return self.columns[0].data.device
        if self.row_mask is not None:
            return self.row_mask.device
        return torch.device("cpu")

    def mask(self) -> torch.Tensor:
        """Materialized live-row mask, shape [capacity]."""
        if self.row_mask is None:
            return torch.ones(self.capacity, dtype=torch.bool, device=self.device)
        return self.row_mask

    def count(self) -> torch.Tensor:
        """Device scalar: number of live rows."""
        return self.mask().sum(dtype=torch.int64)

    # -- transforms ----------------------------------------------------------

    def filter(self, keep_mask: torch.Tensor) -> "Batch":
        """AND a boolean mask into the live-row mask."""
        if self.row_mask is None:
            return Batch(self.columns, keep_mask)
        return Batch(self.columns, torch.logical_and(self.row_mask, keep_mask))

    def gather(self, indices: torch.Tensor, valid=None) -> "Batch":
        """Row gather; `valid` marks which gathered slots are live."""
        cols = [c.gather(indices) for c in self.columns]
        if valid is None and self.row_mask is not None:
            valid = self.row_mask[indices.clamp(0, max(self.capacity - 1, 0))]
        return Batch(cols, valid)

    def compact_device(self, out_capacity: Optional[int] = None) -> "Batch":
        """Pack live rows to the front (stable) via cumsum-scatter.

        Output capacity is `out_capacity` (>= the live count) or the input
        capacity; trailing slots are dead."""
        cap = self.capacity
        outc = out_capacity or cap
        dev = self.device
        m = self.mask()
        pos = torch.cumsum(m.to(torch.int64), 0) - 1  # target slot per live row
        # dead rows, and live rows past out_capacity (the JAX package's
        # scatter mode="drop"), go to the spare slot
        idx = torch.where(torch.logical_and(m, pos < outc), pos, outc)
        n = m.sum()
        # inverse permutation: for each output slot, which input row
        inv = torch.zeros(outc + 1, dtype=torch.int64, device=dev).scatter_(
            0, idx, torch.arange(cap, dtype=torch.int64, device=dev)
        )[:outc]
        live = torch.arange(outc, dtype=torch.int64, device=dev) < n
        cols = [c.gather(inv) for c in self.columns]
        return Batch(cols, live)

    def to(self, device, non_blocking: bool = False) -> "Batch":
        cols = [c.to(device, non_blocking=non_blocking) for c in self.columns]
        mask = (
            None
            if self.row_mask is None
            else self.row_mask.to(device, non_blocking=non_blocking)
        )
        return Batch(cols, mask)

    def pin_memory(self) -> "Batch":
        """Page-locked host copy (the source of an async host->card copy)."""
        cols = [c.map_rows(torch.Tensor.pin_memory) for c in self.columns]
        mask = None if self.row_mask is None else self.row_mask.pin_memory()
        return Batch(cols, mask)

    # -- host-side -----------------------------------------------------------

    def num_rows_host(self) -> int:
        if self.row_mask is None:
            return self.capacity
        return int(self.row_mask.sum())

    def to_pylist(self) -> list[list]:
        """Rows of python values (live rows only, in order)."""
        return [list(r) for r in self.to_pytuples()]

    def to_pytuples(self) -> list[tuple]:
        """Rows of python values as tuples (live rows only, in order)."""
        host = self.to("cpu")
        rm = None if host.row_mask is None else host.row_mask.numpy()
        cols = [c.to_pylist(rm) for c in host.columns]
        return list(zip(*cols)) if cols else []

    def __repr__(self) -> str:  # pragma: no cover
        return f"Batch(cap={self.capacity}, width={self.width}, device={self.device})"


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """Concatenate batches on their device (used by accumulating operators).

    Dictionary-encoded columns whose batches carry different dictionaries are
    recoded into a union dictionary (reference analog: DictionaryBlock
    compaction when appending across pages)."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    width = batches[0].width
    cols = []
    for ch in range(width):
        parts = [b.columns[ch] for b in batches]
        dictionary = None
        dicts = [p.dictionary for p in parts]
        if any(d is not None for d in dicts):
            from trino_tpu_torch.columnar.dictionary import union_many

            dictionary, tables = union_many(dicts)
            recoded = []
            for p, table in zip(parts, tables):
                if table is not None:
                    p = Column(take_table(table, p.data), p.type, p.valid, dictionary, p.lengths)
                recoded.append(p)
            parts = recoded
        lengths = None
        if any(p.lengths is not None for p in parts):
            parts = pad_elements(parts)
            lengths = torch.cat([p.lengths for p in parts])
        data = torch.cat([p.data for p in parts])
        valid = None
        if any(p.valid is not None for p in parts):
            valid = torch.cat([p.valid_mask() for p in parts])
        cols.append(Column(data, parts[0].type, valid, dictionary, lengths))
    mask = None
    if any(b.row_mask is not None for b in batches):
        mask = torch.cat([b.mask() for b in batches])
    return Batch(cols, mask)


def pad_elements(parts: Sequence[Column]) -> list:
    """Array/map parts of one channel, right-padded to the widest K (a map
    pads its key and value planes separately).  A part without `lengths`
    carries no elements: it becomes an all-empty [capacity, K] block."""
    from trino_tpu_torch.types import MapType

    is_map = isinstance(parts[0].type, MapType)
    k = max((p.data.shape[1] for p in parts if p.lengths is not None), default=1)
    k = max(k, 2 if is_map else 1)
    out = []
    for p in parts:
        dev = p.data.device
        if p.lengths is None:
            p = Column(
                torch.zeros((p.capacity, k), dtype=p.data.dtype, device=dev),
                p.type, p.valid, p.dictionary,
                torch.zeros(p.capacity, dtype=torch.int32, device=dev),
            )
        elif p.data.shape[1] != k:
            if is_map:
                half = p.data.shape[1] // 2
                extra = (k - p.data.shape[1]) // 2
                data = torch.cat(
                    [pad_slots(p.data[:, :half], extra), pad_slots(p.data[:, half:], extra)],
                    dim=1,
                )
            else:
                data = pad_slots(p.data, k - p.data.shape[1])
            p = Column(data, p.type, p.valid, p.dictionary, p.lengths)
        out.append(p)
    return out

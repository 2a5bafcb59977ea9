"""Ordering operators (reference: OrderByOperator.java, TopNOperator.java:35,
LimitOperator.java).

Port of trino_tpu/ops/sort.py.  TopN keeps a bounded device state: each
pushed batch is merged with the current top-N candidates and truncated.
ORDER BY sorts its whole input on the device; over its memory budget it
becomes an external sort: the accumulated batches are compacted and moved
off the card as a run (to the filesystem through the spill tier, or host
RAM), and the runs merge at the end in one host lexsort
(ops/merge.py).  Array and map columns ride in the spilled runs as payload,
their lengths with them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.ops.aggregation import _pad_device
from trino_tpu_torch.ops.common import SortKey, multi_key_sort_perm, next_pow2


def _sorted(batch: Batch, keys) -> Batch:
    perm = multi_key_sort_perm(batch, keys)
    return batch.gather(perm, valid=batch.mask()[perm])


class OrderByOperator:
    """Full materialized sort; emits one sorted batch.  With a memory
    context it reserves its accumulation and, over budget, spills runs."""

    def __init__(self, keys: Sequence[SortKey], memory_ctx=None,
                 spill_factory=None, observer=None):
        self.keys = list(keys)
        self.memory_ctx = memory_ctx
        #: lazy spill store (runtime/spill.SpillManager) for over-budget
        #: runs; None, or a factory returning None, keeps runs in host RAM
        self._spill_factory = spill_factory
        self._spiller = None
        self._spiller_made = False
        self._spill_runs = 0
        self.observer = observer
        self._acc: list[Batch] = []

    def _get_spiller(self):
        if not self._spiller_made:
            self._spiller_made = True
            if self._spill_factory is not None:
                self._spiller = self._spill_factory()
        return self._spiller

    def _spill_chunk(self):
        """Compact the accumulated batches to live rows and move them off
        the device as one run: to the filesystem when a spiller is attached
        (reference: GenericSpiller in OrderByOperator's revoke path), host
        RAM otherwise.  Runs are not sorted one by one: the final merge is
        a full host lexsort.  Returns the host run, or a disk-run id."""
        from trino_tpu_torch.runtime.spill import pull_host

        big = self._acc[0] if len(self._acc) == 1 else concat_batches(self._acc)
        self._acc.clear()
        n = big.num_rows_host()
        host = pull_host(big.compact_device(out_capacity=next_pow2(max(n, 1), floor=1)))
        spiller = self._get_spiller()
        if spiller is None:
            return host
        run = self._spill_runs
        self._spill_runs += 1
        spiller.save("run", run, [host])
        return run

    def _load_runs(self, runs: list) -> list:
        """Disk-run ids back to host batches (runs in RAM pass through)."""
        spiller = self._spiller
        return [spiller.load("run", r)[0] if isinstance(r, int) else r for r in runs]

    def process(self, stream):
        """In-memory device sort; over budget an EXTERNAL sort: spill runs
        as the budget trips, merge them at the end on the host, so device
        memory stays bounded by one chunk."""
        from trino_tpu_torch.runtime.memory import (
            ExceededMemoryLimitException,
            batches_bytes,
        )
        from trino_tpu_torch.runtime.spill import to_device

        runs: list = []
        device = None
        try:
            for b in stream:
                device = b.device
                self._acc.append(b)
                if self.memory_ctx is not None:
                    # over the whole accumulation, so a dictionary shared by
                    # every batch counts once
                    try:
                        self.memory_ctx.set_bytes(batches_bytes(self._acc))
                    except ExceededMemoryLimitException:
                        runs.append(self._spill_chunk())
                        self.memory_ctx.set_bytes(0)
            if not self._acc and not runs:
                return
            if not runs:
                big = self._acc[0] if len(self._acc) == 1 else concat_batches(self._acc)
                out = _sorted(_pad_device(big, next_pow2(big.capacity, floor=1)), self.keys)
                if self.memory_ctx is not None:
                    self.memory_ctx.close()
                yield out
                return
            if self._acc:
                runs.append(self._spill_chunk())
            if self.observer is not None:
                # external-sort waves: one per run
                self.observer.waves("sort", len(runs))
            runs = self._load_runs(runs)
            if len(runs) == 1:
                # the budget tripped at the very end: sort the one run on the
                # device, as the in-memory path would have
                big = to_device(runs[0], device)
                out = _sorted(_pad_device(big, next_pow2(big.capacity, floor=1)), self.keys)
                if self.memory_ctx is not None:
                    self.memory_ctx.close()
                yield out
                return
            from trino_tpu_torch.ops.merge import merge_sorted_shards

            out = merge_sorted_shards(_unify_host_dictionaries(runs), self.keys)
            if self.memory_ctx is not None:
                self.memory_ctx.close()
            yield to_device(out, device)
        finally:
            if self._spiller is not None:
                self._spiller.close()


class TopNOperator:
    def __init__(self, keys: Sequence[SortKey], n: int):
        self.keys = list(keys)
        self.n = n
        self._state: Optional[Batch] = None

    def _merge_step(self, batch: Batch, out_cap: int) -> Batch:
        perm = multi_key_sort_perm(batch, self.keys)
        live = batch.mask()[perm]
        # keep only the first n live rows
        rank = torch.cumsum(live.to(torch.int64), 0) - 1
        keep = torch.logical_and(live, rank < self.n)
        return _truncate(batch.gather(perm, valid=keep), out_cap)

    def process(self, stream):
        out_cap = next_pow2(self.n, floor=1)
        for b in stream:
            if self._state is not None:
                b = concat_batches([self._state, b])
            b = _pad_device(b, next_pow2(b.capacity, floor=1))
            self._state = self._merge_step(b, out_cap)
        if self._state is not None:
            yield self._state


class LimitOperator:
    """LIMIT/OFFSET without ordering; truncates the stream host-side
    (reference: LimitOperator.java + OffsetOperator.java).  count=None
    means OFFSET-only (skip, keep the rest)."""

    def __init__(self, n, offset: int = 0):
        self.n = n
        self.offset = offset

    def process(self, stream):
        skip = self.offset
        remaining = self.n  # None = unlimited
        for b in stream:
            if remaining is not None and remaining <= 0:
                break
            cnt = b.num_rows_host()
            if skip >= cnt:
                skip -= cnt
                continue
            if skip > 0 or (remaining is not None and cnt - skip > remaining):
                live = b.mask()
                rank = torch.cumsum(live.to(torch.int64), 0) - 1
                keep = torch.logical_and(live, rank >= skip)
                if remaining is not None:
                    keep = torch.logical_and(keep, rank < skip + remaining)
                    remaining -= min(cnt - skip, remaining)
                yield b.filter(keep)
                skip = 0
            else:
                remaining = None if remaining is None else remaining - (cnt - skip)
                skip = 0
                yield b


def _unify_host_dictionaries(runs: list) -> list:
    """Host batches from different scan batches may carry their own
    dictionaries; recode every string channel into one union dictionary so
    code comparisons are rank comparisons again."""
    from trino_tpu_torch.columnar.column import take_table
    from trino_tpu_torch.columnar.dictionary import union_many

    if not runs:
        return runs
    out = [list(r.columns) for r in runs]
    for ch in range(runs[0].width):
        dicts = [r.columns[ch].dictionary for r in runs]
        if not any(d is not None for d in dicts):
            continue
        merged, tables = union_many(dicts)
        for i, table in enumerate(tables):
            c = out[i][ch]
            data = c.data
            if table is not None and len(table):  # an empty dictionary: all NULL
                data = take_table(table, data)
            out[i][ch] = Column(data, c.type, c.valid, merged, c.lengths)
    return [Batch(cols, r.row_mask) for cols, r in zip(out, runs)]


def _truncate(batch: Batch, cap: int) -> Batch:
    """Slice the leading `cap` rows (used after sorts put keepers first)."""
    cols = [c.map_rows(lambda x: x[:cap]) for c in batch.columns]
    return Batch(cols, batch.mask()[:cap])

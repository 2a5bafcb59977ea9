"""Window function operator (reference: operator/WindowOperator.java +
operator/window/* — rank family, value family, aggregate-over-frame).

Port of trino_tpu/ops/window.py.  One materialized sort by (partition
keys, order keys), then every window function is a closed-form computation
over partition/peer boundary flags — prefix sums (`cumsum`), segment
reductions, and shifted gathers — instead of the reference's per-partition
imperative loops (WindowPartition.processNextRow).

Supported frames: the SQL default RANGE BETWEEN UNBOUNDED PRECEDING AND
CURRENT ROW (running, peer-inclusive), ROWS frames with unbounded or literal
row offsets (reference: operator/window/FrameInfo.java), and the
whole-partition frame (no ORDER BY, or UNBOUNDED..UNBOUNDED).

Where the JAX package gathers with `mode="clip"`, this module clamps the
indices (`_take`); the running min/max's segmented `associative_scan` is a
log2(cap) doubling scan that combines a row with the row `s` places before
it only while both hold the same partition id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.columnar.column import torch_dtype
from trino_tpu_torch.ops.aggregation import _note_fastpath
from trino_tpu_torch.ops.common import (
    SortKey,
    _max_sentinel,
    _min_sentinel,
    _segment_extreme,
    multi_key_sort_perm,
    require_scalar_key,
    segment_sum,
)


@dataclass(frozen=True)
class WindowSpec:
    """One window function: rank family (no arg) or aggregate/value family
    (arg = input channel).  frame: 'range' (default running, peer-aware),
    'rows' (running, row-exact), 'full' (whole partition)."""

    name: str  # row_number | rank | dense_rank | ntile | percent_rank |
    #            cume_dist | lag | lead | first_value | last_value |
    #            nth_value | sum | count | avg | min | max
    arg: Optional[int]
    out_type: T.Type
    offset: int = 1  # lag/lead offset, nth_value's n (literal)
    default_channel: Optional[int] = None  # lag/lead default value column
    n_buckets: int = 1  # ntile
    frame: str = "range"
    # ROWS-frame bounds relative to the current row (None = unbounded on that
    # side); the default running frame is (None, 0).
    start_off: Optional[int] = None
    end_off: Optional[int] = 0
    # IGNORE NULLS for lag/lead/first_value/last_value/nth_value
    ignore_nulls: bool = False
    #: proof-licensed |frame sum| bound for decimal sum/avg (planner range
    #: certificate, plan.WindowFunction.sum_bound): a long-decimal input
    #: whose every frame sum provably fits int64 runs one int64 prefix sum
    #: instead of limb-plane arithmetic
    sum_bound: Optional[int] = None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the first axis with the indices clamped into range
    (the JAX package's `take(mode="clip")`)."""
    return x[idx.clamp(0, max(x.shape[0] - 1, 0))]


def _neq_prev(col: Column, perm: torch.Tensor) -> torch.Tensor:
    """Null-safe 'differs from the previous sorted row' flags of one key
    column (row 0 compares with the last row, as `roll` wraps)."""
    require_scalar_key(col)
    d = col.data[perm]
    neq = d != torch.roll(d, 1, 0)
    if neq.ndim > 1:  # long-decimal limb planes
        neq = neq.any(dim=-1)
    if col.valid is not None:
        v = col.valid[perm]
        pv = torch.roll(v, 1, 0)
        neq = torch.logical_or(torch.logical_and(neq, torch.logical_and(v, pv)), v != pv)
    return neq


class WindowOperator:
    def __init__(
        self,
        partition_channels: Sequence[int],
        order_keys: Sequence[SortKey],
        specs: Sequence[WindowSpec],
    ):
        self.partition_channels = list(partition_channels)
        self.order_keys = list(order_keys)
        self.specs = list(specs)
        self._acc: list[Batch] = []

    # -- the device step --------------------------------------------------------

    def _window_step(self, batch: Batch) -> Batch:
        cap = batch.capacity
        dev = batch.device
        keys = [SortKey(ch) for ch in self.partition_channels] + self.order_keys
        # always sort: even with no keys, multi_key_sort_perm moves dead
        # (filtered-out) rows last, so positional logic below only sees live
        # rows in the prefix — `row_number() over ()` must not count dead rows
        perm = multi_key_sort_perm(batch, keys)
        live = batch.mask()[perm]
        pos = torch.arange(cap, dtype=torch.int64, device=dev)

        # partition boundaries (null-safe equality over partition keys)
        new_part = torch.zeros(cap, dtype=torch.bool, device=dev)
        first_live = torch.logical_and(live, torch.cumsum(live.to(torch.int64), 0) == 1)
        for ch in self.partition_channels:
            new_part = torch.logical_or(new_part, _neq_prev(batch.columns[ch], perm))
        new_part = torch.logical_or(torch.logical_and(live, new_part), first_live)
        pid = torch.cumsum(new_part.to(torch.int64), 0) - 1  # partition id per sorted row
        pid = torch.where(live, pid, cap)
        nseg = cap + 1
        part_start = _segment_extreme(torch.where(live, pos, cap), pid, nseg, "amin")
        part_size = segment_sum(live.to(torch.int64), pid, nseg)
        idx_in_part = pos - part_start[pid]

        # peer boundaries (order-key ties within a partition)
        new_peer = new_part
        for k in self.order_keys:
            neq = _neq_prev(batch.columns[k.channel], perm)
            new_peer = torch.logical_or(new_peer, torch.logical_and(live, neq))
        peer_gid = torch.cumsum(new_peer.to(torch.int64), 0) - 1
        peer_gid = torch.where(live, peer_gid, cap)
        # last row index of each peer group (for RANGE running frames)
        peer_last = _segment_extreme(torch.where(live, pos, -1), peer_gid, nseg, "amax")

        out_cols = []
        for spec in self.specs:
            out_cols.append(
                self._compute(
                    spec, batch, perm, live, pid, nseg, part_start, part_size,
                    idx_in_part, new_peer, peer_gid, peer_last, pos, cap,
                )
            )
        # scatter back to original row order: inv is perm's inverse
        inv = torch.empty(cap, dtype=torch.int64, device=dev).scatter_(0, perm, pos)
        final_cols = list(batch.columns)
        for c in out_cols:
            valid = None if c.valid is None else c.valid[inv]
            final_cols.append(Column(c.data[inv], c.type, valid, c.dictionary))
        return Batch(final_cols, batch.row_mask)

    @staticmethod
    def _valid_ranks(v, live, part_first, pos, cap):
        """(pref, pos_of) for IGNORE NULLS: pref[i] = count of non-null live
        rows at or before sorted row i WITHIN its partition; pos_of is a
        [cap+1] table mapping slot part_first + rank (0-based, per
        partition) -> the sorted-row index of that partition's rank-th
        non-null row (cap = no such row).  Slots of different partitions
        are disjoint because ranks never exceed the partition size; the
        rows with no rank all write slot cap, which no lookup of a found
        row reads."""
        vi = torch.logical_and(live, v)
        c = torch.cumsum(vi.to(torch.int64), 0)
        base = torch.where(part_first > 0, _take(c, part_first - 1), 0)
        pref = c - base
        slot = torch.where(vi, part_first + pref - 1, cap)
        pos_of = torch.full((cap + 1,), cap, dtype=torch.int64, device=pos.device)
        pos_of = pos_of.scatter_(0, slot, pos)
        return pref, pos_of

    @staticmethod
    def _sorted_arg(col: Column, perm, cap):
        """(data, valid) of a value argument in sorted order."""
        d = col.data[perm]
        if col.valid is None:
            return d, torch.ones(cap, dtype=torch.bool, device=d.device)
        return d, col.valid[perm]

    def _with_default(self, spec, batch, perm, cap, data, valid, use_value):
        """lag/lead: rows without a source row take the default column."""
        if spec.default_channel is None:
            return data, valid
        dd, dv = self._sorted_arg(batch.columns[spec.default_channel], perm, cap)
        return torch.where(use_value, data, dd), torch.where(use_value, valid, dv)

    def _compute(
        self, spec, batch, perm, live, pid, nseg, part_start, part_size,
        idx_in_part, new_peer, peer_gid, peer_last, pos, cap,
    ) -> Column:
        name = spec.name
        if name != "count" and spec.arg is not None:
            arg_col = batch.columns[spec.arg]
            if arg_col.lengths is not None:
                # an [capacity, K] block would read as K limb planes (the
                # JAX package fails on the shape here)
                raise NotImplementedError(f"window {name} over an {arg_col.type.name} column")
        n_in_part = part_size[pid]
        out_dt = torch_dtype(spec.out_type.np_dtype)

        # frame bounds as sorted-row indices [lo, hi] per row (FrameInfo.java)
        part_first = part_start[pid]
        part_last = part_first + n_in_part - 1
        whole = spec.frame == "full" or not self.order_keys
        if whole:
            lo, hi = part_first, part_last
        elif spec.frame == "rows":
            lo = (
                part_first
                if spec.start_off is None
                else torch.maximum(part_first, pos + spec.start_off)
            )
            hi = (
                part_last
                if spec.end_off is None
                else torch.minimum(part_last, pos + spec.end_off)
            )
        else:  # default RANGE running frame: start of partition .. last peer
            lo = part_first
            hi = peer_last[peer_gid]
        frame_n = (hi - lo + 1).clamp(min=0)

        if name == "row_number":
            return Column(idx_in_part + 1, T.BIGINT, None)
        if name in ("rank", "dense_rank", "percent_rank", "cume_dist", "ntile"):
            # rank = index of first peer row in partition + 1
            first_peer = _segment_extreme(torch.where(live, pos, cap), peer_gid, nseg, "amin")
            rank = first_peer[peer_gid] - part_start[pid] + 1
            if name == "rank":
                return Column(rank, T.BIGINT, None)
            if name == "dense_rank":
                cs = torch.cumsum(new_peer.to(torch.int64), 0)
                return Column(cs - _take(cs, part_start[pid]) + 1, T.BIGINT, None)
            if name == "percent_rank":
                den = (n_in_part - 1).clamp(min=1)
                return Column(
                    (rank - 1).to(torch.float64) / den.to(torch.float64), T.DOUBLE, None
                )
            if name == "cume_dist":
                covered = peer_last[peer_gid] - part_start[pid] + 1
                return Column(
                    covered.to(torch.float64) / n_in_part.clamp(min=1).to(torch.float64),
                    T.DOUBLE, None,
                )
            n = spec.n_buckets  # ntile
            base, rem = n_in_part // n, n_in_part % n
            big = (base + 1) * rem  # rows covered by the larger buckets
            bucket = torch.where(
                idx_in_part < big,
                idx_in_part // (base + 1).clamp(min=1),
                rem + (idx_in_part - big) // base.clamp(min=1),
            )
            return Column(bucket + 1, T.BIGINT, None)
        if name in ("lag", "lead"):
            col = batch.columns[spec.arg]
            d, v = self._sorted_arg(col, perm, cap)
            if spec.ignore_nulls:
                # k-th non-null neighbour via per-partition valid-rank
                # indexing: rank positions scatter to a dense pos_of table
                # laid out at partition offsets, so one gather finds the row
                pref, pos_of = self._valid_ranks(v, live, part_first, pos, cap)
                if name == "lag":
                    tgt = pref - v.to(torch.int64) - spec.offset
                    found = tgt >= 0
                else:
                    total = _take(pref, part_last)
                    tgt = pref + spec.offset - 1
                    found = pref + spec.offset <= total
                slot = torch.where(found, part_first + tgt, cap)
                src_row = _take(pos_of, slot)
                data = _take(d, src_row)
                valid = torch.logical_and(found, src_row < cap)
                data, valid = self._with_default(spec, batch, perm, cap, data, valid, valid)
                return Column(data.to(out_dt), spec.out_type, valid, col.dictionary)
            off = spec.offset if name == "lag" else -spec.offset
            src = pos - off
            in_part = torch.logical_and(
                src >= part_start[pid], src < part_start[pid] + n_in_part
            )
            data = _take(d, src)
            valid = torch.logical_and(in_part, _take(v, src))
            data, valid = self._with_default(spec, batch, perm, cap, data, valid, in_part)
            return Column(data.to(out_dt), spec.out_type, valid, col.dictionary)
        if name in ("first_value", "last_value", "nth_value"):
            col = batch.columns[spec.arg]
            d, v = self._sorted_arg(col, perm, cap)
            if spec.ignore_nulls:
                # first/last/nth non-null row of the frame [lo, hi] via the
                # same valid-rank table: frame valid count = pref[hi]-pref[lo-1]
                pref, pos_of = self._valid_ranks(v, live, part_first, pos, cap)
                before = torch.where(lo > part_first, _take(pref, lo - 1), 0)
                upto = torch.where(frame_n > 0, _take(pref, hi), before)
                if name == "first_value":
                    found = upto > before
                    rank0 = before
                elif name == "last_value":
                    found = upto > before
                    rank0 = upto - 1
                else:  # nth_value(x, n): n-th non-null row of the frame
                    found = upto - before >= spec.offset
                    rank0 = before + spec.offset - 1
                slot = torch.where(found, part_first + rank0, cap)
                src_row = _take(pos_of, slot)
                return Column(
                    _take(d, src_row).to(out_dt),
                    spec.out_type,
                    torch.logical_and(found, src_row < cap),
                    col.dictionary,
                )
            if name == "nth_value":
                src_raw = lo + spec.offset - 1
                in_frame = src_raw <= hi
                return Column(
                    _take(d, src_raw).to(out_dt),
                    spec.out_type,
                    torch.logical_and(
                        torch.logical_and(_take(v, src_raw), in_frame), frame_n > 0
                    ),
                    col.dictionary,
                )
            src = lo if name == "first_value" else hi
            return Column(
                _take(d, src).to(out_dt),
                spec.out_type,
                torch.logical_and(_take(v, src), frame_n > 0),
                col.dictionary,
            )
        # aggregates over the frame
        if name == "count" and spec.arg is None:  # count(*) over (...)
            return Column(frame_n, T.BIGINT, None)
        col = batch.columns[spec.arg]
        d = col.data[perm]
        v = live
        if col.valid is not None:
            v = torch.logical_and(v, col.valid[perm])
        if name in ("sum", "avg", "count"):
            if d.ndim > 1:
                if name != "count":
                    # long-decimal (two-limb) input: exact frame sums over
                    # limb planes — or, when the planner attached a range
                    # certificate proving every frame sum fits int64, one
                    # int64 prefix sum
                    return self._long_decimal_sum_avg(
                        spec, name, d, v, whole, pid, nseg,
                        lo, hi, frame_n, cap,
                    )
                # count reads only the validity mask: a 1-D surrogate keeps
                # the shared sum/count reduction below shape-correct
                d = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
            acc_dt = torch.float64 if d.is_floating_point() else torch.int64
            dd = torch.where(v, d, 0).to(acc_dt)
            cnt_inc = v.to(torch.int64)
            if whole:
                ssum = segment_sum(dd, pid, nseg)[pid]
                scnt = segment_sum(cnt_inc, pid, nseg)[pid]
            else:
                run = torch.cumsum(dd, 0)
                runc = torch.cumsum(cnt_inc, 0)
                before = torch.where(lo > 0, _take(run, lo - 1), 0)
                beforec = torch.where(lo > 0, _take(runc, lo - 1), 0)
                ssum = torch.where(frame_n > 0, _take(run, hi) - before, 0)
                scnt = torch.where(frame_n > 0, _take(runc, hi) - beforec, 0)
            if name == "count":
                return Column(scnt, T.BIGINT, None)
            if name == "sum":
                return Column(ssum.to(out_dt), spec.out_type, scnt > 0, col.dictionary)
            if isinstance(spec.out_type, T.DecimalType):
                # exact integer half-away-from-zero, matching the grouped
                # aggregate's _finalize
                den = scnt.clamp(min=1)
                mag = ssum.abs()
                q = mag // den
                r = mag - q * den
                avg = torch.sign(ssum) * (q + torch.where(2 * r >= den, 1, 0))
            else:
                avg = ssum.to(torch.float64) / scnt.clamp(min=1)
            return Column(avg.to(out_dt), spec.out_type, scnt > 0)
        if name in ("min", "max"):
            if d.ndim > 1:
                raise NotImplementedError(
                    "window min/max over a long-decimal input column "
                    "(cast to decimal(18,s) or double first)"
                )
            return self._minmax(
                spec, name, d, v, whole, pid, nseg, lo, hi,
                frame_n, cap, col,
            )
        raise NotImplementedError(f"window function {name}")

    def _long_decimal_sum_avg(
        self, spec, name, d, v, whole, pid, nseg, lo, hi,
        frame_n, cap,
    ) -> Column:
        """sum/avg over a long-decimal (limb-plane) input column.

        Validity contract: invalid rows are zeroed before every reduction
        (additive identity) and the output plane is scnt > 0 — NULLs can
        never resurface as values.

        Licensed path: the planner's range certificate (WindowSpec
        .sum_bound) proves every value AND every frame sum lies inside
        int64, so the low limb IS the value (high limb pure sign extension)
        and one int64 prefix / segment sum is exact.

        Limb path: exact i128 frame sums.  Whole-partition frames reduce
        via segment_sum128; running frames build prefix sums over the four
        32-bit chunk planes (each prefix stays under cap * 2**32 < 2**63,
        the recombine4 contract) and difference them per frame with a full
        128-bit borrow.  The avg then divides with divmod128_by_vec."""
        from trino_tpu_torch.types import int128 as i128

        h = torch.where(v, d[:, 0], 0)
        l = torch.where(v, d[:, 1], 0)
        cnt_inc = v.to(torch.int64)

        if whole:
            scnt = segment_sum(cnt_inc, pid, nseg)[pid]
        else:
            runc = torch.cumsum(cnt_inc, 0)
            beforec = torch.where(lo > 0, _take(runc, lo - 1), 0)
            scnt = torch.where(frame_n > 0, _take(runc, hi) - beforec, 0)

        licensed = spec.sum_bound is not None and spec.sum_bound < (1 << 63) - 1
        if licensed:
            _note_fastpath("proven")
            # |value| <= sum_bound < 2**63: the low limb is the value
            if whole:
                ssum = segment_sum(l, pid, nseg)[pid]
            else:
                run = torch.cumsum(l, 0)
                before = torch.where(lo > 0, _take(run, lo - 1), 0)
                ssum = torch.where(frame_n > 0, _take(run, hi) - before, 0)
            sh, sl = i128.widen64(ssum)
        else:
            _note_fastpath("limb")
            if whole:
                sh, sl = i128.segment_sum128(h, l, pid, nseg)
                sh = sh[pid]
                sl = sl[pid]
            else:
                mask32 = 0xFFFFFFFF
                planes = (l & mask32, (l >> 32) & mask32, h & mask32, h >> 32)
                runs = [torch.cumsum(p, 0) for p in planes]

                def frame_at(i, present):
                    return i128.recombine4(
                        *[torch.where(present, _take(r, i), 0) for r in runs]
                    )

                eh, el = frame_at(hi, frame_n > 0)
                bh, bl = frame_at(lo - 1, torch.logical_and(frame_n > 0, lo > 0))
                sh, sl = i128.sub128(eh, el, bh, bl)

        if name == "sum":
            if spec.out_type.is_long:
                data = torch.stack([sh, sl], dim=-1)
            else:
                # a short declared result asserts the values fit: the low
                # limb carries them exactly (same contract as _finalize)
                data = sl
            return Column(data, spec.out_type, scnt > 0)
        # avg: exact integer division, round half away from zero —
        # mirroring _finalize's DecimalAverageAggregation path bit for bit
        den = scnt.clamp(min=1)
        qh, ql, r = i128.divmod128_by_vec(sh, sl, den)
        half = torch.where(2 * r.abs() >= den, 1, 0)
        bump = torch.where(sh < 0, -half, half)
        qh2, ql2 = i128.add128(qh, ql, bump >> 63, bump)
        data = torch.stack([qh2, ql2], dim=-1) if spec.out_type.is_long else ql2
        return Column(data, spec.out_type, scnt > 0)

    def _minmax(
        self, spec, name, d, v, whole, pid, nseg, lo, hi,
        frame_n, cap, col,
    ) -> Column:
        sent = _max_sentinel(d.dtype) if name == "min" else _min_sentinel(d.dtype)
        dd = torch.where(v, d, sent)
        if whole:
            red = _segment_extreme(dd, pid, nseg, "amin" if name == "min" else "amax")[pid]
            cnt = segment_sum(v.to(torch.int64), pid, nseg)[pid]
            return Column(red, spec.out_type, cnt > 0, col.dictionary)
        op = torch.minimum if name == "min" else torch.maximum
        if spec.start_off is not None:
            # bounded sliding min/max: sparse-table range query (O(n log n)
            # build of power-of-two block extremes, O(1) two-block query per
            # row, vectorized; the substitute for the reference's per-row
            # frame re-scan)
            levels = [dd]
            width = 1
            while width < cap:
                prev = levels[-1]
                pad = torch.full((width,), sent, dtype=dd.dtype, device=dd.device)
                levels.append(op(prev, torch.cat([prev[width:], pad])))
                width *= 2
            table = torch.stack(levels)  # [L, cap]; level j covers 2^j rows
            length = (hi - lo + 1).clamp(min=1)
            j = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
            j = j.clamp(0, len(levels) - 1)
            lo_c = lo.clamp(0, cap - 1)
            start2 = (hi - torch.bitwise_left_shift(torch.ones_like(j), j) + 1).clamp(0, cap - 1)
            flat = table.reshape(-1)
            red = op(_take(flat, j * cap + lo_c), _take(flat, j * cap + start2))
        else:
            # running min/max: a prefix scan reset at partition starts.  pid
            # is nondecreasing along the sorted rows, so after the step of
            # stride s each row holds the extreme of the rows of its
            # partition among the 2s rows ending at it (Hillis-Steele)
            red = dd
            s = 1
            while s < cap:
                prev = torch.cat(
                    [torch.full((s,), sent, dtype=dd.dtype, device=dd.device), red[:-s]]
                )
                same = torch.cat(
                    [torch.zeros(s, dtype=torch.bool, device=dd.device), pid[s:] == pid[:-s]]
                )
                red = torch.where(same, op(prev, red), red)
                s *= 2
            red = _take(red, hi)
        runc = torch.cumsum(v.to(torch.int64), 0)
        before = torch.where(lo > 0, _take(runc, lo - 1), 0)
        cnt = torch.where(frame_n > 0, _take(runc, hi) - before, 0)
        return Column(red, spec.out_type, cnt > 0, col.dictionary)

    # -- host-side --------------------------------------------------------------

    def _unify_default_dicts(self, batch: Batch) -> Batch:
        """lag/lead defaults must share the argument's dictionary: the step
        merges raw codes with torch.where, so mixed dictionaries would decode
        wrongly (host-side recode, the DictionaryBlock-compaction analog)."""
        from trino_tpu_torch.columnar.dictionary import union_many

        cols = list(batch.columns)
        for spec in self.specs:
            if spec.name not in ("lag", "lead") or spec.default_channel is None:
                continue
            a, d = cols[spec.arg], cols[spec.default_channel]
            if a.dictionary is None and d.dictionary is None:
                continue
            if a.dictionary is d.dictionary or a.dictionary == d.dictionary:
                continue
            if a.dictionary is None or d.dictionary is None:
                raise NotImplementedError(
                    "lag/lead default mixes dictionary and non-dictionary strings"
                )
            merged, (ta, td) = union_many([a.dictionary, d.dictionary])
            for ch, col, table in ((spec.arg, a, ta), (spec.default_channel, d, td)):
                if table is None:
                    cols[ch] = Column(col.data, col.type, col.valid, merged)
                else:
                    tbl = torch.from_numpy(table).to(col.data.device)
                    cols[ch] = Column(
                        _take(tbl, col.data.to(torch.int64)), col.type, col.valid, merged
                    )
        return Batch(cols, batch.row_mask)

    def step(self, batch: Batch) -> Batch:
        """One whole input (every partition complete) -> the input with the
        window columns appended: the local path's and the mesh workers'
        step."""
        return self._window_step(self._unify_default_dicts(batch))

    def process(self, stream):
        for b in stream:
            self._acc.append(b)
        if not self._acc:
            return
        big = self._acc[0] if len(self._acc) == 1 else concat_batches(self._acc)
        # no pow2 pad: the JAX package pads so XLA does not retrace; every
        # position here is relative to the batch's own capacity
        yield self.step(big)

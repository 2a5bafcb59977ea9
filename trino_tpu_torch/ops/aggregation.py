"""Aggregation operator — grouped reduction on the device.

Port of trino_tpu/ops/aggregation.py (reference roles:
HashAggregationOperator.java:49, AggregationOperator (global),
MultiChannelGroupByHash.java:216).  Group ids come from the small-domain
direct path (dictionary/boolean keys -> mixed-radix slot, no sort) or from
a stable multi-key sort + key-change cumsum; accumulators are segmented
reductions.

Modes mirror the reference's AggregationNode.Step:
  SINGLE  : raw rows -> final values
  PARTIAL : raw rows -> state columns (for exchange)
  FINAL   : state columns -> final values
  MERGE   : state columns -> state columns

The operator streams: it reduces every pushed batch immediately and keeps
only the per-batch group states (the TPC-H Q1 shape), folding them every
`fold_every` batches.  (The JAX package's non-streaming mode serves the
holistic aggregates, which are not ported.)

Ported aggregates: count(*), count, sum, avg, min, max, any_value, the
moment family (stddev_samp, stddev_pop, var_samp, var_pop: f64 sum, sum of
squares and count states, merged by addition), and MarkDistinctOperator
(the mark column of mixed DISTINCT sets).  The
range-positional group path, the two-input aggregates and the
holistic/sketch aggregates are not ported yet (integer group keys take the
sort path).

Difference from the JAX package: the `pallas_agg` knob reaches the
grouped-sums kernel (ops/grouped_sums.py) from the streaming per-batch
reducer too — `_batch_reducer` passes `use_pallas` on and
`_pallas_direct_sums` serves PARTIAL mode by returning the primitive state
columns.  In the JAX package the streaming reducer drops the knob, so the
kernel is never reached from SQL there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.columnar.column import torch_dtype
from trino_tpu_torch.ops.common import (
    SortKey,
    group_ids_from_sorted,
    multi_key_sort_perm,
    next_pow2,
    segment_reduce,
    segment_sum,
)


@dataclass(frozen=True)
class AggSpec:
    """One SQL aggregate: name in {count, count_star, sum, min, max, avg,
    any_value, stddev_samp, stddev_pop, var_samp, var_pop}, arg = input
    channel (None for count_star)."""

    name: str
    arg: Optional[int]
    out_type: T.Type
    #: proof-licensed |partial sum| bound for decimal sum/avg (planner
    #: range certificate, plan.Aggregation.sum_bound): _sum128 takes the
    #: single-plane i64 path with no runtime fits check when set
    sum_bound: Optional[int] = None
    #: second input channel of a two-input aggregate (covar/corr, map_agg);
    #: none of those is ported yet, so _primitives raises for them
    arg2: Optional[int] = None


#: the moment family: raw-sum states (reference: VarianceState)
MOMENT = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")


def _primitives(spec: AggSpec):
    """Primitive states per SQL aggregate (kinds: sum/count/min/max/any,
    and sum_f/sumsq, the f64 sum and sum of squares of the moments)."""
    if spec.name == "count_star":
        return [("count_star", None)]
    if spec.name == "count":
        return [("count", spec.arg)]
    if spec.name in ("sum", "avg"):
        return [("sum", spec.arg), ("count", spec.arg)]
    if spec.name == "min":
        return [("min", spec.arg), ("count", spec.arg)]
    if spec.name == "max":
        return [("max", spec.arg), ("count", spec.arg)]
    if spec.name == "any_value":
        return [("any", spec.arg), ("count", spec.arg)]
    if spec.name in MOMENT:
        # reference: operator/aggregation VarianceState (count/mean/m2 as
        # merged moments; here the raw-sum formulation merges by addition)
        return [("sum_f", spec.arg), ("sumsq", spec.arg), ("count", spec.arg)]
    raise NotImplementedError(f"aggregate {spec.name}: not ported yet")


def _state_types(spec: AggSpec, input_types) -> list[T.Type]:
    out = []
    for kind, arg in _primitives(spec):
        if kind in ("count", "count_star"):
            out.append(T.BIGINT)
        elif kind in ("sum_f", "sumsq"):
            out.append(T.DOUBLE)
        elif kind == "sum":
            t = input_types[arg]
            if isinstance(t, T.DecimalType):
                # reference: DecimalSumAggregation — Int128 state, exact
                out.append(T.DecimalType(38, t.scale))
            elif t.name in ("double", "real"):
                out.append(T.DOUBLE)
            else:
                out.append(T.BIGINT)
        else:
            out.append(input_types[arg])
    return out


def _merge_primitives(spec: AggSpec):
    """How each state column merges in FINAL/MERGE mode: counts and moment
    sums are already-reduced values and merge by adding."""
    return [
        "sum" if kind in ("count", "count_star", "sum_f", "sumsq") else kind
        for kind, _ in _primitives(spec)
    ]


def _logical_double(d, t: T.Type):
    """Raw device values -> logical float64 (decimal cents get descaled;
    long-decimal limb planes are read as one 128-bit value)."""
    if d.ndim == 2:
        from trino_tpu_torch.types import int128 as i128

        out = i128.to_float128(d[:, 0], d[:, 1])
    else:
        out = d.to(torch.float64)
    if isinstance(t, T.DecimalType) and t.scale:
        out = out / (10.0 ** t.scale)
    return out


def _moment_state(d, t: T.Type, kind: str):
    """The f64 series a moment state sums: the value or its square."""
    dl = _logical_double(d, t)
    return dl * dl if kind == "sumsq" else dl


def _reduce128(d, gid, nseg: int, kind: str, valid):
    """min/max/any over long-decimal limb planes -> [nseg, 2]."""
    from trino_tpu_torch.types import int128 as i128

    if kind in ("min", "max"):
        h, l = i128.segment_minmax128(
            d[:, 0], d[:, 1], gid, nseg, valid, kind == "max"
        )
        return torch.stack([h, l], dim=-1)
    if kind == "any":
        n = d.shape[0]
        idx = torch.arange(n, dtype=torch.int64, device=d.device)
        first = segment_reduce(idx, gid, nseg, "min", valid=valid)
        return d[first.clamp(0, n - 1)]
    raise NotImplementedError(f"long decimal {kind}")


def _sum128(d, gid, nseg: int, valid, in_precision: int = None, sum_bound: int = None):
    """Exact i128 segmented sum -> [nseg, 2] limb planes.  Input is either a
    short scaled-i64 column (1-D, widened) or long planes ([n, 2]).

    Fast paths, strongest proof first:
      * `sum_bound` — a range-certificate license: every partial sum is
        bounded by |s| <= sum_bound < 2**63, so ONE i64 segment sum is
        exact (the high limb is pure sign extension).
      * declared-precision proof — 10**in_precision * rows < 2**63.
      * otherwise a runtime fits probe picks narrow/wide per batch (one
        host read of a device flag; exact either way)."""
    from trino_tpu_torch.types import int128 as i128

    rows = d.shape[0]
    #: per-row magnitude under which `rows` addends provably sum inside i64
    thr = ((1 << 63) - 1) // max(rows, 1)
    proven = (sum_bound is not None and sum_bound < (1 << 63) - 1) or (
        in_precision is not None and (10**in_precision) * rows < (1 << 63)
    )
    if d.ndim == 2:
        h = d[:, 0]
        l = d[:, 1]
        if valid is not None:
            h = torch.where(valid, h, 0)
            l = torch.where(valid, l, 0)
        if proven or bool(
            torch.logical_and(
                h == (l >> 63), torch.logical_and(l < thr, l > -thr)
            ).all()
        ):
            h, l = i128.widen64(segment_sum(l, gid, nseg))
        else:
            hi_direct = (
                in_precision is not None
                and ((10**in_precision >> 64) + 1) * rows < (1 << 62)
            )
            h, l = i128.segment_sum128(h, l, gid, nseg, hi_direct=hi_direct)
    else:
        d = d.to(torch.int64)
        if valid is not None:
            d = torch.where(valid, d, 0)
        if proven or bool(torch.logical_and(d.max() < thr, d.min() > -thr)):
            h, l = i128.widen64(segment_sum(d, gid, nseg))
        else:
            h, l = i128.sum128_widened(d, gid, nseg)
    return torch.stack([h, l], dim=-1)


def _finalize(spec: AggSpec, states: list[Column]) -> Column:
    """Combine state columns into the SQL result column."""
    name = spec.name
    if name in ("count", "count_star"):
        return Column(states[0].data, T.BIGINT, None)
    if name in MOMENT:
        s, sq, cnt = states[0].data, states[1].data, states[2].data
        n = cnt.to(torch.float64)
        m2 = sq - torch.where(cnt > 0, s * s / n.clamp(min=1.0), 0.0)
        m2 = m2.clamp(min=0.0)  # guard tiny negative rounding residue
        if name in ("var_pop", "stddev_pop"):
            var = m2 / n.clamp(min=1.0)
            valid = cnt > 0
        else:
            var = m2 / (n - 1.0).clamp(min=1.0)
            valid = cnt > 1
        out = torch.sqrt(var) if name.startswith("stddev") else var
        return Column(out, T.DOUBLE, valid)
    value, cnt = states[0], states[1]
    nonempty = cnt.data > 0
    out_dt = torch_dtype(spec.out_type.np_dtype)
    if name == "avg":
        if isinstance(spec.out_type, T.DecimalType) and value.data.ndim == 2:
            # Int128 sum state / count (reference: DecimalAverageAggregation):
            # exact limb division by the data-dependent count, rounded half
            # away from zero
            from trino_tpu_torch.types import int128 as i128

            h = value.data[:, 0]
            l = value.data[:, 1]
            den = torch.where(nonempty, cnt.data, 1)
            qh, ql, r = i128.divmod128_by_vec(h, l, den)
            half = torch.where(2 * r.abs() >= den, 1, 0)
            bump = torch.where(h < 0, -half, half)
            qh2, ql2 = i128.add128(qh, ql, bump >> 63, bump)
            if spec.out_type.is_long:
                data = torch.stack([qh2, ql2], dim=-1)
            else:
                data = ql2  # avg of a short input fits the short result
        elif isinstance(spec.out_type, T.DecimalType):
            num = value.data
            den = torch.where(nonempty, cnt.data, 1)
            q = num.abs() // den
            r = num.abs() - q * den
            data = torch.sign(num) * (q + torch.where(2 * r >= den, 1, 0))
        else:
            data = value.data.to(torch.float64) / torch.where(nonempty, cnt.data, 1)
        return Column(data.to(out_dt), spec.out_type, nonempty)
    # sum/min/max/any_value
    data = value.data
    if data.ndim == 2 and isinstance(spec.out_type, T.DecimalType):
        if not spec.out_type.is_long:
            # caller declared a short result: the low limb carries it
            data = data[:, 1]
        elif (
            isinstance(value.type, T.DecimalType)
            and value.type.scale != spec.out_type.scale
        ):
            from trino_tpu_torch.types import int128 as i128

            h, l = i128.rescale128(
                data[:, 0], data[:, 1], value.type.scale, spec.out_type.scale
            )
            data = torch.stack([h, l], dim=-1)
    return Column(data.to(out_dt), spec.out_type, nonempty, states[0].dictionary)


def _masked_reduce(data, valid, kind: str):
    """Whole-column null-skipping reduction to a 1-element tensor (global
    aggregation)."""
    zeros = torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
    if kind in ("count", "count_star"):
        return valid.sum(dtype=torch.int64)[None]
    return segment_reduce(data, zeros, 1, kind, valid=valid)


def _pad_device(batch: Batch, cap: int) -> Batch:
    """Pad to a larger capacity with dead rows."""
    n = batch.capacity
    if n == cap:
        return batch
    pad = cap - n
    dev = batch.device
    cols = []
    for c in batch.columns:
        zeros = torch.zeros(
            (pad,) + tuple(c.data.shape[1:]), dtype=c.data.dtype, device=dev
        )
        valid = None
        if c.valid is not None:
            valid = torch.cat([c.valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
        cols.append(Column(torch.cat([c.data, zeros]), c.type, valid, c.dictionary))
    mask = torch.cat([batch.mask(), torch.zeros(pad, dtype=torch.bool, device=dev)])
    return Batch(cols, mask)


class MarkDistinctOperator:
    """Appends a boolean column that is TRUE on the first live occurrence of
    each distinct key combination (reference: operator/MarkDistinctOperator
    .java + MarkDistinctHash).  A stable multi-key sort and key-change
    flags scattered back to row order, over the whole input at once."""

    def __init__(self, key_channels: Sequence[int]):
        self.key_channels = list(key_channels)

    def mark_step(self, batch: Batch) -> Batch:
        perm = multi_key_sort_perm(batch, [SortKey(ch) for ch in self.key_channels])
        _, _, new_group = group_ids_from_sorted(batch, perm, self.key_channels)
        mark = torch.empty_like(new_group)
        mark[perm] = new_group
        return Batch(list(batch.columns) + [Column(mark, T.BOOLEAN, None)], batch.row_mask)

    def process(self, stream):
        acc = list(stream)
        if not acc:
            return
        big = acc[0] if len(acc) == 1 else concat_batches(acc)
        yield self.mark_step(_pad_device(big, next_pow2(big.capacity, floor=1)))


class AggregationOperator:
    def __init__(
        self,
        group_channels: Sequence[int],
        aggregates: Sequence[AggSpec],
        input_types: Sequence[T.Type],
        device: torch.device,
        mode: str = "single",  # single | partial | final | merge
        fold_every: Optional[int] = None,
        use_pallas: bool = False,
        pre_step=None,
    ):
        if mode not in ("single", "partial", "final", "merge"):
            raise ValueError(f"aggregation mode: {mode}")
        self.group_channels = list(group_channels)
        self.aggregates = list(aggregates)
        self.input_types = list(input_types)
        self.device = device
        self.mode = mode
        self.fold_every = fold_every if fold_every is not None else self.FOLD_EVERY
        #: the `pallas_agg` knob: eligible direct-path float aggregations
        #: reduce through the grouped-sums kernel (ops/grouped_sums.py), in
        #: float32, so only DOUBLE/REAL sums + counts qualify
        self.use_pallas = use_pallas
        #: fused upstream projection, applied by push() so projection outputs
        #: (e.g. decimal products) feed the reduction of the same batch
        #: directly, never queued between operators
        self._pre = pre_step
        self._acc: list[Batch] = []
        self._per_batch: Optional["AggregationOperator"] = None

    # -- the per-batch reduction ----------------------------------------------

    #: group-domain cap for the sort-free direct path (positional segments)
    DIRECT_GROUP_LIMIT = 4096

    #: the one-hot GEMM is the accelerator formulation; CPU tensors take the
    #: segmented scatter-adds unless a test forces it
    force_matmul = False

    def _direct_group_info(self, batch: Batch):
        """(sizes, prod) when every group key is a small-domain code column
        (dictionary or boolean) — the BigintGroupByHash analog: group id is
        the mixed-radix code index, no sort needed."""
        sizes = []
        for ch in self.group_channels:
            c = batch.columns[ch]
            if c.dictionary is not None:
                n = len(c.dictionary.values)
            elif c.type is T.BOOLEAN:
                n = 2
            else:
                return None
            sizes.append(n + 1)  # one extra slot for NULL
        prod = 1
        for s in sizes:
            prod *= s
        if not 0 < prod <= self.DIRECT_GROUP_LIMIT:
            return None
        return sizes, prod

    def _direct_reduce(self, batch: Batch, sizes, prod: int) -> Batch:
        dev = batch.device
        cap = batch.capacity
        live = batch.mask()
        gid = torch.zeros(cap, dtype=torch.int64, device=dev)
        for ch, size in zip(self.group_channels, sizes):
            c = batch.columns[ch]
            code = c.data.to(torch.int64)
            if c.valid is not None:
                code = torch.where(c.valid, code, size - 1)
            gid = gid * size + code.clamp(0, size - 1)
        gid = torch.where(live, gid, prod)
        nseg = prod + 1
        occupancy = segment_sum(live.to(torch.int64), gid, nseg)[:prod]
        out_live = occupancy > 0
        # decode positional slot -> group key codes
        idx = torch.arange(prod, dtype=torch.int64, device=dev)
        divs = []
        d = 1
        for size in reversed(sizes):
            divs.append(d)
            d *= size
        divs.reverse()
        cols: list[Column] = []
        for ch, size, div in zip(self.group_channels, sizes, divs):
            c = batch.columns[ch]
            code = (idx // div) % size
            valid = None if c.valid is None else code < (size - 1)
            cols.append(Column(code.to(c.data.dtype), c.type, valid, c.dictionary))
        if self.use_pallas and self.mode in ("single", "partial"):
            kernel_cols = self._pallas_direct_sums(batch, live, gid, prod)
            if kernel_cols is not None:
                return Batch(cols + kernel_cols, out_live)
        matmul_states = self._matmul_direct_sums(batch, live, gid, prod)
        if matmul_states is not None:
            for spec, state_cols in zip(self.aggregates, matmul_states):
                if self.mode == "partial":
                    cols.extend(state_cols)
                else:
                    cols.append(_finalize(spec, state_cols))
            return Batch(cols, out_live)
        perm = torch.arange(cap, dtype=torch.int64, device=dev)
        for spec in self.aggregates:
            state_cols = self._reduce_one(batch, spec, perm, live, gid, nseg, prod)
            if self.mode in ("partial", "merge"):
                cols.extend(state_cols)
            else:
                cols.append(_finalize(spec, state_cols))
        return Batch(cols, out_live)

    #: one-hot matmul path bounds: groups (one-hot width) and rows (chunk
    #: sums must stay exact in f64: 2**32 chunks * 2**21 rows = 2**53)
    MATMUL_GROUP_LIMIT = 32
    MATMUL_ROW_LIMIT = 1 << 21

    def _matmul_direct_sums(self, batch: Batch, live, gid, prod: int):
        """EXACT one-hot matmul aggregation (the default on the card): every
        sum/count reduces in ONE f64 product — [cap, G] one-hot against a
        [cap, K] plane matrix.  Integer inputs split into 32-bit chunk
        planes; each chunk sum < 2**32 * 2**21 = 2**53 is exact in f64, and
        the chunks recombine into i64/i128 with carries.  Returns per-spec
        primitive STATE columns (same layout as _reduce_one) or None when
        ineligible."""
        cap = batch.capacity
        if prod > self.MATMUL_GROUP_LIMIT or cap > self.MATMUL_ROW_LIMIT:
            return None
        if self.mode not in ("single", "partial") or not self.aggregates:
            return None
        if batch.device.type == "cpu" and not self.force_matmul:
            return None
        for spec in self.aggregates:
            if spec.name not in ("sum", "avg", "count", "count_star"):
                return None
            if spec.name in ("sum", "avg"):
                t = self.input_types[spec.arg]
                if not (
                    isinstance(t, T.DecimalType)
                    or t.name
                    in ("tinyint", "smallint", "integer", "bigint", "double", "real")
                ):
                    return None

        m32 = 0xFFFFFFFF
        f64 = torch.float64
        planes = []  # f64 [cap] tensors
        plan = []  # per spec: list of (prim_kind, chunk_layout, plane_idx..)

        def _valid_plane(col):
            if col.valid is None:
                return live
            return torch.logical_and(live, col.valid)

        for spec in self.aggregates:
            prims = []
            if spec.name == "count_star":
                prims.append(("count", "count", (len(planes),)))
                planes.append(live.to(f64))
            elif spec.name == "count":
                v = _valid_plane(batch.columns[spec.arg])
                prims.append(("count", "count", (len(planes),)))
                planes.append(v.to(f64))
            else:  # sum / avg -> (sum, count) primitive states
                col = batch.columns[spec.arg]
                v = _valid_plane(col)
                t = self.input_types[spec.arg]
                st = _state_types(spec, self.input_types)[0]
                i0 = len(planes)
                if t.name in ("double", "real"):
                    planes.append(torch.where(v, col.data.to(f64), 0.0))
                    prims.append(("sum", "f64", (i0,)))
                elif col.data.ndim == 2:  # long decimal input
                    h = torch.where(v, col.data[:, 0], 0)
                    l = torch.where(v, col.data[:, 1], 0)
                    planes.extend(
                        [
                            (l & m32).to(f64),
                            ((l >> 32) & m32).to(f64),
                            (h & m32).to(f64),
                            (h >> 32).to(f64),
                        ]
                    )
                    prims.append(("sum", "i128", (i0, i0 + 1, i0 + 2, i0 + 3)))
                else:
                    d = torch.where(v, col.data.to(torch.int64), 0)
                    planes.extend([(d & m32).to(f64), (d >> 32).to(f64)])
                    kind = (
                        "i128"
                        if isinstance(st, T.DecimalType) and st.is_long
                        else "i64"
                    )
                    prims.append(("sum", kind + "_2", (i0, i0 + 1)))
                prims.append(("count", "count", (len(planes),)))
                planes.append(v.to(f64))
            plan.append((spec, prims))

        groups = torch.arange(prod, dtype=gid.dtype, device=gid.device)
        onehot = torch.logical_and(gid[:, None] == groups[None, :], live[:, None])
        values = torch.stack(planes, dim=1)  # [cap, K]
        S = torch.matmul(onehot.to(f64).T, values)  # ONE product: [G, K]

        from trino_tpu_torch.types import int128 as i128

        def s64(i):
            return S[:, i].to(torch.int64)

        out_states: list = []
        for spec, prims in plan:
            state_cols = []
            sts = _state_types(spec, self.input_types)
            for (kind, layout, idx), st in zip(prims, sts):
                if layout == "count":
                    state_cols.append(Column(s64(idx[0]), T.BIGINT))
                elif layout == "f64":
                    state_cols.append(Column(S[:, idx[0]].contiguous(), st))
                elif layout == "i64_2":
                    state_cols.append(Column((s64(idx[1]) << 32) + s64(idx[0]), st))
                elif layout == "i128_2":
                    hi, lo = i128.recombine2(s64(idx[0]), s64(idx[1]))
                    state_cols.append(Column(torch.stack([hi, lo], dim=-1), st))
                else:  # i128 (4 chunk planes)
                    hi, lo = i128.recombine4(*(s64(i) for i in idx))
                    state_cols.append(Column(torch.stack([hi, lo], dim=-1), st))
            out_states.append(state_cols)
        return out_states

    #: grouped-sums kernel gate: group domain, and rows (f32 counts stay
    #: exact only below 2**24 increments)
    KERNEL_GROUP_LIMIT = 512
    KERNEL_ROW_LIMIT = 1 << 24

    def _pallas_direct_sums(self, batch: Batch, live, gid, prod: int):
        """The `pallas_agg` fast path through the grouped-sums kernel when
        every aggregate is a DOUBLE/REAL sum/avg or a count.  SINGLE mode
        returns finalized columns; PARTIAL mode returns the primitive state
        columns (f64 sum + i64 count per sum/avg, i64 count per count).
        None when ineligible."""
        for spec in self.aggregates:
            if spec.name in ("count_star", "count"):
                continue
            if spec.name in ("sum", "avg") and spec.arg is not None:
                if self.input_types[spec.arg].name in ("double", "real"):
                    continue
            return None
        cap = batch.capacity
        if prod > self.KERNEL_GROUP_LIMIT or cap > self.KERNEL_ROW_LIMIT:
            return None
        from trino_tpu_torch.ops.grouped_sums import grouped_sums

        dev = batch.device
        ones = torch.ones(cap, dtype=torch.float32, device=dev)
        mats = []  # f32 [cap] value columns
        plan = []  # (spec, kind, column indices into mats)
        ones_col = None
        for spec in self.aggregates:
            if spec.name == "count_star":
                if ones_col is None:
                    ones_col = len(mats)
                    mats.append(ones)
                plan.append((spec, "count", (ones_col,)))
                continue
            c = batch.columns[spec.arg]
            data = c.data.to(torch.float32)
            if c.valid is not None:
                data = torch.where(c.valid, data, 0.0)
            cnt_col = len(mats)
            mats.append(ones if c.valid is None else c.valid.to(torch.float32))
            if spec.name == "count":
                plan.append((spec, "count", (cnt_col,)))
                continue
            plan.append((spec, spec.name, (len(mats), cnt_col)))
            mats.append(data)
        sums = grouped_sums(
            gid.to(torch.int32), live, torch.stack(mats, dim=1), n_groups=prod
        )  # [prod, len(mats)]
        out = []
        for spec, kind, idx in plan:
            count = sums[:, idx[-1]].to(torch.int64)
            if kind == "count":
                out.append(Column(count, T.BIGINT))
                continue
            total = sums[:, idx[0]].to(torch.float64)
            if self.mode == "partial":
                out.extend([Column(total, T.DOUBLE), Column(count, T.BIGINT)])
            elif kind == "sum":
                out.append(Column(total, spec.out_type, count > 0))
            else:  # avg
                out.append(
                    Column(
                        (sums[:, idx[0]] / sums[:, idx[1]].clamp(min=1.0)).to(
                            torch.float64
                        ),
                        spec.out_type,
                        count > 0,
                    )
                )
        return out

    def _reduce_full(self, big: Batch) -> Batch:
        """One-shot reduction of a batch: compact away dead slack first,
        then reduce."""
        n = big.num_rows_host()
        cap = next_pow2(max(n, 1), floor=1)
        if cap < big.capacity:
            big = big.compact_device(out_capacity=cap)
        else:
            cap = next_pow2(big.capacity, floor=1)
            big = _pad_device(big, cap)
        return self._reduce_step(big, out_cap=cap)

    def _reduce_step(self, batch: Batch, out_cap: int) -> Batch:
        gch = self.group_channels
        if not gch:
            return self._global_reduce(batch)
        direct = self._direct_group_info(batch)
        if direct is not None:
            return self._direct_reduce(batch, *direct)
        perm = multi_key_sort_perm(batch, [SortKey(ch) for ch in gch])
        gid, ngroups, new_group = group_ids_from_sorted(batch, perm, gch)
        live = batch.mask()[perm]
        gid_c = gid.clamp(max=out_cap)
        nseg = out_cap + 1
        dev = batch.device
        out_live = torch.arange(out_cap, dtype=torch.int64, device=dev) < ngroups
        cols: list[Column] = []
        # group key columns: value at each group's first row
        first_idx = torch.where(new_group, gid_c, out_cap)
        for ch in gch:
            col = batch.columns[ch]
            d = col.data[perm]
            key_out = torch.zeros(
                (nseg,) + tuple(d.shape[1:]), dtype=col.data.dtype, device=dev
            )
            key_out[first_idx] = d
            valid = None
            if col.valid is not None:
                valid = torch.zeros(nseg, dtype=torch.bool, device=dev)
                valid[first_idx] = col.valid[perm]
                valid = valid[:out_cap]
            cols.append(Column(key_out[:out_cap], col.type, valid, col.dictionary))
        for spec in self.aggregates:
            state_cols = self._reduce_one(batch, spec, perm, live, gid_c, nseg, out_cap)
            if self.mode in ("partial", "merge"):
                cols.extend(state_cols)
            else:
                cols.append(_finalize(spec, state_cols))
        return Batch(cols, out_live)

    def _reduce_one(self, batch, spec, perm, live, gid, nseg, out_cap):
        if self.mode in ("final", "merge"):
            # state columns arrive as consecutive input channels from arg
            state_cols = []
            ch = spec.arg
            for kind in _merge_primitives(spec):
                col = batch.columns[ch]
                d = col.data[perm]
                v = live if col.valid is None else torch.logical_and(live, col.valid[perm])
                ch += 1
                if kind == "sum" and isinstance(col.type, T.DecimalType) and col.type.is_long:
                    # merging Int128 partial-sum states
                    red2 = _sum128(d, gid, nseg, v, sum_bound=spec.sum_bound)
                    state_cols.append(Column(red2[:out_cap], col.type, None))
                elif d.ndim == 2 and isinstance(col.type, T.DecimalType) and kind in ("min", "max", "any"):
                    red2 = _reduce128(d, gid, nseg, kind, v)[:out_cap]
                    state_cols.append(Column(red2, col.type, None))
                else:
                    red = segment_reduce(d, gid, nseg, kind, valid=v)[:out_cap]
                    state_cols.append(Column(red, col.type, None, col.dictionary))
            return state_cols
        out = []
        sts = _state_types(spec, self.input_types)
        for (kind, arg), st in zip(_primitives(spec), sts):
            if kind == "count_star":
                ones = torch.ones(batch.capacity, dtype=torch.int64, device=batch.device)
                red = segment_reduce(ones, gid, nseg, "count", valid=live)[:out_cap]
                out.append(Column(red, T.BIGINT, None))
                continue
            col = batch.columns[arg]
            d = col.data[perm]
            v = live if col.valid is None else torch.logical_and(live, col.valid[perm])
            if kind in ("sum_f", "sumsq"):
                dl = _moment_state(d, col.type, kind)
                red = segment_reduce(dl, gid, nseg, "sum", valid=v)[:out_cap]
                out.append(Column(red, T.DOUBLE, None))
                continue
            if kind == "sum" and isinstance(st, T.DecimalType) and st.is_long:
                prec = col.type.precision if isinstance(col.type, T.DecimalType) else None
                red2 = _sum128(
                    d, gid, nseg, v, in_precision=prec, sum_bound=spec.sum_bound
                )[:out_cap]
                out.append(Column(red2, st, None))
                continue
            if d.ndim == 2 and isinstance(col.type, T.DecimalType) and kind in ("min", "max", "any"):
                out.append(Column(_reduce128(d, gid, nseg, kind, v)[:out_cap], st, None))
                continue
            if kind == "sum":
                # widen BEFORE reducing: int32 inputs accumulate in int64
                d = d.to(torch_dtype(st.np_dtype))
            red = segment_reduce(d, gid, nseg, kind, valid=v)[:out_cap]
            out.append(
                Column(red.to(torch_dtype(st.np_dtype)), st, None, col.dictionary)
            )
        return out

    def _global_reduce(self, batch: Batch) -> Batch:
        """No group keys: one output row (present even for empty input)."""
        live = batch.mask()
        gid0 = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
        cols = []
        for spec in self.aggregates:
            states = []
            if self.mode in ("final", "merge"):
                ch = spec.arg
                for kind in _merge_primitives(spec):
                    col = batch.columns[ch]
                    v = live if col.valid is None else torch.logical_and(live, col.valid)
                    ch += 1
                    if kind == "sum" and isinstance(col.type, T.DecimalType) and col.type.is_long:
                        red = _sum128(col.data, gid0, 1, v, sum_bound=spec.sum_bound)
                    elif col.data.ndim == 2 and isinstance(col.type, T.DecimalType) and kind in ("min", "max", "any"):
                        red = _reduce128(col.data, gid0, 1, kind, v)
                    else:
                        red = _masked_reduce(col.data, v, kind)
                    states.append(Column(red, col.type, None, col.dictionary))
            else:
                sts = _state_types(spec, self.input_types)
                for (kind, arg), st in zip(_primitives(spec), sts):
                    if kind == "count_star":
                        states.append(Column(live.sum(dtype=torch.int64)[None], T.BIGINT))
                        continue
                    col = batch.columns[arg]
                    v = live if col.valid is None else torch.logical_and(live, col.valid)
                    d = col.data
                    if kind in ("sum_f", "sumsq"):
                        red = _masked_reduce(_moment_state(d, col.type, kind), v, "sum")
                        states.append(Column(red, T.DOUBLE, None))
                        continue
                    if kind == "sum" and isinstance(st, T.DecimalType) and st.is_long:
                        prec = (
                            col.type.precision
                            if isinstance(col.type, T.DecimalType)
                            else None
                        )
                        red = _sum128(
                            d, gid0, 1, v, in_precision=prec, sum_bound=spec.sum_bound
                        )
                        states.append(Column(red, st, None))
                        continue
                    if d.ndim == 2 and isinstance(col.type, T.DecimalType) and kind in ("min", "max", "any"):
                        states.append(Column(_reduce128(d, gid0, 1, kind, v), st, None))
                        continue
                    if kind == "sum":
                        d = d.to(torch_dtype(st.np_dtype))  # widen before reducing
                    red = _masked_reduce(d, v, kind).to(torch_dtype(st.np_dtype))
                    states.append(Column(red, st, None, col.dictionary))
            if self.mode in ("partial", "merge"):
                cols.extend(states)
            else:
                cols.append(_finalize(spec, states))
        return Batch(cols, torch.ones(1, dtype=torch.bool, device=batch.device))

    # -- host-side streaming -------------------------------------------------

    def _batch_reducer(self) -> "AggregationOperator":
        """Per-batch operator for streaming: raw rows -> states, or (when this
        op's input is already states) states -> states.  Passes `use_pallas`
        on, so the knob reaches the kernel on the streaming path."""
        per_mode = "merge" if self.mode in ("final", "merge") else "partial"
        return AggregationOperator(
            self.group_channels,
            self.aggregates,
            self.input_types,
            self.device,
            mode=per_mode,
            use_pallas=self.use_pallas,
        )

    #: fold accumulated per-batch states after this many batches (bounds
    #: device memory at ~FOLD_EVERY batch capacities)
    FOLD_EVERY = 8

    def reduce_batch(self, batch: Batch) -> Batch:
        """One (projected) input batch -> its partial-state batch.  Dict/bool
        small-domain keys take the direct path on the batch as it is (no
        host sync, the Q1 shape); otherwise the batch is compacted and
        sort-reduced."""
        if self._per_batch is None:
            self._per_batch = self._batch_reducer()
        per_batch = self._per_batch
        if per_batch._direct_group_info(batch) is not None:
            return per_batch._reduce_step(batch, out_cap=batch.capacity)
        return per_batch._reduce_full(batch)

    def push(self, batch: Batch) -> None:
        """Reduce one input batch to its group states and keep those."""
        if self._pre is not None:
            batch = self._pre(batch)
        self._acc.append(self.reduce_batch(batch))
        if len(self._acc) >= self.fold_every:
            self._fold_states()

    def process(self, stream):
        for batch in stream:
            self.push(batch)
        yield self.finish()

    def _fold_states(self) -> None:
        """Merge accumulated state batches into one, compacted to live size."""
        merged = self._combine(concat_batches(self._acc), "merge")
        n = merged.num_rows_host()
        self._acc = [merged.compact_device(next_pow2(max(n, 1), floor=1))]

    def finish(self) -> Batch:
        if not self._acc:
            # no input: reduce one dead row of the post-projection layout
            return self._reduce_step(self._empty_input(), out_cap=1)
        big = self._acc[0] if len(self._acc) == 1 else concat_batches(self._acc)
        out_mode = "merge" if self.mode in ("partial", "merge") else "final"
        return self._combine(big, out_mode)

    def _combine(self, states_batch: Batch, out_mode: str) -> Batch:
        """Re-reduce a batch of state rows (group keys + state columns)."""
        merger = AggregationOperator(
            list(range(len(self.group_channels))),
            [
                AggSpec(s.name, self._state_channel(i), s.out_type, s.sum_bound)
                for i, s in enumerate(self.aggregates)
            ],
            [c.type for c in states_batch.columns],
            self.device,
            mode=out_mode,
        )
        return merger._reduce_full(states_batch)

    def _state_channel(self, agg_index: int) -> int:
        ch = len(self.group_channels)
        for s in self.aggregates[:agg_index]:
            ch += len(_primitives(s))
        return ch

    def _empty_input(self) -> Batch:
        cols = [
            Column.from_numpy(
                np.zeros(1, dtype=t.np_dtype), t, np.zeros(1, dtype=bool),
                device=self.device,
            )
            for t in self.input_types
        ]
        return Batch(cols, torch.zeros(1, dtype=torch.bool, device=self.device))

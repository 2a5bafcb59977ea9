"""Aggregation operator — grouped reduction on the device.

Port of trino_tpu/ops/aggregation.py (reference roles:
HashAggregationOperator.java:49, AggregationOperator (global),
MultiChannelGroupByHash.java:216).  Group ids come from one of three
paths (below): two sort-free slot codes and a stable multi-key sort;
accumulators are segmented reductions.

Modes mirror the reference's AggregationNode.Step:
  SINGLE  : raw rows -> final values
  PARTIAL : raw rows -> state columns (for exchange)
  FINAL   : state columns -> final values
  MERGE   : state columns -> state columns

A streaming operator reduces every pushed batch immediately and keeps
only the per-batch group states (the TPC-H Q1 shape), folding them every
`fold_every` batches.  With a memory context it reserves its accumulated
states after every batch; over budget it folds first and raises only when
the folded states still do not fit (runtime/local_planner.py then runs the
aggregation in waves).  The collect aggregates have no mergeable partial
state, so an operator that holds one (`streaming` is False) keeps its
raw input batches and reduces them once, at the end.

Ported aggregates: count(*), count, sum, avg, min, max, any_value,
bool_and/bool_or (min/max over the boolean), the moment family
(stddev_samp, stddev_pop, var_samp, var_pop: f64 sum, sum of squares and
count states, merged by addition), the bivariate family (covar_samp,
covar_pop, corr, regr_slope, regr_intercept: the raw-sum sextuple, merged by
addition, rows with either side NULL skipped), checksum (a wrapping int64
sum of 64-bit value hashes, merged by addition), global approx_distinct
(a HyperLogLog sketch of HLL_M int32 registers, an array-typed state merged
by elementwise max), the collect aggregates array_agg (with ORDER BY),
map_agg and listagg (eager, sort-based group numbering; the padded width K
is the largest group, one host read), the global approx_percentile (a
qdigest state of NBUCKETS int64 counts, ops/qdigest.py, an array-typed
state merged by addition), the exact grouped percentile (a re-sort by
group keys and value, the nearest-rank row), min_by/max_by and their n
form (the value at each group's extreme key; an array of the n extreme
keys' values), and MarkDistinctOperator (the mark column of mixed DISTINCT
sets).  The holistic aggregates (percentile, min_by, max_by and the
collect family) run single-stage only, over the sorted group numbering.

Group ids, by path (GROUP_PATHS counts each grouped reduction's):
  direct     dictionary/boolean keys with a small code domain;
  positional integer-family keys whose live (min, max) range is dense
             enough: the mixed-radix offset code, one host read of the key
             statistics (the JAX package's range-positional path);
  sorted     everything else: a stable multi-key sort.

Difference from the JAX package: the `pallas_agg` knob reaches the
grouped-sums kernel (ops/grouped_sums.py) from the streaming per-batch
reducer too — `_batch_reducer` passes `use_pallas` on and
`_pallas_direct_sums` serves PARTIAL mode by returning the primitive state
columns.  In the JAX package the streaming reducer drops the knob, so the
kernel is never reached from SQL there.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.columnar.column import take_table, torch_dtype
from trino_tpu_torch.ops.common import (
    SortKey,
    _i64_const,
    _segment_extreme,
    _shr_logical,
    group_ids_from_sorted,
    multi_key_sort_perm,
    next_pow2,
    require_scalar_key,
    segment_reduce,
    segment_sum,
    splitmix64,
)
from trino_tpu_torch.planner.functions import HOLISTIC_AGGS


@dataclass(frozen=True)
class AggSpec:
    """One SQL aggregate: name in {count, count_star, sum, min, max, avg,
    any_value, bool_and, bool_or, stddev_samp, stddev_pop, var_samp,
    var_pop, covar_samp, covar_pop, corr, regr_slope, regr_intercept,
    checksum, approx_distinct, approx_percentile, percentile, min_by,
    max_by, array_agg, map_agg, listagg}, arg = input channel (None for
    count_star)."""

    name: str
    arg: Optional[int]
    out_type: T.Type
    #: proof-licensed |partial sum| bound for decimal sum/avg (planner
    #: range certificate, plan.Aggregation.sum_bound): _sum128 takes the
    #: single-plane i64 path with no runtime fits check when set
    sum_bound: Optional[int] = None
    #: second input channel of a two-input aggregate: the x of the
    #: bivariate family, map_agg's values, the ORDER BY key of array_agg and
    #: listagg
    arg2: Optional[int] = None
    #: literal parameter: the percentile fraction; min_by/max_by's n;
    #: array_agg's ORDER BY (ascending, nulls_first); listagg's
    #: (separator, ascending, nulls_first)
    param: object = None


#: the collect subset of the holistic aggregates (padded-array group state)
COLLECT_AGGS = ("array_agg", "map_agg", "listagg")

#: the latest data-dependent widths collect aggregates took, one entry
#: (aggregate, group slots, K) per host read (read and cleared by callers
#: that count them; bounded, so a long-lived process does not grow it)
COLLECT_LOG: deque = deque(maxlen=4096)

#: the moment family: raw-sum states (reference: VarianceState)
MOMENT = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")

#: two-input (y, x) regression family: the state is the raw-sum sextuple
BIVARIATE = ("covar_samp", "covar_pop", "corr", "regr_slope", "regr_intercept")

#: checksum's NULL-row contribution (the reference's PRIME64 role), as the
#: int64 with its bits
CHECKSUM_NULL_PRIME = _i64_const(0x9E3779B185EBCA87)

#: HyperLogLog registers per sketch: p=13 -> 8192 buckets, standard error
#: 1.04/sqrt(8192) ~= 1.15% (reference: ApproximateCountDistinctAggregation
#: defaults + state/HyperLogLogStateFactory.java:23)
HLL_P = 13
HLL_M = 1 << HLL_P

#: the group path each grouped reduction took (direct | positional |
#: sorted), one count per reduction; read and cleared by callers
GROUP_PATHS: dict = {}


def _note_group_path(path: str) -> None:
    GROUP_PATHS[path] = GROUP_PATHS.get(path, 0) + 1


def _scalar_arg(col: Column, name: str) -> None:
    """Raise for an array or map argument where the aggregate reads values
    (count reads only validity).  The JAX package has no such path either:
    it fails on the shape, or reduces the padded slots as if they were rows."""
    if col.lengths is not None:
        raise NotImplementedError(f"{name} over an {col.type.name} column")


def _minmax_by_args(spec, vcol: Column, kcol: Column, n_form: bool) -> None:
    """Raise for the min_by/max_by arguments the JAX package reads wrongly
    (limb planes as two keys, padded slots as rows): an array or map value
    or key, a long-decimal key, and a long-decimal value of the n form."""
    _scalar_arg(vcol, spec.name)
    _scalar_arg(kcol, spec.name)
    if kcol.data.ndim > 1:
        raise NotImplementedError(f"{spec.name} over a long-decimal key")
    if n_form and vcol.data.ndim > 1:
        raise NotImplementedError(f"{spec.name}(value, key, n) over a long-decimal value")


def _group_ranks(varg, gid_c, cap: int, nseg: int):
    """(pos_in_group, counts) of the collect scatters: the 0-based rank of
    each kept row (varg) within its group in sorted order, and each group's
    kept-row count."""
    rank_incl = torch.cumsum(varg.to(torch.int64), 0)
    base = segment_reduce(
        torch.where(varg, rank_incl - 1, cap + 1), gid_c, nseg, "min"
    )
    pos_in_group = rank_incl - 1 - base[gid_c.clamp(0, nseg - 1)]
    counts = segment_sum(varg.to(torch.int64), gid_c, nseg)
    return pos_in_group, counts


# -- the value hash of checksum and approx_distinct ---------------------------
#
# Both packages must give the same 64-bit hash for the same value, bit for
# bit, or checksums and estimates differ.  uint64 arithmetic runs on int64
# tensors (multiplies wrap alike, right shifts are made logical).

#: smallest normal float64 and float32: the JAX package's float hash runs
#: under XLA with denormals flushed to zero, so a subnormal hashes as 0.0
_F64_TINY = 2.2250738585072014e-308
_F32_TINY = 1.1754943508222875e-38

#: device -> (exp2, lo, hi) tables of the double hash
_DOUBLE_HASH_TABLES: dict = {}
_DOUBLE_HASH_HOST: list = []


def _double_hash_host_tables():
    """(exp2, lo, hi) host tables that reproduce the JAX package's float
    decomposition exactly, computed once per process in decimal arithmetic
    (~0.3 s).

    The JAX package computes expo = floor(log(a) / log(2)) and mant =
    a * exp2(-expo) under XLA, whose f64 log is correctly rounded, which
    folds the division by the constant log(2) into a multiplication by
    fl(1 / fl(ln 2)), and whose exp2(x) is exp(fl(ln2 * x)), correctly
    rounded at integer x with subnormal results flushed to zero.  So:
      exp2[k + 1023] is that exp2(k) for integer k in [-1023, 1023];
      lo[e + 1022] counts the mantissas just above 2**e (fraction bits
      0, 1, ...) whose quotient rounds below e, and hi[e + 1022] those just
      below 2**(e + 1) whose quotient rounds up to e + 1, for every normal
      binary exponent e (the floor is monotone in the value, so each set is
      a run at the edge of the binade)."""
    if _DOUBLE_HASH_HOST:
        return _DOUBLE_HASH_HOST[0]
    import math
    from decimal import Context, Decimal

    ctx = Context(prec=80)
    ln2 = math.log(2.0)
    exp2 = np.empty(2047, dtype=np.float64)
    for k in range(-1023, 1024):
        v = float(ctx.exp(Decimal(ln2 * k)))
        exp2[k + 1023] = 0.0 if v < _F64_TINY else v

    ln2_exact = ctx.ln(Decimal(2))
    inv_ln2 = 1.0 / ln2
    ulp = Decimal(2) ** -52

    def edge(e: int) -> Decimal:
        """D = m - e*ln(2), m the midpoint below the smallest double x with
        fl(x * fl(1 / fl(ln 2))) >= e: the quotient of fl(ln a) reaches e
        exactly when ln(a) > m (a transcendental ln never equals the
        midpoint)"""
        x = e * ln2
        while x * inv_ln2 >= e:
            x = math.nextafter(x, -math.inf)
        while x * inv_ln2 < e:
            x = math.nextafter(x, math.inf)
        mid = (Decimal(math.nextafter(x, -math.inf)) + Decimal(x)) / 2
        return ctx.subtract(mid, ctx.multiply(Decimal(e), ln2_exact))

    lo = np.zeros(2046, dtype=np.int64)
    hi = np.zeros(2046, dtype=np.int64)
    for e in range(-1022, 1024):
        # lo: the j >= 0 with ln(1 + j*ulp) < edge(e), below e
        g = ctx.exp(edge(e)) - 1
        lo[e + 1022] = 0 if g <= 0 else int(ctx.divide_int(g, ulp)) + 1
        # hi: the j >= 1 with ln(1 - j*ulp/2) > edge(e + 1), up to e + 1
        g = 1 - ctx.exp(edge(e + 1))
        hi[e + 1022] = 0 if g <= 0 else int(ctx.divide_int(2 * g, ulp))
    _DOUBLE_HASH_HOST.append((exp2, lo, hi))
    return exp2, lo, hi


def _double_hash_tables(device: torch.device):
    tables = _DOUBLE_HASH_TABLES.get(device)
    if tables is None:
        tables = tuple(torch.from_numpy(t).to(device) for t in _double_hash_host_tables())
        _DOUBLE_HASH_TABLES[device] = tables
    return tables


def _double_hash_words(d: torch.Tensor) -> torch.Tensor:
    """The JAX package's pre-finalizer word of a float column (JAX
    ops/aggregation.py `_hll_hash`): (mant * 2**52) ^ (expo << 1) ^ sign,
    mant = |x| * exp2(-expo), expo = floor(log2 |x|) as XLA rounds it.
    The exact exponent and fraction come from frexp; the tables add XLA's
    rounding (`_double_hash_host_tables`), so the word is the same on the
    CPU and the card.  NaN, zeros and subnormals give 0; an infinity gives
    expo 1023 and mant 0, as a value in the top binade does (exp2(-1023)
    flushes to zero)."""
    exp2, lo, hi = _double_hash_tables(d.device)
    tiny = _F32_TINY if d.dtype == torch.float32 else _F64_TINY
    f = d.to(torch.float64)
    a = f.abs()
    normal = a >= tiny  # False for NaN
    inf = torch.isinf(a)
    finite = torch.logical_and(normal, torch.logical_not(inf))
    m, ex = torch.frexp(torch.where(finite, a, 1.0))  # a = m * 2**ex, m in [0.5, 1)
    e = ex.to(torch.int64) - 1
    frac = ((m * 2.0 - 1.0) * 2.0**52).to(torch.int64)  # exact fraction bits
    ei = (e + 1022).clamp(0, 2045)
    expo = e - (frac < lo[ei]).to(torch.int64) + (frac >= (1 << 52) - hi[ei]).to(torch.int64)
    expo = torch.where(finite, expo, torch.where(inf, 1023, 0)).clamp(-1074, 1023)
    mant = torch.where(finite, a * exp2[(1023 - expo).clamp(0, 2046)], 0.0)
    sign = torch.where(torch.logical_and(normal, f < 0.0), 1 << 62, 0)
    return (mant * 2.0**52).to(torch.int64) ^ (expo << 1) ^ sign


#: id(dictionary) -> (dictionary, {device: blake2b/8 of every value}): a
#: dictionary's table is built once and gathered by code on every batch
#: (the entry pins its dictionary, so the id stays valid while cached)
_DICT_HASHES: "OrderedDict[int, tuple]" = OrderedDict()
_DICT_HASHES_LIMIT = 256
_DICT_HASHES_LOCK = threading.Lock()


def _dictionary_hashes(d, device: torch.device) -> torch.Tensor:
    """The 64-bit value hash (blake2b, 8 bytes, little-endian, as int64) of
    every value of dictionary `d`, on `device`.  checksum() needs real
    64-bit entropy: a 32-bit crc birthday-collides at ~77k distinct
    values."""
    import hashlib

    with _DICT_HASHES_LOCK:
        hit = _DICT_HASHES.get(id(d))
        if hit is not None and hit[0] is d:
            _DICT_HASHES.move_to_end(id(d))
            if device in hit[1]:
                return hit[1][device]
    table = np.fromiter(
        (
            int.from_bytes(
                hashlib.blake2b(
                    v.encode() if isinstance(v, str) else bytes(v), digest_size=8
                ).digest(),
                "little",
                signed=True,
            )
            for v in d.values
        ),
        dtype=np.int64,
        count=len(d.values),
    )
    t = torch.from_numpy(table).to(device)
    with _DICT_HASHES_LOCK:
        hit = _DICT_HASHES.get(id(d))
        if hit is None or hit[0] is not d:
            hit = (d, {})
            _DICT_HASHES[id(d)] = hit
        hit[1][device] = t
        while len(_DICT_HASHES) > _DICT_HASHES_LIMIT:
            _DICT_HASHES.popitem(last=False)
    return t


def _hll_hash(col: Column, name: str = "approx_distinct") -> torch.Tensor:
    """Per-row 64-bit hash of the column's VALUE, as int64 bits: stable
    across workers (dictionary codes are producer-local, so a dictionary
    column hashes its values).  Port of the JAX package's `_hll_hash`.

    Raises for an array/map argument and for long-decimal limb planes (the
    JAX package fails on their shape there)."""
    _scalar_arg(col, name)
    d = col.data
    if d.ndim > 1:
        raise NotImplementedError(
            f"{name} over a long-decimal argument (cast to decimal(18,s) or double first)"
        )
    if col.dictionary is not None:
        table = _dictionary_hashes(col.dictionary, d.device)
        h = table[d.to(torch.int64).clamp(0, max(table.shape[0] - 1, 0))]
    elif d.dtype.is_floating_point:
        h = _double_hash_words(d)
    else:
        h = d.to(torch.int64)
    return splitmix64(h)


def _hll_registers(col: Column, valid) -> torch.Tensor:
    """[HLL_M] int32 register vector over the valid rows of one column; an
    empty bucket holds INT32_MIN (the JAX package's segment_max identity)."""
    u = _hll_hash(col)
    bucket = _shr_logical(u, 64 - HLL_P)
    rest = (u << HLL_P) | 1  # the sentinel bit stops the rank at its max
    # rank = leading zeros of `rest` + 1, by a bit-length cascade of
    # logical shifts (`!= 0` is the unsigned `> 0`)
    x = rest
    bitlen = torch.zeros(rest.shape, dtype=torch.int32, device=rest.device)
    for s in (32, 16, 8, 4, 2, 1):
        y = _shr_logical(x, s)
        gt = y != 0
        bitlen = torch.where(gt, bitlen + s, bitlen)
        x = torch.where(gt, y, x)
    bitlen = bitlen + (x != 0).to(torch.int32)
    rank = 64 - bitlen + 1
    bucket = torch.where(valid, bucket, HLL_M)
    regs = _segment_extreme(torch.where(valid, rank, 0), bucket, HLL_M + 1, "amax")
    return regs[:HLL_M]


#: v -> HLL_M * log(HLL_M / max(v, 1)), the linear-counting estimate for v
#: empty registers (one host table per process; XLA's f64 log, which the
#: JAX package's estimate runs, is correctly rounded, as the host's is)
_HLL_LINEAR: list = []


def _hll_linear_table(device: torch.device) -> torch.Tensor:
    if not _HLL_LINEAR:
        import math

        m = float(HLL_M)
        _HLL_LINEAR.append(
            np.array([m * math.log(m / max(v, 1)) for v in range(HLL_M + 1)])
        )
    return torch.from_numpy(_HLL_LINEAR[0]).to(device)


def _hll_estimate(registers: torch.Tensor) -> torch.Tensor:
    """Registers [..., M] -> BIGINT cardinality (HLL raw estimator + the
    small-range linear-counting correction), vectorized over leading axes.
    sum(2**-r) runs over the count of each register value, smallest terms
    first, in a fixed order: exact whenever the sum fits a double (the JAX
    package's sum is then the same), and the same on the CPU and the card."""
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    r = registers.to(torch.int64).clamp(min=0)
    values = torch.arange(65, dtype=torch.int64, device=r.device)
    counts = (r[..., None] == values).sum(dim=-2).to(torch.float64)  # [..., 65]
    z = torch.zeros(counts.shape[:-1], dtype=torch.float64, device=r.device)
    for k in range(64, -1, -1):
        z = z + counts[..., k] * 2.0**-k
    raw = alpha * m * m / z
    v = (registers <= 0).sum(dim=-1)
    linear = _hll_linear_table(registers.device)[v]
    est = torch.where(torch.logical_and(raw <= 2.5 * m, v > 0), linear, raw)
    return torch.round(est).to(torch.int64)


def _primitives(spec: AggSpec):
    """Primitive states per SQL aggregate (kinds: sum/count/min/max/any,
    sum_f/sumsq (the f64 sums of the moments), checksum, hll, qdigest and
    the bi_* sums of the bivariate family)."""
    if spec.name == "approx_distinct":
        return [("hll", spec.arg)]
    if spec.name == "approx_percentile":
        # the log-bucket quantile sketch (reference: qdigest states), merged
        # by elementwise count addition
        return [("qdigest", spec.arg)]
    if spec.name == "count_star":
        return [("count_star", None)]
    if spec.name == "count":
        return [("count", spec.arg)]
    if spec.name in ("sum", "avg"):
        return [("sum", spec.arg), ("count", spec.arg)]
    if spec.name in ("min", "bool_and"):
        return [("min", spec.arg), ("count", spec.arg)]
    if spec.name in ("max", "bool_or"):
        return [("max", spec.arg), ("count", spec.arg)]
    if spec.name == "any_value":
        return [("any", spec.arg), ("count", spec.arg)]
    if spec.name in MOMENT:
        # reference: operator/aggregation VarianceState (count/mean/m2 as
        # merged moments; here the raw-sum formulation merges by addition)
        return [("sum_f", spec.arg), ("sumsq", spec.arg), ("count", spec.arg)]
    if spec.name == "checksum":
        # an order-independent wrapping sum of per-row value hashes
        # (reference: ChecksumAggregationFunction): equal multisets give
        # equal checksums, mergeable by addition.  A NULL row adds a fixed
        # prime, so NULL placement changes the checksum and all-NULL input
        # is non-null.
        return [("checksum", spec.arg), ("count_star", None)]
    if spec.name in BIVARIATE:
        # reference: CovarianceState/CorrelationState, the raw-sum
        # formulation merged by addition; a row with EITHER side NULL is
        # skipped (pairwise validity)
        return [
            ("bi_sum_1", spec.arg), ("bi_sum_2", spec.arg2),
            ("bi_sumsq_1", spec.arg), ("bi_sumsq_2", spec.arg2),
            ("bi_sum_12", spec.arg), ("bi_count", spec.arg),
        ]
    raise NotImplementedError(f"aggregate: {spec.name}")


def _state_types(spec: AggSpec, input_types) -> list[T.Type]:
    out = []
    for kind, arg in _primitives(spec):
        if kind == "hll":
            out.append(T.ArrayType(T.INTEGER))
        elif kind == "qdigest":
            out.append(T.ArrayType(T.BIGINT))
        elif kind in ("count", "count_star", "checksum", "bi_count"):
            out.append(T.BIGINT)
        elif kind in ("sum_f", "sumsq") or kind.startswith("bi_sum"):
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
    """How each state column merges in FINAL/MERGE mode: counts, checksums
    and the f64 sums are already-reduced values and merge by adding; HLL
    registers merge by elementwise max, qdigest counts by elementwise
    addition."""
    return [
        kind if kind in ("hll", "qdigest")
        else "sum" if kind in ("count", "count_star", "sum_f", "sumsq", "checksum")
        or kind.startswith("bi_")
        else kind
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
        out = out * (1.0 / 10.0**t.scale)  # as XLA folds the JAX package's division
    return out


def _moment_state(d, t: T.Type, kind: str):
    """The f64 series a moment state sums: the value or its square."""
    dl = _logical_double(d, t)
    return dl * dl if kind == "sumsq" else dl


def _order_free_sum(values, gid, nseg: int, valid=None) -> torch.Tensor:
    """Segmented f64 sum whose result does not depend on the order of the
    additions, so the card's atomic adds and the CPU's sequential adds give
    the same bits.  Two error-free extractions (Rump's ExtractVector: with
    sigma = 2**k >= 2 * n * max|r|, q = (sigma + r) - sigma is r on a grid
    of sigma * 2**-53, every sum of q's is exact in any order, and r - q is
    exact), then the remainder, ~2**-100 of the values, summed plainly.

    The bivariate family needs it: covar = s12 - s1 * s2 / n cancels by
    10**4 and more near a zero covariance, so the plain sum's
    order-dependent rounding (~sqrt(n) ulps over a 6 M-row batch) would
    show at 1e-9 between the CPU and the card.  `values` is [n] or [n, k]
    (k series at once, each with its own sigma)."""
    if valid is not None:
        valid = valid.reshape(valid.shape + (1,) * (values.ndim - 1))
    r = values if valid is None else torch.where(valid, values, 0.0)
    if r.shape[0] == 0:
        return segment_sum(r, gid, nseg)
    finite = torch.isfinite(r)
    total = segment_sum(torch.where(finite, 0.0, r), gid, nseg)  # inf and NaN as a plain sum
    r = torch.where(finite, r, 0.0)
    for _ in range(2):
        m = r.abs().amax(dim=0) * max(r.shape[0], 1)
        sigma = torch.where(
            torch.logical_and(m > 0, torch.isfinite(m)),
            torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] + 1),
            0.0,  # zeros, or values too large to bound: a plain sum
        )
        q = (sigma + r) - sigma
        total = total + segment_sum(q, gid, nseg)
        r = r - q
    return total + segment_sum(r, gid, nseg)


def _bivariate_states(batch: Batch, spec: AggSpec, perm, live, gid, nseg: int) -> list:
    """The six raw-sum states of a bivariate aggregate (1 = its first
    argument, 2 = its second) per segment: the sums of 1, 2, 1*1, 2*2 and
    1*2 (`_order_free_sum`) and the pair count, over the rows where both
    sides are non-NULL, read as logical doubles (a decimal is descaled).
    `perm` (or None) is the row order."""
    v = live
    series = []
    for ch in (spec.arg, spec.arg2):
        c = batch.columns[ch]
        _scalar_arg(c, spec.name)
        rows = (lambda t: t) if perm is None else (lambda t: t[perm])
        if c.valid is not None:
            v = torch.logical_and(v, rows(c.valid))
        series.append(_logical_double(rows(c.data), c.type))
    d1, d2 = series
    sums = _order_free_sum(torch.stack([d1, d2, d1 * d1, d2 * d2, d1 * d2], dim=1), gid, nseg, v)
    count = segment_reduce(d1, gid, nseg, "count", valid=v)
    return [Column(sums[:, i].contiguous(), T.DOUBLE) for i in range(5)] + [Column(count, T.BIGINT)]


def _hll_state(registers: torch.Tensor) -> Column:
    """One sketch as a one-row array(integer) state column."""
    lengths = torch.full((1,), HLL_M, dtype=torch.int32, device=registers.device)
    return Column(registers[None, :], T.ArrayType(T.INTEGER), None, None, lengths)


def _checksum_words(col: Column, name: str) -> torch.Tensor:
    """Each row's checksum addend: its value hash, or the NULL prime."""
    h = _hll_hash(col, name)
    if col.valid is not None:
        h = torch.where(col.valid, h, CHECKSUM_NULL_PRIME)
    return h


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


#: the decimal-sum path choices by name (proven | limb), one count per
#: step that takes one (the JAX package counts them per compiled program
#: in its telemetry; torch compiles nothing, so every call counts)
DECIMAL_FASTPATH: dict = {}


def _note_fastpath(path: str) -> None:
    """Record a decimal-sum path choice (the window's long-decimal sum and
    avg note theirs)."""
    DECIMAL_FASTPATH[path] = DECIMAL_FASTPATH.get(path, 0) + 1


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
    if name == "approx_distinct":
        return Column(_hll_estimate(states[0].data), T.BIGINT, None)
    if name == "approx_percentile":
        return _qdigest_result(spec, states[0].data)
    if name in ("count", "count_star"):
        return Column(states[0].data, T.BIGINT, None)
    if name == "checksum":
        # NULL only over zero input rows
        return Column(states[0].data, T.BIGINT, states[1].data > 0)
    if name in BIVARIATE:
        s1, s2 = states[0].data, states[1].data
        s11, s22 = states[2].data, states[3].data
        s12, cnt = states[4].data, states[5].data
        n = cnt.to(torch.float64)
        nn = n.clamp(min=1.0)
        # raw-sum forms (reference: CovarianceState.getCovariance etc)
        co_m = s12 - s1 * s2 / nn  # n * covar_pop
        v1_m = (s11 - s1 * s1 / nn).clamp(min=0.0)
        v2_m = (s22 - s2 * s2 / nn).clamp(min=0.0)
        if name == "covar_pop":
            return Column(co_m / nn, T.DOUBLE, cnt > 0)
        if name == "covar_samp":
            return Column(co_m / (n - 1.0).clamp(min=1.0), T.DOUBLE, cnt > 1)
        if name == "corr":
            denom = torch.sqrt(v1_m * v2_m)
            ok = torch.logical_and(cnt > 1, denom > 0)
            return Column(co_m / torch.where(ok, denom, 1.0), T.DOUBLE, ok)
        # regr_slope, and regr_intercept = (sum_y - slope * sum_x) / n
        ok = torch.logical_and(cnt > 1, v2_m > 0)
        slope = co_m / torch.where(ok, v2_m, 1.0)
        if name == "regr_slope":
            return Column(slope, T.DOUBLE, ok)
        return Column((s1 - slope * s2) / nn, T.DOUBLE, ok)
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
    # sum/min/max/any_value/bool_and/bool_or
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


def _qdigest_result(spec: AggSpec, counts: torch.Tensor) -> Column:
    """The one-row approx_percentile column of a merged qdigest state: the
    bucket estimate rescaled to the output type (a decimal rounds half to
    even, as the JAX package's jnp.round; a long decimal splits into limb
    planes as the double-to-long-decimal cast does), NULL over no rows."""
    from trino_tpu_torch.ops import qdigest as qd

    p = float(spec.param if spec.param is not None else 0.5)
    if counts.ndim == 2:
        counts = counts[0]
    val, total = qd.estimate(counts, p)
    valid = (total > 0)[None]
    out_t = spec.out_type
    if isinstance(out_t, T.DecimalType):
        r = torch.round(val * out_t.scale_factor)
        if out_t.is_long:
            from trino_tpu_torch.types.int128 import TWO64

            h = torch.floor(r / float(TWO64))
            lf = r - h * float(TWO64)
            l = torch.where(lf >= float(1 << 63), lf - float(TWO64), lf)
            planes = torch.stack([h.to(torch.int64), l.to(torch.int64)])
            return Column(planes[None, :], out_t, valid)
        return Column(r.to(torch.int64)[None], out_t, valid)
    return Column(val.to(torch_dtype(out_t.np_dtype))[None], out_t, valid)


def _qdigest_state(counts: torch.Tensor) -> Column:
    """One sketch as a one-row array(bigint) state column."""
    from trino_tpu_torch.ops import qdigest as qd

    lengths = torch.full((1,), qd.NBUCKETS, dtype=torch.int32, device=counts.device)
    return Column(counts[None, :], T.ArrayType(T.BIGINT), None, None, lengths)


def _qdigest_input(col: Column) -> torch.Tensor:
    """The logical doubles a qdigest counts: a decimal descaled by XLA's
    reciprocal multiply (`_logical_double`), long-decimal limb planes read
    as one 128-bit value and divided by the scale factor, as the JAX
    package divides them."""
    _scalar_arg(col, "approx_percentile")
    if col.data.ndim == 2:
        from trino_tpu_torch.types import int128 as i128

        f = i128.to_float128(col.data[:, 0], col.data[:, 1])
        return f * (1.0 / float(col.type.scale_factor))
    return _logical_double(col.data, col.type)


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
        lengths = None
        if c.lengths is not None:
            lengths = torch.cat([c.lengths, torch.zeros(pad, dtype=c.lengths.dtype, device=dev)])
        cols.append(Column(torch.cat([c.data, zeros]), c.type, valid, c.dictionary, lengths))
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
        memory_ctx=None,
    ):
        if mode not in ("single", "partial", "final", "merge"):
            raise ValueError(f"aggregation mode: {mode}")
        if group_channels and any(
            s.name in ("approx_distinct", "approx_percentile") for s in aggregates
        ):
            # a grouped sketch would need [groups, HLL_M] or [groups,
            # NBUCKETS] states; the planner rewrites grouped approx_distinct
            # to an exact DISTINCT count and a grouped approx_percentile to
            # the exact percentile instead, so SQL never reaches this
            raise NotImplementedError("grouped approx_distinct or approx_percentile")
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
        #: reservation of the accumulated states (runtime/memory.py); over
        #: budget the states fold, and what still does not fit raises
        self.memory_ctx = memory_ctx
        #: streaming reduces each batch to group states at once; a holistic
        #: aggregate needs every row of a group at once, so its operator
        #: keeps the raw (projected) batches and reduces them once
        #: (reference: ArrayAggregationFunction's group state)
        self.streaming = not any(s.name in HOLISTIC_AGGS for s in self.aggregates)
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
            require_scalar_key(c)  # an array(varchar) column has a dictionary too
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

    def _slot_keys(self, batch: Batch, sizes, offsets, n: int) -> list:
        """The group key columns of slots 0..n-1 of a mixed-radix slot code
        (each key's code = value - offset, its NULL in the last slot of a
        nullable key), decoded from the slot index."""
        idx = torch.arange(n, dtype=torch.int64, device=batch.device)
        cols: list[Column] = []
        div = 1
        divs = []
        for size in reversed(sizes):
            divs.append(div)
            div *= size
        for ch, size, offset, div in zip(self.group_channels, sizes, offsets, reversed(divs)):
            c = batch.columns[ch]
            code = (idx // div) % size
            valid = None if c.valid is None else code < (size - 1)
            cols.append(Column((code + offset).to(c.data.dtype), c.type, valid, c.dictionary))
        return cols

    def _append_states(self, cols: list, batch: Batch, perm, live, gid, nseg, out_cap) -> None:
        """Each aggregate's state columns (PARTIAL/MERGE) or result column."""
        for spec in self.aggregates:
            state_cols = self._reduce_one(batch, spec, perm, live, gid, nseg, out_cap)
            if self.mode in ("partial", "merge"):
                cols.extend(state_cols)
            else:
                cols.append(_finalize(spec, state_cols))

    def _direct_reduce(self, batch: Batch, sizes, prod: int) -> Batch:
        _note_group_path("direct")
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
        cols = self._slot_keys(batch, sizes, [0] * len(sizes), prod)
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
        self._append_states(cols, batch, perm, live, gid, nseg, prod)
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

    # -- the range-positional (sort-free) path ---------------------------------

    #: group-domain cap for the range-positional path (the mixed-radix
    #: offset code over each key's live (min, max)); beyond it, the sort
    POSITIONAL_LIMIT = 1 << 24

    def _positional_static_eligible(self, batch: Batch) -> bool:
        """Type-level eligibility for the range-positional path: every
        group key is an int-family scalar (ints, dates, short decimals,
        dictionary codes, booleans) — the generalized BigintGroupByHash
        dense path (reference: operator/BigintGroupByHash.java), with the
        dense domain read from the data's (min, max) instead of assumed.
        Holistic aggregates (`streaming` False) need the sorted numbering."""
        if not self.group_channels or not self.streaming:
            return False
        for ch in self.group_channels:
            col = batch.columns[ch]
            if col.lengths is not None or col.data.ndim > 1:
                return False  # array keys and long-decimal limb planes sort
            if col.data.dtype.is_floating_point:
                return False
        return True

    def _key_stats(self, batch: Batch):
        """Per-key (min, max) over the live, non-NULL key values: one host
        read for all keys."""
        live = batch.mask()
        big = torch.iinfo(torch.int64).max
        stats = []
        for ch in self.group_channels:
            col = batch.columns[ch]
            d = col.data.to(torch.int64)
            v = live if col.valid is None else torch.logical_and(live, col.valid)
            stats.append(torch.where(v, d, big).min())
            stats.append(torch.where(v, d, -big).max())
        host = torch.stack(stats).tolist()
        return host[0::2], host[1::2]

    def _positional_try(self, batch: Batch) -> Optional[Batch]:
        """Sort-free grouped reduction when the key domain is dense enough:
        gid = the mixed-radix offset code from each key's (min, size), the
        group keys decoded back from the slot index.  None when the domain
        is too large: over POSITIONAL_LIMIT, or much larger than the input
        (O(domain) segment slots)."""
        if not self._positional_static_eligible(batch):
            return None
        mins, maxs = self._key_stats(batch)
        prod = 1
        sizes = []
        for ch, lo, hi in zip(self.group_channels, mins, maxs):
            # an empty or all-NULL key keeps only its NULL slot
            size = max(hi - lo + 1, 0) + (batch.columns[ch].valid is not None)
            if size <= 0:
                return None
            sizes.append(size)
            prod *= size
            if prod > self.POSITIONAL_LIMIT:
                return None
        if prod > max(1 << 16, 8 * batch.capacity):
            return None
        nseg = next_pow2(prod, floor=16)
        out = self._range_step(batch, mins, sizes, nseg)
        # the output is sparse (occupancy-masked): compact it when the live
        # groups fill under half the domain, so downstream steps stay small
        cc = next_pow2(max(out.num_rows_host(), 1), floor=16)
        if cc * 2 <= nseg:
            out = out.compact_device(out_capacity=cc)
        return out

    def _range_step(self, batch: Batch, mins, sizes, out_cap: int) -> Batch:
        _note_group_path("positional")
        cap = batch.capacity
        live = batch.mask()
        gid = torch.zeros(cap, dtype=torch.int64, device=batch.device)
        for ch, lo, size in zip(self.group_channels, mins, sizes):
            col = batch.columns[ch]
            size_v = size - (col.valid is not None)  # the non-NULL slots
            code = (col.data.to(torch.int64) - lo).clamp(0, max(size_v - 1, 0))
            if col.valid is not None:
                code = torch.where(col.valid, code, size_v)
            gid = gid * size + code
        gid = torch.where(live, gid, out_cap)
        nseg = out_cap + 1
        occupancy = segment_sum(live.to(torch.int64), gid, nseg)[:out_cap]
        cols = self._slot_keys(batch, sizes, mins, out_cap)
        perm = torch.arange(cap, dtype=torch.int64, device=batch.device)
        self._append_states(cols, batch, perm, live, gid, nseg, out_cap)
        return Batch(cols, occupancy > 0)

    def _reduce_full(self, big: Batch) -> Batch:
        """One-shot reduction of a batch: compact away dead slack first,
        then the positional path if the key domain allows it (the direct
        path first: its dictionary keys need no host read), else the sorted
        step.  push() applies a fused projection before any reduction, so
        `big` is always the projected batch here."""
        n = big.num_rows_host()
        cap = next_pow2(max(n, 1), floor=1)
        if cap < big.capacity:
            big = big.compact_device(out_capacity=cap)
        else:
            cap = next_pow2(big.capacity, floor=1)
            big = _pad_device(big, cap)
        if self._direct_group_info(big) is None:
            out = self._positional_try(big)
            if out is not None:
                return out
        return self._reduce_step(big, out_cap=cap)

    def _reduce_step(self, batch: Batch, out_cap: int) -> Batch:
        gch = self.group_channels
        if not gch:
            return self._global_reduce(batch)
        # holistic group ids must come from the sort-based numbering
        direct = self._direct_group_info(batch) if self.streaming else None
        if direct is not None:
            return self._direct_reduce(batch, *direct)
        _note_group_path("sorted")
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
            if spec.name in HOLISTIC_AGGS:
                cols.append(self._holistic_one(batch, spec, perm, live, gid_c, nseg, out_cap))
                continue
            state_cols = self._reduce_one(batch, spec, perm, live, gid_c, nseg, out_cap)
            if self.mode in ("partial", "merge"):
                cols.extend(state_cols)
            else:
                cols.append(_finalize(spec, state_cols))
        return Batch(cols, out_live)

    def _holistic_one(self, batch, spec, perm, live, gid_c, nseg, out_cap) -> Column:
        """A holistic aggregate's output column: single-stage only."""
        if self.mode != "single":
            raise NotImplementedError(f"{spec.name} requires single-stage aggregation")
        if spec.name == "percentile":
            return self._percentile_one(batch, spec, out_cap)
        if spec.name in ("min_by", "max_by"):
            return self._minmax_by_one(batch, spec, perm, live, gid_c, nseg, out_cap)
        if spec.name == "listagg":
            return self._listagg_one(batch, spec, out_cap)
        return self._collect_one(batch, spec, perm, live, gid_c, nseg, out_cap)

    def _minmax_by_n(self, batch: Batch, spec: AggSpec, nseg: int, out_cap: int) -> Column:
        """min_by/max_by(value, key, n): the values at each group's n
        extreme keys, as a padded [groups, n] array in key order (reference:
        MinMaxByNAggregation's TypedHeap; a sort-based engine takes the
        first n of the key-sorted run instead).  NULL keys and NULL values
        are skipped: the rectangular layout carries no per-element NULLs."""
        n = int(spec.param)
        want_min = spec.name == "min_by"
        cap = batch.capacity
        dev = batch.device
        kcol = batch.columns[spec.arg2]
        vcol = batch.columns[spec.arg]
        _minmax_by_args(spec, vcol, kcol, n_form=True)
        keys = [SortKey(ch) for ch in self.group_channels] + [SortKey(spec.arg2, want_min)]
        perm = multi_key_sort_perm(batch, keys)
        live = batch.mask()[perm]
        if self.group_channels:
            gid_c, _, _ = group_ids_from_sorted(batch, perm, self.group_channels)
        else:
            gid_c = torch.zeros(cap, dtype=torch.int64, device=dev)
        varg = live
        if kcol.valid is not None:
            varg = torch.logical_and(varg, kcol.valid[perm])
        if vcol.valid is not None:
            varg = torch.logical_and(varg, vcol.valid[perm])
        pos_in_group, counts = _group_ranks(varg, gid_c, cap, nseg)
        keep = torch.logical_and(varg, pos_in_group < n)
        scatter_g = torch.where(keep, gid_c, nseg)  # the rest: the spare row
        scatter_p = pos_in_group.clamp(0, n - 1)
        dt = torch_dtype(spec.out_type.element.np_dtype)
        out = torch.zeros((nseg + 1, n), dtype=dt, device=dev)
        out[scatter_g, scatter_p] = vcol.data[perm].to(dt)
        lengths = counts[:out_cap].clamp(max=n).to(torch.int32)
        return Column(out[:out_cap], spec.out_type, None, vcol.dictionary, lengths)

    def _minmax_by_one(self, batch: Batch, spec: AggSpec, perm, live, gid_c, nseg: int,
                       out_cap: int) -> Column:
        """min_by/max_by(value, key): the VALUE at each group's extreme KEY
        (reference: MinMaxByNAggregation, N = 1): the extreme key by a
        segmented reduction, then the first sorted row holding it selects
        the value.  Rows with NULL keys are skipped; ties pick the first
        sorted row.  NaN orders as largest (the sort's rule): max_by takes
        a NaN-key row, min_by only when every key of the group is NaN."""
        if spec.param is not None:
            return self._minmax_by_n(batch, spec, nseg, out_cap)
        from trino_tpu_torch.ops.common import _max_sentinel, _min_sentinel

        cap = batch.capacity
        dev = batch.device
        vcol = batch.columns[spec.arg]
        kcol = batch.columns[spec.arg2]
        _minmax_by_args(spec, vcol, kcol, n_form=False)
        kd = kcol.data[perm]
        vkey = live if kcol.valid is None else torch.logical_and(live, kcol.valid[perm])
        want_min = spec.name == "min_by"
        sent = _max_sentinel(kd.dtype) if want_min else _min_sentinel(kd.dtype)
        keyed = torch.where(vkey, kd, sent)
        red = "min" if want_min else "max"
        if kd.dtype.is_floating_point:
            nan = torch.isnan(keyed)
            if want_min:
                # NaN must win only when every key is NaN: it reduces as +inf
                keyed = torch.where(nan, float("inf"), keyed)
                kext = segment_reduce(keyed, gid_c, nseg, red)
            else:
                # a NaN key is the group's extreme (the JAX package's
                # segment_max propagates it); reduced explicitly, since the
                # scatter reductions' NaN handling differs by device
                has_nan = segment_sum(nan.to(torch.int64), gid_c, nseg) > 0
                kext = segment_reduce(torch.where(nan, float("-inf"), keyed), gid_c, nseg, red)
                kext = torch.where(has_nan, float("nan"), kext)
        else:
            kext = segment_reduce(keyed, gid_c, nseg, red)
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        kext_g = kext[gid_c.clamp(0, nseg - 1)]
        match = keyed == kext_g
        if kd.dtype.is_floating_point:
            # NaN != NaN: a NaN extreme matches its NaN-key rows
            match = torch.logical_or(
                match, torch.logical_and(torch.isnan(keyed), torch.isnan(kext_g))
            )
        at_ext = torch.logical_and(vkey, match)
        first = segment_reduce(torch.where(at_ext, pos, cap), gid_c, nseg, "min")
        idx = first[:out_cap].clamp(0, cap - 1)
        rows = perm[idx]
        has_key = segment_sum(vkey.to(torch.int64), gid_c, nseg)[:out_cap] > 0
        valid = has_key
        if vcol.valid is not None:
            valid = torch.logical_and(valid, vcol.valid[rows])
        return Column(vcol.data[rows], spec.out_type, valid, vcol.dictionary)

    def _percentile_one(self, batch: Batch, spec: AggSpec, out_cap: int) -> Column:
        """Exact per-group percentile: re-sort by (group keys, value) and
        pick each group's nearest-rank row (reference role:
        ApproximateLongPercentileAggregations via qdigest; a sort-based
        engine computes the exact rank instead).  The global form is the
        one-group case."""
        gch = self.group_channels
        cap = batch.capacity
        dev = batch.device
        col = batch.columns[spec.arg]
        _scalar_arg(col, spec.name)
        perm2 = multi_key_sort_perm(batch, [SortKey(ch) for ch in gch] + [SortKey(spec.arg)])
        if gch:
            gid2, _, _ = group_ids_from_sorted(batch, perm2, gch)
        else:
            gid2 = torch.zeros(cap, dtype=torch.int64, device=dev)
        varg = batch.mask()[perm2]
        if col.valid is not None:
            varg = torch.logical_and(varg, col.valid[perm2])
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        gid_c = gid2.clamp(max=out_cap)
        nseg = out_cap + 1
        # NULLs sort last within the group: the group's first live row
        # starts the non-NULL run, whose length is the valid count
        start = segment_reduce(torch.where(varg, pos, cap), gid_c, nseg, "min")
        nvalid = segment_sum(varg.to(torch.int64), gid_c, nseg)
        p = float(spec.param if spec.param is not None else 0.5)
        target = start + torch.round(
            p * (nvalid - 1).clamp(min=0).to(torch.float64)
        ).to(torch.int64)
        rows = perm2[target[:out_cap].clamp(0, cap - 1)]
        return Column(col.data[rows], spec.out_type, nvalid[:out_cap] > 0, col.dictionary)

    def _collect_one(self, batch: Batch, spec: AggSpec, perm, live, gid_c, nseg, out_cap) -> Column:
        """array_agg / map_agg: scatter each group's run into a padded
        rectangular array (reference: operator/aggregation/
        ArrayAggregationFunction + MapAggAggregationFunction group state).

        Eager: the padded width K is the largest group, a data-dependent
        shape that costs one host read (logged in COLLECT_LOG).  NULL inputs
        are skipped: the rectangular layout tracks NULLs per array, not per
        element (the JAX package's deviation from the reference, kept)."""
        cap = batch.capacity
        dev = batch.device
        col = batch.columns[spec.arg]
        _scalar_arg(col, spec.name)
        if spec.name == "array_agg" and spec.arg2 is not None and spec.param is not None:
            # array_agg(x ORDER BY k): re-sort by (group keys, k) so the
            # scatter positions follow the requested element order; the
            # group numbering is unchanged, the group keys staying most
            # significant
            asc, nf = spec.param
            keys = [SortKey(ch) for ch in self.group_channels]
            keys.append(SortKey(spec.arg2, asc, nf))
            perm = multi_key_sort_perm(batch, keys)
            live = batch.mask()[perm]
            if self.group_channels:
                gid_c, _, _ = group_ids_from_sorted(batch, perm, self.group_channels)
            else:
                gid_c = torch.zeros(cap, dtype=torch.int64, device=dev)
        d = col.data[perm]
        varg = live if col.valid is None else torch.logical_and(live, col.valid[perm])
        dictionary = col.dictionary
        vd = None
        if spec.name == "map_agg":
            vcol = batch.columns[spec.arg2]
            _scalar_arg(vcol, spec.name)
            vd = vcol.data[perm]
            if vcol.valid is not None:
                varg = torch.logical_and(varg, vcol.valid[perm])
            if col.dictionary is not None and vcol.dictionary is not None:
                from trino_tpu_torch.columnar.dictionary import union_many

                dictionary, (tk, tv) = union_many([col.dictionary, vcol.dictionary])
                if tk is not None:
                    d = take_table(tk, d)
                if tv is not None:
                    vd = take_table(tv, vd)
            elif vcol.dictionary is not None:
                dictionary = vcol.dictionary
        if d.ndim > 1:
            raise NotImplementedError(
                f"{spec.name} over a long-decimal argument "
                "(cast to decimal(18,s) or double first)"
            )
        pos_in_group, counts = _group_ranks(varg, gid_c, cap, nseg)
        kmax = int(counts[:out_cap].max()) if out_cap else 0  # the one host read
        k = next_pow2(max(kmax, 1), floor=1)
        COLLECT_LOG.append((spec.name, out_cap, k))
        scatter_g = torch.where(varg, gid_c.clamp(max=nseg), nseg)  # non-kept rows: spare
        scatter_p = pos_in_group.clamp(0, k - 1)
        lengths = counts[:out_cap].to(torch.int32)

        def plane(values, dt):
            out = torch.zeros((nseg + 1, k), dtype=dt, device=dev)
            out[scatter_g, scatter_p] = values.to(dt)
            return out[:out_cap]

        if spec.name == "array_agg":
            et = spec.out_type.element
            data = plane(d, torch_dtype(et.np_dtype))
            return Column(data, spec.out_type, None, dictionary, lengths)
        dt = torch_dtype(spec.out_type.np_dtype)  # MapType: packed [out_cap, 2k]
        packed = torch.cat([plane(d, dt), plane(vd, dt)], dim=1)
        return Column(packed, spec.out_type, None, dictionary, lengths)

    def _listagg_one(self, batch: Batch, spec: AggSpec, out_cap: int) -> Column:
        """listagg(value, sep) WITHIN GROUP (ORDER BY k) (reference:
        operator/aggregation/listagg/).  Eager: the rows sort by (group
        keys, order key) on the device; the per-group string join is host
        work (the strings live in dictionaries)."""
        from trino_tpu_torch.columnar.dictionary import StringDictionary

        gch = self.group_channels
        col = batch.columns[spec.arg]
        if col.dictionary is None:
            raise TypeError("listagg requires a varchar argument")
        sep, asc, nf = (
            spec.param if isinstance(spec.param, tuple) else (spec.param or "", True, False)
        )
        keys = [SortKey(ch) for ch in gch]
        if spec.arg2 is not None:
            keys.append(SortKey(spec.arg2, ascending=asc, nulls_first=nf))
        perm2 = multi_key_sort_perm(batch, keys)
        if gch:
            gid2, _, _ = group_ids_from_sorted(batch, perm2, gch)
        else:
            gid2 = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
        live = batch.mask()[perm2]
        if col.valid is not None:
            live = torch.logical_and(live, col.valid[perm2])
        codes = col.data[perm2]
        gid_h, live_h, codes_h = (
            t.cpu().numpy() for t in (gid2, live, codes.to(torch.int64))
        )
        COLLECT_LOG.append((spec.name, out_cap, 0))
        sep = str(sep)
        values = col.dictionary.values
        joined = [""] * out_cap
        parts: dict = {}
        for i in np.flatnonzero(live_h):
            g = int(gid_h[i])
            if g < out_cap:
                parts.setdefault(g, []).append(values[int(codes_h[i])])
        valid_out = np.zeros(out_cap, dtype=bool)
        for g, vs in parts.items():
            joined[g] = sep.join(vs)
            valid_out[g] = True
        d = StringDictionary.from_unsorted(joined)
        dev = batch.device
        return Column(
            torch.from_numpy(np.asarray(d.encode(joined), dtype=np.int32)).to(dev),
            spec.out_type,
            None if valid_out.all() else torch.from_numpy(valid_out).to(dev),
            d,
        )

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
                elif spec.name in BIVARIATE and d.dtype == torch.float64:
                    red = _order_free_sum(d, gid, nseg, v)[:out_cap]
                    state_cols.append(Column(red, col.type, None))
                else:
                    red = segment_reduce(d, gid, nseg, kind, valid=v)[:out_cap]
                    state_cols.append(Column(red, col.type, None, col.dictionary))
            return state_cols
        if spec.name in BIVARIATE:
            return [c.map_rows(lambda t: t[:out_cap])
                    for c in _bivariate_states(batch, spec, perm, live, gid, nseg)]
        out = []
        sts = _state_types(spec, self.input_types)
        for (kind, arg), st in zip(_primitives(spec), sts):
            if kind == "count_star":
                ones = torch.ones(batch.capacity, dtype=torch.int64, device=batch.device)
                red = segment_reduce(ones, gid, nseg, "count", valid=live)[:out_cap]
                out.append(Column(red, T.BIGINT, None))
                continue
            col = batch.columns[arg]
            if kind == "checksum":
                # the int64 sum wraps, so every fold order gives one value
                h = _checksum_words(col, spec.name)[perm]
                red = segment_reduce(h, gid, nseg, "sum", valid=live)[:out_cap]
                out.append(Column(red, T.BIGINT, None))
                continue
            if kind != "count":
                _scalar_arg(col, spec.name)
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
            if spec.name in HOLISTIC_AGGS:
                # one global group: the grouped form with gid 0
                perm0 = torch.arange(batch.capacity, dtype=torch.int64, device=batch.device)
                cols.append(self._holistic_one(batch, spec, perm0, live, gid0, 2, 1))
                continue
            states = []
            if self.mode in ("final", "merge"):
                ch = spec.arg
                for kind in _merge_primitives(spec):
                    col = batch.columns[ch]
                    v = live if col.valid is None else torch.logical_and(live, col.valid)
                    ch += 1
                    if kind == "hll":
                        # elementwise max of the register rows
                        regs = torch.where(v[:, None], col.data, torch.iinfo(torch.int32).min)
                        states.append(_hll_state(regs.amax(dim=0)))
                        continue
                    if kind == "qdigest":
                        # elementwise sum of the count rows
                        counts = torch.where(v[:, None], col.data, 0).sum(dim=0)
                        states.append(_qdigest_state(counts))
                        continue
                    if kind == "sum" and isinstance(col.type, T.DecimalType) and col.type.is_long:
                        red = _sum128(col.data, gid0, 1, v, sum_bound=spec.sum_bound)
                    elif col.data.ndim == 2 and isinstance(col.type, T.DecimalType) and kind in ("min", "max", "any"):
                        red = _reduce128(col.data, gid0, 1, kind, v)
                    elif spec.name in BIVARIATE and col.data.dtype == torch.float64:
                        red = _order_free_sum(col.data, gid0, 1, v)
                    else:
                        red = _masked_reduce(col.data, v, kind)
                    states.append(Column(red, col.type, None, col.dictionary))
            elif spec.name in BIVARIATE:
                states = _bivariate_states(batch, spec, None, live, gid0, 1)
            else:
                sts = _state_types(spec, self.input_types)
                for (kind, arg), st in zip(_primitives(spec), sts):
                    if kind == "count_star":
                        states.append(Column(live.sum(dtype=torch.int64)[None], T.BIGINT))
                        continue
                    col = batch.columns[arg]
                    if kind == "checksum":
                        red = _masked_reduce(_checksum_words(col, spec.name), live, "sum")
                        states.append(Column(red, T.BIGINT, None))
                        continue
                    if kind == "hll":
                        v = live if col.valid is None else torch.logical_and(live, col.valid)
                        states.append(_hll_state(_hll_registers(col, v)))
                        continue
                    if kind == "qdigest":
                        from trino_tpu_torch.ops import qdigest as qd

                        v = live if col.valid is None else torch.logical_and(live, col.valid)
                        states.append(_qdigest_state(qd.histogram(_qdigest_input(col), v)))
                        continue
                    if kind != "count":
                        _scalar_arg(col, spec.name)
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
        """Reduce one input batch to its group states and keep those (a
        non-streaming operator keeps the projected batch itself)."""
        if self._pre is not None:
            batch = self._pre(batch)
        if not self.streaming:
            self._acc.append(batch)
        else:
            self._acc.append(self.reduce_batch(batch))
            if len(self._acc) >= self.fold_every:
                self._fold_states()
        if self.memory_ctx is not None:
            from trino_tpu_torch.runtime.memory import (
                ExceededMemoryLimitException,
                batches_bytes,
            )

            try:
                self.memory_ctx.set_bytes(batches_bytes(self._acc))
            except ExceededMemoryLimitException:
                # folding compacts the states to their live groups, often
                # enough to fit; pressure that survives the fold raises (the
                # wave fallback's and the killer's signal)
                if not self.streaming or len(self._acc) <= 1:
                    raise
                self._fold_states()
                self.memory_ctx.set_bytes(batches_bytes(self._acc))

    def state_bytes(self) -> int:
        from trino_tpu_torch.runtime.memory import batches_bytes

        return batches_bytes(self._acc)

    def process(self, stream):
        for batch in stream:
            self.push(batch)
        out = self.finish()
        if self.memory_ctx is not None:
            self.memory_ctx.close()
        yield out

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
        if not self.streaming:
            return self._reduce_full(big)
        out_mode = "merge" if self.mode in ("partial", "merge") else "final"
        return self._combine(big, out_mode)

    def _combine(self, states_batch: Batch, out_mode: str) -> Batch:
        """Re-reduce a batch of state rows (group keys + state columns)."""
        merger = AggregationOperator(
            list(range(len(self.group_channels))),
            [
                AggSpec(
                    s.name, self._state_channel(i), s.out_type,
                    sum_bound=s.sum_bound, param=s.param,
                )
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

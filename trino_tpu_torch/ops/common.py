"""Shared device kernels: multi-key stable sort, segmented grouping.

Port of trino_tpu/ops/common.py.  Group ids come from iterated stable sorts
(least-significant key first) + key-change flags + cumsum, and accumulators
are segmented reductions (`index_add_` / `scatter_reduce_`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.types import DecimalType


@dataclass(frozen=True)
class SortKey:
    channel: int
    ascending: bool = True
    nulls_first: bool = False


def _key_with_null_order(col: Column, ascending: bool, nulls_first: bool):
    """(rank or None, value key) for one sort key.

    Direction uses bitwise complement for integers (INT64_MIN-safe) and
    negation for floats; NaN and NULL placement ride a small int8 rank
    sorted in a second stable pass.  NaN orders as largest; NULL placement
    follows nulls_first."""
    data = col.data
    if data.dtype == torch.bool:
        data = data.to(torch.int8)
    rank = None
    if data.is_floating_point():
        nan = torch.isnan(data)
        value_key = torch.where(nan, 0.0, data)
        if not ascending:
            value_key = -value_key  # finite negation is exact for floats
        rank = torch.where(nan, 1 if ascending else -1, 0).to(torch.int8)
    else:
        value_key = data if ascending else ~data
    if col.valid is not None:
        base = rank if rank is not None else torch.zeros_like(data, dtype=torch.int8)
        rank = torch.where(col.valid, base, -2 if nulls_first else 2)
    return rank, value_key


def require_scalar_key(col: Column) -> None:
    """Raise for an array or map column used as a sort, group, partition or
    join key: its [capacity, K] data would otherwise read as K limb planes
    (or, dictionary-coded, as one code a row).  The JAX package fails on
    such a key with a shape error; the analyzer rejects ORDER BY on these
    types."""
    if col.lengths is not None:
        raise NotImplementedError(
            f"a sort, group, partition or join key of type {col.type.name}"
        )


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def multi_key_sort_perm(batch: Batch, keys) -> torch.Tensor:
    """Stable permutation sorting live rows by `keys` (lexicographic);
    dead rows sort last.  A chain of stable sorts, least-significant key
    first."""
    n = batch.capacity
    perm = torch.arange(n, dtype=torch.int64, device=batch.device)
    for k in reversed(list(keys)):
        src = batch.columns[k.channel]
        require_scalar_key(src)
        col = src.gather(perm)
        if col.data.ndim == 2 and isinstance(col.type, DecimalType):
            # long decimal: two stable passes — low limb (unsigned order via
            # sign-flip), then high limb; the null rank rides the high pass
            from trino_tpu_torch.types.int128 import _SIGN

            lo = col.data[:, 1] ^ _SIGN
            if not k.ascending:
                lo = ~lo
            perm = perm[_stable_argsort(lo)]
            hi = src.data[perm, 0]
            if not k.ascending:
                hi = ~hi
            perm = perm[_stable_argsort(hi)]
            if src.valid is not None:
                rank = torch.where(
                    src.valid[perm], 0, -2 if k.nulls_first else 2
                ).to(torch.int8)
                perm = perm[_stable_argsort(rank)]
            continue
        rank, key = _key_with_null_order(col, k.ascending, k.nulls_first)
        order = _stable_argsort(key)
        perm = perm[order]
        if rank is not None:
            perm = perm[_stable_argsort(rank[order])]
    # dead rows last (most significant)
    dead = torch.logical_not(batch.mask()[perm]).to(torch.int8)
    return perm[_stable_argsort(dead)]


def group_ids_from_sorted(batch: Batch, perm, key_channels):
    """Given a sort permutation over group keys, return (gid_sorted, ngroups,
    new_group_flags): group ids in sorted order, null-safe equality."""
    n = batch.capacity
    live = batch.mask()[perm]
    change = torch.zeros(n, dtype=torch.bool, device=batch.device)
    for ch in key_channels:
        col = batch.columns[ch]
        require_scalar_key(col)
        d = col.data[perm]
        neq = d != torch.roll(d, 1, 0)
        if neq.ndim > 1:  # long decimal limb planes: any limb differing
            neq = neq.any(dim=-1)
        if col.valid is not None:
            v = col.valid[perm]
            pv = torch.roll(v, 1, 0)
            neq = torch.logical_or(
                torch.logical_and(neq, torch.logical_and(v, pv)), v != pv
            )
        change = torch.logical_or(change, neq)
    first_live = torch.logical_and(live, torch.cumsum(live.to(torch.int64), 0) == 1)
    new_group = torch.logical_and(live, torch.logical_or(change, first_live))
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    gid = torch.where(live, gid, n - 1)  # dead rows into last (masked) slot
    ngroups = new_group.sum()
    return gid, ngroups, new_group


def segment_sum(values: torch.Tensor, gid: torch.Tensor, num_segments: int):
    """jax.ops.segment_sum: sums per segment, empty segments 0."""
    out = torch.zeros(
        (num_segments,) + tuple(values.shape[1:]),
        dtype=values.dtype,
        device=values.device,
    )
    return out.index_add_(0, gid, values)


def _segment_extreme(values, gid, num_segments: int, how: str):
    """jax.ops.segment_min/max: an empty segment keeps the identity
    (dtype max for min, dtype min for max), so the output starts from the
    sentinel and the scatter includes it."""
    is_bool = values.dtype == torch.bool
    v = values.to(torch.int8) if is_bool else values
    fill = _max_sentinel(v.dtype) if how == "amin" else _min_sentinel(v.dtype)
    if is_bool:
        fill = 1 if how == "amin" else 0
    out = torch.full((num_segments,), fill, dtype=v.dtype, device=v.device)
    out = out.scatter_reduce_(0, gid, v, how, include_self=True)
    return out.to(torch.bool) if is_bool else out


def segment_reduce(values, gid, num_segments: int, kind: str, valid=None):
    """Null-skipping segmented reduction. kind: sum/min/max/count/any."""
    if kind == "count":
        w = torch.ones(gid.shape, dtype=torch.int64, device=gid.device)
        if valid is not None:
            w = torch.where(valid, w, 0)
        return segment_sum(w, gid, num_segments)
    if valid is not None:
        if kind == "sum":
            values = torch.where(valid, values, 0)
        elif kind == "min" and values.dtype != torch.bool:
            values = torch.where(valid, values, _max_sentinel(values.dtype))
        elif kind == "max" and values.dtype != torch.bool:
            values = torch.where(valid, values, _min_sentinel(values.dtype))
        elif kind == "min":
            values = torch.logical_or(values, torch.logical_not(valid))
        elif kind == "max":
            values = torch.logical_and(values, valid)
    if kind == "sum":
        return segment_sum(values, gid, num_segments)
    if kind == "min":
        return _segment_extreme(values, gid, num_segments, "amin")
    if kind == "max":
        return _segment_extreme(values, gid, num_segments, "amax")
    if kind == "any":
        # first VALID value per segment (any_value): min row index among valid
        n = values.shape[0]
        idx = torch.arange(n, dtype=torch.int64, device=values.device)
        if valid is not None:
            idx = torch.where(valid, idx, n)
        first = _segment_extreme(idx, gid, num_segments, "amin")
        return values[first.clamp(0, n - 1)]
    raise ValueError(kind)


def _max_sentinel(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True  # bool_and identity
    return torch.iinfo(dtype).max


def _min_sentinel(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False  # bool_or identity
    return torch.iinfo(dtype).min


def next_pow2(n: int, floor: int = 1024) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


def _i64_const(c: int) -> int:
    """A uint64 constant as the int64 with the same bit pattern."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr_logical(u: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (arithmetic shift, then
    clear the sign-extended high bits)."""
    return (u >> s) & ((1 << (64 - s)) - 1)


def splitmix64(u: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 tensors holding uint64 bit
    patterns; int64 multiplies wrap mod 2**64 exactly as the JAX package's
    uint64 arithmetic does, so the output bits are identical."""
    u = u.to(torch.int64)
    u = (u ^ _shr_logical(u, 30)) * _i64_const(0xBF58476D1CE4E5B9)
    u = (u ^ _shr_logical(u, 27)) * _i64_const(0x94D049BB133111EB)
    return u ^ _shr_logical(u, 31)

"""Column: a typed device tensor plus optional validity mask.

Port of trino_tpu/columnar/column.py.  Values are dense fixed-width
tensors on one device; dictionary encoding lives in the Column's
`dictionary` metadata (host-side, order-preserving), so string comparisons
and sorts run on int32 codes.  A long decimal is an int64 [capacity, 2]
tensor of (hi, lo) limb planes (types/int128.py).  An array column is a
rectangular [capacity, K] block (K padded element slots, a power of two
where the engine chooses it) plus `lengths`, the int32 [capacity] element
count of each row; a map column is [capacity, 2K], the key plane then the
value plane, with `lengths` counting entries (types.MapType).  So
`lengths is not None` tells an array or map from a [capacity, 2] long
decimal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar.dictionary import StringDictionary
from trino_tpu_torch.types import Type

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a SQL type's numpy device dtype."""
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def take_table(table, index: torch.Tensor) -> torch.Tensor:
    """table[index] along the first axis, on the index's device, with the
    index clamped into range (the JAX package's take(mode="clip")): a
    host table (dictionary recode codes, per-entry results) gathered by
    code.  A NULL row's code may be anything."""
    t = torch.from_numpy(np.ascontiguousarray(table)).to(index.device)
    return t[index.to(torch.int64).clamp(0, max(t.shape[0] - 1, 0))]


def pad_slots(x: torch.Tensor, extra: int) -> torch.Tensor:
    """Append `extra` zero element slots to the trailing axis of an
    array block (any dtype, bool included)."""
    if extra <= 0:
        return x
    zeros = torch.zeros(x.shape[:-1] + (extra,), dtype=x.dtype, device=x.device)
    return torch.cat([x, zeros], dim=-1)


class Column:
    __slots__ = ("data", "valid", "type", "dictionary", "lengths")

    def __init__(
        self,
        data: torch.Tensor,
        type: Type,
        valid: Optional[torch.Tensor] = None,
        dictionary: Optional[StringDictionary] = None,
        lengths: Optional[torch.Tensor] = None,
    ):
        self.data = data
        self.type = type
        self.valid = valid  # None => no nulls
        self.dictionary = dictionary
        # array/map columns: per-row element (entry) count, int32 [capacity]
        self.lengths = lengths

    # -- shape ---------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    # -- construction --------------------------------------------------------

    @classmethod
    def from_numpy(
        cls,
        values: np.ndarray,
        type: Type,
        valid: Optional[np.ndarray] = None,
        dictionary: Optional[StringDictionary] = None,
        device: torch.device = torch.device("cpu"),
    ) -> "Column":
        data = torch.from_numpy(
            np.ascontiguousarray(values, dtype=type.np_dtype)
        ).to(device)
        v = None
        if valid is not None:
            v = torch.from_numpy(np.ascontiguousarray(valid, dtype=bool)).to(device)
        return cls(data, type, v, dictionary)

    # -- transforms (shape preserving) ---------------------------------------

    def gather(self, indices: torch.Tensor) -> "Column":
        """Row gather; indices are clamped into range (the JAX package's
        take(mode="clip"))."""
        idx = indices.clamp(0, max(self.capacity - 1, 0))
        return self.map_rows(lambda x: x[idx])

    def map_rows(self, fn) -> "Column":
        """Apply one row transform (a gather, a slice, a device move, a
        reshape of the row axes) to data, validity and lengths alike."""
        return Column(
            fn(self.data),
            self.type,
            None if self.valid is None else fn(self.valid),
            self.dictionary,
            None if self.lengths is None else fn(self.lengths),
        )

    def valid_mask(self) -> torch.Tensor:
        """Always-materialized bool mask (shape [capacity])."""
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool, device=self.data.device)
        return self.valid

    def to(self, device, non_blocking: bool = False) -> "Column":
        return self.map_rows(lambda x: x.to(device, non_blocking=non_blocking))

    # -- host-side materialization ------------------------------------------

    def to_numpy(self) -> tuple[np.ndarray, Optional[np.ndarray]]:
        data = self.data.cpu().numpy()
        valid = None if self.valid is None else self.valid.cpu().numpy()
        return data, valid

    def to_pylist(self, row_mask: Optional[np.ndarray] = None) -> list:
        """Decode to python objects (strings/decimals/dates rendered)."""
        data, valid = self.to_numpy()
        lengths = None if self.lengths is None else self.lengths.cpu().numpy()
        return decode_values(
            data, valid, self.type, self.dictionary, row_mask, lengths
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Column({self.type.name}, cap={self.capacity}, "
            f"nulls={self.valid is not None}, device={self.data.device})"
        )


def decode_values(data, valid, t: Type, dictionary, row_mask=None, lengths=None) -> list:
    """Host numpy column -> python values (the JAX package's
    Column.to_pylist): arrays decode to lists, maps to dicts."""
    from trino_tpu_torch.types import ArrayType, MapType

    n = data.shape[0]
    rows = range(n) if row_mask is None else np.nonzero(np.asarray(row_mask))[0]
    if lengths is not None:
        out = []
        if isinstance(t, MapType):
            k = data.shape[1] // 2
            kd = dictionary if T.is_string_kind(t.key) else None
            vd = dictionary if T.is_string_kind(t.value) else None
            for i in rows:
                if valid is not None and not valid[i]:
                    out.append(None)
                    continue
                m = int(lengths[i])
                keys = decode_values(data[i, :k][:m], None, t.key, kd)
                vals = decode_values(data[i, k:][:m], None, t.value, vd)
                out.append(dict(zip(keys, vals)))
            return out
        elem = t.element if isinstance(t, ArrayType) else t
        for i in rows:
            if valid is not None and not valid[i]:
                out.append(None)
            else:
                out.append(
                    decode_values(data[i, : int(lengths[i])], None, elem, dictionary)
                )
        return out
    conv = _scalar_decoder(t, data, dictionary)
    if row_mask is not None:
        data = data[rows]
        valid = None if valid is None else np.asarray(valid)[rows]
    raw = data.tolist()
    if valid is None:
        return raw if conv is None else [conv(v) for v in raw]
    if conv is None:
        return [v if ok else None for v, ok in zip(raw, np.asarray(valid).tolist())]
    return [conv(v) if ok else None for v, ok in zip(raw, np.asarray(valid).tolist())]


def _scalar_decoder(t: Type, data: np.ndarray, dictionary):
    """The per-value conversion of one scalar column's host values (as
    `tolist()` gives them) to python values, or None where they already
    are (integers, floats, booleans)."""
    import datetime
    from decimal import Context, Decimal

    from trino_tpu_torch.types import (
        DATE,
        TIMESTAMP,
        DecimalType,
        unpack_tz_millis,
        unpack_tz_offset,
    )

    if dictionary is not None:
        values = dictionary.values
        return lambda v: values[v]
    if isinstance(t, DecimalType):
        if t.is_long and data.ndim == 2:
            from trino_tpu_torch.types.int128 import join_py

            # the default 28-digit context rounds 29+ digit values
            ctx = Context(prec=60)
            return lambda v: Decimal(join_py(v[0], v[1])).scaleb(-t.scale, context=ctx)
        return lambda v: Decimal(v).scaleb(-t.scale)
    if t is DATE:
        epoch, dates = datetime.date(1970, 1, 1), {}

        def date(v):
            d = dates.get(v)
            if d is None:
                d = dates[v] = epoch + datetime.timedelta(days=v)
            return d

        return date
    if t is TIMESTAMP:
        epoch_ts = datetime.datetime(1970, 1, 1)
        return lambda v: epoch_ts + datetime.timedelta(microseconds=v)
    if t.name == "time":
        epoch_ts = datetime.datetime(1970, 1, 1)
        return lambda v: (
            epoch_ts + datetime.timedelta(microseconds=v % 86_400_000_000)
        ).time()
    if t.name == "interval year to month":
        def year_month(mo):
            sign = "-" if mo < 0 else ""
            return f"{sign}{abs(mo) // 12}-{abs(mo) % 12}"

        return year_month
    if t.name == "interval day to second":
        def day_second(us):
            sign = "-" if us < 0 else ""
            d_, rem = divmod(abs(us), 86_400_000_000)
            h_, rem = divmod(rem, 3_600_000_000)
            m_, rem = divmod(rem, 60_000_000)
            s_, frac = divmod(rem, 1_000_000)
            return f"{sign}{d_} {h_:02d}:{m_:02d}:{s_:02d}.{frac // 1000:03d}"

        return day_second
    if t.name == "timestamp with time zone":
        # the instant, shown in the value's own zone offset
        def tz_value(p):
            tz = datetime.timezone(datetime.timedelta(minutes=int(unpack_tz_offset(p))))
            return datetime.datetime.fromtimestamp(unpack_tz_millis(p) / 1000.0, tz)

        return tz_value
    return None

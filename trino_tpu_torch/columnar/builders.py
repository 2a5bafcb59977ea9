"""Batch builders: python rows -> device Batches.

Port of trino_tpu/columnar/builders.py (reference role: RowPagesBuilder
and the connector-side PageBuilder).  Values are converted on the host
with numpy exactly as the JAX package does, then copied to the device.
"""

from __future__ import annotations

import datetime
from decimal import Context, Decimal
from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar.batch import Batch
from trino_tpu_torch.columnar.column import Column
from trino_tpu_torch.columnar.dictionary import StringDictionary
from trino_tpu_torch.types import (
    DATE,
    TIMESTAMP,
    TIMESTAMP_TZ,
    DecimalType,
    Type,
    is_string_kind,
    pack_tz,
)

_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)


def _to_device_scalar(v, t: Type):
    if isinstance(t, DecimalType):
        if isinstance(v, Decimal):
            return int(v.scaleb(t.scale).to_integral_value())
        return int(round(float(v) * t.scale_factor))
    if t is DATE and isinstance(v, datetime.date):
        return (v - _EPOCH_DATE).days
    if t is TIMESTAMP and isinstance(v, datetime.datetime):
        return int((v - _EPOCH_TS).total_seconds() * 1_000_000)
    if t.name == "time" and isinstance(v, datetime.time):
        return (v.hour * 3600 + v.minute * 60 + v.second) * 1_000_000 + v.microsecond
    if t is TIMESTAMP_TZ and isinstance(v, datetime.datetime):
        off = v.utcoffset()
        off_min = int(off.total_seconds() // 60) if off is not None else 0
        utc = v.replace(tzinfo=None) - datetime.timedelta(minutes=off_min)
        # timedelta floor division: total_seconds() * 1000 as a float
        # truncates toward zero and puts every pre-epoch fractional value
        # 1 ms high
        millis = (utc - _EPOCH_TS) // datetime.timedelta(milliseconds=1)
        return pack_tz(millis, off_min)
    return v


def column_from_values(values: Sequence, t: Type, device: torch.device) -> Column:
    n = len(values)
    valid_list = [v is not None for v in values]
    has_nulls = not all(valid_list)
    valid = np.array(valid_list, dtype=bool) if has_nulls else None
    if is_string_kind(t) or t.is_dictionary_encoded:
        present = sorted({v for v in values if v is not None})
        d = StringDictionary(present)
        codes = d.encode(list(values))
        return Column.from_numpy(codes, t, valid, d, device=device)
    if isinstance(t, DecimalType) and t.is_long:
        # long decimal: [n, 2] int64 limb planes (types/int128.py)
        from trino_tpu_torch.types.int128 import split_py

        arr2 = np.zeros((n, 2), dtype=np.int64)
        # the default 28-digit context would round 29+ digit values
        ctx = Context(prec=60)
        for i, v in enumerate(values):
            if v is None:
                continue
            if isinstance(v, Decimal):
                scaled = int(
                    v.scaleb(t.scale, context=ctx).to_integral_value(context=ctx)
                )
            elif isinstance(v, int):
                scaled = v * t.scale_factor
            else:
                scaled = int(round(float(v) * t.scale_factor))
            arr2[i, 0], arr2[i, 1] = split_py(scaled)
        return Column.from_numpy(arr2, t, valid, device=device)
    if t is DATE and _all_plain_dates(values):
        # days since the epoch by ordinal, without the per-value dispatch
        epoch = _EPOCH_DATE.toordinal()
        days = np.fromiter(
            (epoch if v is None else v.toordinal() for v in values), np.int64, n
        )
        return Column.from_numpy((days - epoch).astype(t.np_dtype), t, valid, device=device)
    if not has_nulls and not isinstance(t, DecimalType):
        try:
            return Column.from_numpy(
                np.asarray(values, dtype=t.np_dtype), t, None, device=device
            )
        except (TypeError, ValueError):
            pass  # date/timestamp objects: per-value conversion below
    arr = np.zeros(n, dtype=t.np_dtype)
    for i, v in enumerate(values):
        if v is not None:
            arr[i] = _to_device_scalar(v, t)
    return Column.from_numpy(arr, t, valid, device=device)


def _all_plain_dates(values) -> bool:
    """Every non-NULL value is a datetime.date (not a datetime, a string or
    a day number, which the per-value conversion handles)."""
    return all(type(v) is datetime.date for v in values if v is not None)


def batch_from_rows(
    types: Sequence[Type], rows: Sequence[Sequence], device: torch.device
) -> Batch:
    if not types:
        # zero-column batch (e.g. SELECT without FROM): row count rides the mask
        return Batch([], torch.ones(len(rows), dtype=torch.bool, device=device))
    cols = [
        column_from_values([r[ch] for r in rows], t, device)
        for ch, t in enumerate(types)
    ]
    return Batch(cols)

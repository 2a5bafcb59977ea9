"""Statement protocol: JSON wire shapes + value serde.

Reference: client/trino-client's QueryResults JSON (id, columns, data,
nextUri, stats, error) as produced by server/protocol/Query.java; values are
JSON-encoded per type exactly enough for the bundled client/CLI to round-trip
(decimals as strings, dates/timestamps ISO, varbinary hex).

Port of trino_tpu/server/protocol.py: a copy.  The port's result types
carry the JAX package's names (decimal(p,s), date, timestamp, timestamp
with time zone, time, the interval types, varbinary, array(...), map(...))
and its rows the same Python values, so a page decodes alike from either
coordinator: decimals, dates, timestamps and varbinary back to their
values, every other value as the JSON it was sent as (a time, an interval,
a tz timestamp, an array or a map as its string).
"""

from __future__ import annotations

import datetime
from decimal import Decimal
from typing import Any, Optional, Sequence


def encode_value(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, Decimal):
        return str(v)
    if isinstance(v, datetime.datetime):
        return v.isoformat(sep=" ")
    if isinstance(v, datetime.date):
        return v.isoformat()
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).hex()
    return str(v)


def decode_value(v: Any, type_name: str) -> Any:
    if v is None:
        return None
    if type_name.startswith("decimal"):
        return Decimal(v)
    if type_name == "date":
        return datetime.date.fromisoformat(v)
    if type_name == "timestamp":
        return datetime.datetime.fromisoformat(v)
    if type_name == "varbinary":
        return bytes.fromhex(v)
    return v


def encode_rows(rows: Sequence[Sequence]) -> list:
    return [[encode_value(v) for v in r] for r in rows]


def decode_rows(rows: Sequence[Sequence], columns: Sequence[dict]) -> list:
    names = [c["type"] for c in columns]
    return [
        tuple(decode_value(v, t) for v, t in zip(r, names)) for r in rows
    ]


def query_results(
    query_id: str,
    *,
    columns: Optional[list] = None,
    data: Optional[list] = None,
    next_uri: Optional[str] = None,
    state: str = "RUNNING",
    error: Optional[dict] = None,
    stats: Optional[dict] = None,
) -> dict:
    out = {
        "id": query_id,
        "stats": {"state": state, **(stats or {})},
    }
    if columns is not None:
        out["columns"] = columns
    if data is not None:
        out["data"] = data
    if next_uri is not None:
        out["nextUri"] = next_uri
    if error is not None:
        out["error"] = error
    return out

"""ORC writer: engine host columns -> one ORC file, file version 0.12
(reference: lib/trino-orc's OrcWriter, its ColumnWriter family and
OrcOutputBuffer).

The ORC types are those `pyarrow.orc.write_table` gives the Arrow table the
JAX package builds from the same columns (`_column_data_to_arrow` in its
connectors/parquet.py), so `table_metadata` agrees across the packages:
BOOLEAN, BYTE/SHORT/INT/LONG by the values' width, FLOAT, DOUBLE,
DECIMAL(p,s), DATE, TIMESTAMP (from microseconds, writer zone GMT) and
STRING.  Integers, dates, decimal scales and timestamps are integer RLE v2
(`rle.encode_int_rle_v2`); booleans and bytes are byte RLE; strings are
DICTIONARY_V2 straight from the engine's dictionary codes, each stripe's
dictionary holding the values that stripe uses; a PRESENT stream is written
only where a stripe has NULLs.  Stripes are cut every `stripe_rows` rows
(pyarrow cuts them by bytes), with no row index (`rowIndexStride` 0).  Each
column's statistics carry `numberOfValues` and `hasNull`.  Streams are ZLIB
(level 1) by default, or NONE.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.api import ColumnData
from trino_tpu_torch.formats.orc import compression as cz
from trino_tpu_torch.formats.orc import metadata as md
from trino_tpu_torch.formats.orc import rle
from trino_tpu_torch.formats.orc.protobuf import write_message
from trino_tpu_torch.formats.orc.reader import ORC_EPOCH_S

SOFTWARE_VERSION = "trino_tpu_torch orc writer"
#: orc_proto's writer id of Trino
WRITER_ID = 4
#: ORC-135 fixed: what current writers stamp
WRITER_VERSION = 6
#: the zone stamped in each stripe footer (timestamps are written as UTC)
WRITER_TIMEZONE = "GMT"
_WRITE_CODECS = {"ZLIB": cz.ZLIB, "NONE": cz.NONE}
_KIND_OF_DTYPE = {
    np.dtype(np.bool_): md.BOOLEAN, np.dtype(np.int8): md.BYTE,
    np.dtype(np.int16): md.SHORT, np.dtype(np.int32): md.INT,
    np.dtype(np.int64): md.LONG, np.dtype(np.float32): md.FLOAT,
    np.dtype(np.float64): md.DOUBLE,
}


def orc_type(t: T.Type, cd: ColumnData) -> dict:
    """The ORC Type message of one engine column."""
    if cd.dictionary is not None or T.is_string_kind(t):
        return {"kind": md.STRING}
    if isinstance(t, T.DecimalType):
        return {"kind": md.DECIMAL, "precision": t.precision, "scale": t.scale}
    if t is T.DATE:
        return {"kind": md.DATE}
    if t is T.TIMESTAMP:
        return {"kind": md.TIMESTAMP}
    vals = np.asarray(cd.values)
    if vals.ndim != 1:
        raise NotImplementedError(
            f"orc writer: a {t.name} column (array or map values) is not supported")
    kind = _KIND_OF_DTYPE.get(vals.dtype)
    if kind is None:
        raise NotImplementedError(f"orc writer: {t.name} values of dtype {vals.dtype}")
    return {"kind": kind}


def _format_nanos(nanos: np.ndarray) -> np.ndarray:
    """Nanoseconds (signed) -> ORC's SECONDARY values: the value without its
    trailing decimal zeros, shifted left 3, over (zeros - 1) when there are 2
    or more; a negative value keeps its sign, as Arrow's ORC writer has it."""
    sign = np.where(nanos < 0, -1, 1)
    m = np.abs(nanos)
    trailing = (m % 100 == 0) & (m != 0)
    m2 = m // 100
    z = np.ones(len(m), np.int64)
    for _ in range(6):
        more = trailing & (m2 % 10 == 0) & (z < 7)
        m2 = np.where(more, m2 // 10, m2)
        z = z + more
    return np.where(trailing, ((sign * m2) << 3) | z, nanos << 3)


def _column_streams(ty: dict, cd: ColumnData, start: int, stop: int) -> tuple:
    """Encode rows [start, stop) of one column -> ([(stream kind, bytes)],
    ColumnEncoding, non-null count)."""
    kind = ty["kind"]
    valid = None if cd.valid is None else np.asarray(cd.valid, bool)[start:stop]
    values = np.asarray(cd.values)[start:stop]
    streams = []
    if valid is not None and not valid.all():
        streams.append((md.PRESENT, rle.encode_boolean_rle(valid)))
        values = values[valid]
    nn = len(values)
    if kind == md.STRING:
        codes = np.asarray(values, np.int64)
        used, idx = np.unique(codes, return_inverse=True)
        dvals = cd.dictionary.values if cd.dictionary is not None else ()
        entries = [dvals[i].encode("utf-8") for i in used.tolist()]
        lengths = np.fromiter((len(e) for e in entries), np.int64, len(entries))
        streams.append((md.DATA, rle.encode_int_rle_v2(idx.reshape(-1), False)))
        streams.append((md.DICTIONARY_DATA, b"".join(entries)))
        streams.append((md.LENGTH, rle.encode_int_rle_v2(lengths, False)))
        return streams, {"kind": md.DICTIONARY_V2, "dictionarySize": len(entries)}, nn
    if kind == md.BOOLEAN:
        streams.append((md.DATA, rle.encode_boolean_rle(values)))
        return streams, {"kind": md.DIRECT}, nn
    if kind == md.BYTE:
        streams.append((md.DATA, rle.encode_byte_rle(values.view(np.uint8))))
        return streams, {"kind": md.DIRECT}, nn
    if kind in (md.FLOAT, md.DOUBLE):
        dt = "<f4" if kind == md.FLOAT else "<f8"
        streams.append((md.DATA, np.ascontiguousarray(values, dt).tobytes()))
        return streams, {"kind": md.DIRECT}, nn
    if kind == md.DECIMAL:
        v = np.asarray(values, np.int64)
        if v.ndim == 2:
            hi, lo = v[:, 0], v[:, 1]
        else:
            hi, lo = v >> 63, v
        streams.append((md.DATA, rle.encode_decimal_varints(hi, lo)))
        scales = np.full(nn, ty["scale"], np.int64)
        streams.append((md.SECONDARY, rle.encode_int_rle_v2(scales, True)))
        return streams, {"kind": md.DIRECT_V2}, nn
    if kind == md.TIMESTAMP:
        micros = np.asarray(values, np.int64)
        # seconds toward zero and nanoseconds of the value's sign, as Arrow's
        # ORC writer splits them: every ORC reader reads them back whole
        secs = np.where(micros < 0, -(-micros // 1_000_000), micros // 1_000_000)
        nanos = (micros - secs * 1_000_000) * 1000
        streams.append((md.DATA, rle.encode_int_rle_v2(secs - ORC_EPOCH_S, True)))
        streams.append((md.SECONDARY, rle.encode_int_rle_v2(_format_nanos(nanos), False)))
        return streams, {"kind": md.DIRECT_V2}, nn
    # SHORT, INT, LONG, DATE
    streams.append((md.DATA, rle.encode_int_rle_v2(np.asarray(values, np.int64), True)))
    return streams, {"kind": md.DIRECT_V2}, nn


def write_columns(dest, names: Sequence[str], types: Sequence[T.Type],
                  columns: Sequence[ColumnData], stripe_rows: int = 1 << 20,
                  codec: str = "ZLIB") -> int:
    """Write one table (a ColumnData per column, all rows) as an ORC file to
    `dest` (a path or a binary file object).  Returns the bytes written."""
    if codec not in _WRITE_CODECS:
        raise NotImplementedError(
            f"orc writer codec {codec}: not supported (ZLIB and NONE are)")
    if isinstance(dest, (str, os.PathLike)):
        with open(dest, "wb") as fh:
            return _write(fh, names, types, columns, stripe_rows, _WRITE_CODECS[codec])
    return _write(dest, names, types, columns, stripe_rows, _WRITE_CODECS[codec])


def _write(fh, names, types, columns, stripe_rows, cid) -> int:
    columns = list(columns)
    names = list(names)
    nrows = len(columns[0].values) if columns else 0
    col_types = [orc_type(t, cd) for t, cd in zip(types, columns)]
    offset = 0

    def emit(b: bytes) -> None:
        nonlocal offset
        fh.write(b)
        offset += len(b)

    def framed(b: bytes) -> bytes:
        return cz.compress(cid, b)

    emit(md.MAGIC)
    stripes = []
    stripe_stats = []
    values = [0] * len(columns)
    has_null = [False] * len(columns)
    for r0 in range(0, nrows, stripe_rows):
        r1 = min(r0 + stripe_rows, nrows)
        start = offset
        streams = []
        encodings = [{"kind": md.DIRECT}]
        col_stats = [{"numberOfValues": r1 - r0, "hasNull": False}]
        for i, (ty, cd) in enumerate(zip(col_types, columns)):
            parts, enc, nn = _column_streams(ty, cd, r0, r1)
            for kind, raw in parts:
                body = framed(raw)
                emit(body)
                streams.append({"kind": kind, "column": i + 1, "length": len(body)})
            encodings.append(enc)
            col_stats.append({"numberOfValues": nn, "hasNull": nn < r1 - r0})
            values[i] += nn
            has_null[i] = has_null[i] or nn < r1 - r0
        data_len = offset - start
        footer = framed(write_message(md.STRIPE_FOOTER, {
            "streams": streams, "columns": encodings, "writerTimezone": WRITER_TIMEZONE}))
        emit(footer)
        stripes.append({"offset": start, "indexLength": 0, "dataLength": data_len,
                        "footerLength": len(footer), "numberOfRows": r1 - r0})
        stripe_stats.append({"colStats": col_stats})
    content = offset
    metadata = framed(write_message(md.METADATA, {"stripeStats": stripe_stats}))
    emit(metadata)
    root = {"kind": md.STRUCT, "subtypes": list(range(1, len(names) + 1)),
            "fieldNames": names}
    statistics = [{"numberOfValues": nrows, "hasNull": False}] + [
        {"numberOfValues": v, "hasNull": h} for v, h in zip(values, has_null)]
    footer = framed(write_message(md.FOOTER, {
        "headerLength": len(md.MAGIC), "contentLength": content, "stripes": stripes,
        "types": [root] + col_types, "numberOfRows": nrows, "statistics": statistics,
        "rowIndexStride": 0, "writer": WRITER_ID, "softwareVersion": SOFTWARE_VERSION}))
    emit(footer)
    ps = write_message(md.POSTSCRIPT, {
        "footerLength": len(footer), "compression": cid,
        "compressionBlockSize": cz.BLOCK_SIZE, "version": [0, 12],
        "metadataLength": len(metadata), "writerVersion": WRITER_VERSION, "magic": "ORC"})
    emit(ps)
    emit(bytes((len(ps),)))
    return offset

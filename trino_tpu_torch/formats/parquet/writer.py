"""Parquet writer: engine host columns -> one Parquet file (reference:
lib/trino-parquet's ParquetWriter and its PrimitiveColumnWriter).

One column chunk per row group, data pages v1, every field OPTIONAL with
RLE definition levels (pyarrow's fields are nullable, so both packages
write the same schema).  Fixed-width values are PLAIN; strings are
RLE_DICTIONARY straight from the engine's dictionary codes, each chunk's
dictionary page holding the values that chunk uses.  The logical types are
those from which pyarrow derives the Arrow types the JAX package maps back
to the same engine types: INT(8/16) for TINYINT/SMALLINT, DECIMAL on
FIXED_LEN_BYTE_ARRAY (pyarrow's layout), DATE, TIMESTAMP(MICROS, not
UTC-adjusted), STRING.  Pages are GZIP-compressed (zlib level 1) by
default, or UNCOMPRESSED; the writer has no snappy encoder.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.connectors.api import ColumnData
from trino_tpu_torch.formats.parquet import thrift as th
from trino_tpu_torch.formats.parquet.compression import compress
from trino_tpu_torch.formats.parquet.encodings import bit_width, encode_hybrid, encode_plain

CREATED_BY = "trino_tpu_torch parquet writer"
#: rows per data page
PAGE_ROWS = 1 << 17
_CODECS = {"GZIP": th.GZIP, "UNCOMPRESSED": th.UNCOMPRESSED}


def decimal_bytes(precision: int) -> int:
    """FIXED_LEN_BYTE_ARRAY width of a decimal (the fewest bytes whose two's
    complement holds 10**precision - 1, as pyarrow sizes it)."""
    w = 1
    while 10 ** precision > 1 << (8 * w - 1):
        w += 1
    return w


class _Layout:
    """How one engine column is stored: physical type and annotations."""

    __slots__ = ("physical", "element", "dictionary", "width")

    def __init__(self, physical, element=None, dictionary=False, width=0):
        self.physical = physical
        self.element = element or {}
        self.dictionary = dictionary
        self.width = width


def _layout(t: T.Type, cd: ColumnData) -> _Layout:
    if cd.dictionary is not None or T.is_string_kind(t):
        return _Layout(th.BYTE_ARRAY, {"converted_type": th.CT["UTF8"],
                                       "logicalType": {"STRING": {}}}, dictionary=True)
    if isinstance(t, T.DecimalType):
        w = decimal_bytes(t.precision)
        return _Layout(th.FIXED_LEN_BYTE_ARRAY, {
            "type_length": w, "converted_type": th.CT["DECIMAL"],
            "scale": t.scale, "precision": t.precision,
            "logicalType": {"DECIMAL": {"scale": t.scale, "precision": t.precision}},
        }, width=w)
    if t is T.DATE:
        return _Layout(th.INT32, {"converted_type": th.CT["DATE"], "logicalType": {"DATE": {}}})
    if t is T.TIMESTAMP:
        return _Layout(th.INT64, {"logicalType": {"TIMESTAMP": {
            "isAdjustedToUTC": False, "unit": {"MICROS": {}}}}})
    vals = np.asarray(cd.values)
    if vals.ndim != 1:
        raise NotImplementedError(
            f"parquet writer: a {t.name} column (array or map values) is not "
            "supported"
        )
    dt = vals.dtype
    if dt == np.bool_:
        return _Layout(th.BOOLEAN)
    if dt in (np.int8, np.int16):
        bits = dt.itemsize * 8
        return _Layout(th.INT32, {
            "converted_type": th.CT[f"INT_{bits}"],
            "logicalType": {"INTEGER": {"bitWidth": bits, "isSigned": True}},
        })
    if dt == np.int32:
        return _Layout(th.INT32)
    if dt == np.int64:
        return _Layout(th.INT64)
    if dt == np.float32:
        return _Layout(th.FLOAT)
    if dt == np.float64:
        return _Layout(th.DOUBLE_T)
    raise NotImplementedError(f"parquet writer: {t.name} values of dtype {dt}")


def _decimal_flba(values: np.ndarray, width: int) -> np.ndarray:
    """Unscaled decimals (int64, or [n, 2] hi/lo limbs) -> big-endian two's
    complement [n, width] bytes."""
    v = np.asarray(values, np.int64)
    if v.ndim == 1:
        hi, lo = v >> 63, v
    else:
        hi, lo = v[:, 0], v[:, 1]
    le = np.empty((len(v), 2), "<i8")
    le[:, 0] = lo
    le[:, 1] = hi
    be = le.view(np.uint8).reshape(len(v), 16)[:, ::-1]
    return np.ascontiguousarray(be[:, 16 - width:])


def concat_columns(parts: Sequence[ColumnData], t: T.Type) -> ColumnData:
    """Concatenate page columns of one engine column; string codes move onto
    the union of the pages' dictionaries."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    valid = None
    if any(p.valid is not None for p in parts):
        valid = np.concatenate([
            np.ones(len(p.values), bool) if p.valid is None else np.asarray(p.valid, bool)
            for p in parts
        ])
    dicts = [p.dictionary for p in parts]
    if all(d is None for d in dicts):
        return ColumnData(np.concatenate([np.asarray(p.values) for p in parts]), valid)
    first = dicts[0]
    if all(d is first or d == first for d in dicts):
        return ColumnData(
            np.concatenate([np.asarray(p.values, np.int32) for p in parts]), valid, first
        )
    union = StringDictionary.from_unsorted(v for d in dicts for v in d.values)
    index = union.index
    codes = []
    for p in parts:
        vals = p.dictionary.values
        if not vals:
            codes.append(np.zeros(len(p.values), np.int32))
            continue
        remap = np.fromiter((index[v] for v in vals), np.int32, len(vals))
        c = np.clip(np.asarray(p.values, np.int64), 0, len(vals) - 1)
        codes.append(remap[c])
    return ColumnData(np.concatenate(codes), valid, union)


def _page(ptype_header: dict, body: bytes, codec: int) -> tuple:
    comp = compress(codec, body)
    header = dict(ptype_header)
    header["uncompressed_page_size"] = len(body)
    header["compressed_page_size"] = len(comp)
    raw = th.write_struct(th.PAGE_HEADER, header)
    return raw + comp, len(raw) + len(body)


def _chunk(cd: ColumnData, t: T.Type, layout: _Layout, start: int, stop: int,
           codec: int, page_rows: int):
    """Encode rows [start, stop) of one column -> (bytes, uncompressed size,
    dictionary page length or None, encodings)."""
    n = stop - start
    valid = None if cd.valid is None else np.asarray(cd.valid, bool)[start:stop]
    values = np.asarray(cd.values)[start:stop]
    pages = []
    usize = 0
    dict_len = None
    encodings = [th.PLAIN, th.RLE]
    if layout.dictionary:
        codes = values if valid is None else values[valid]
        used, idx = np.unique(np.asarray(codes, np.int64), return_inverse=True)
        dvals = cd.dictionary.values if cd.dictionary is not None else ()
        dict_page = encode_plain([dvals[i] for i in used.tolist()], th.BYTE_ARRAY)
        raw, u = _page({"type": th.DICTIONARY_PAGE, "dictionary_page_header": {
            "num_values": len(used), "encoding": th.PLAIN}}, dict_page, codec)
        pages.append(raw)
        usize += u
        dict_len = len(raw)
        width = max(1, bit_width(max(len(used) - 1, 0)))
        encodings.append(th.RLE_DICTIONARY)
        nonnull = idx
    elif layout.physical == th.FIXED_LEN_BYTE_ARRAY:
        nonnull = _decimal_flba(values if valid is None else values[valid], layout.width)
    else:
        nonnull = values if valid is None else values[valid]
    taken = 0
    for p0 in range(0, max(n, 1), page_rows):
        p1 = min(p0 + page_rows, n)
        if valid is None:
            levels = np.ones(p1 - p0, np.int64)
            nn = p1 - p0
        else:
            levels = valid[p0:p1].astype(np.int64)
            nn = int(levels.sum())
        lv = encode_hybrid(levels, 1)
        body = bytearray(len(lv).to_bytes(4, "little"))
        body += lv
        chunk_vals = nonnull[taken:taken + nn]
        taken += nn
        if layout.dictionary:
            body.append(width)
            body += encode_hybrid(chunk_vals, width)
            enc = th.RLE_DICTIONARY
        else:
            body += encode_plain(chunk_vals, layout.physical)
            enc = th.PLAIN
        raw, u = _page({"type": th.DATA_PAGE, "data_page_header": {
            "num_values": p1 - p0, "encoding": enc,
            "definition_level_encoding": th.RLE,
            "repetition_level_encoding": th.RLE}}, bytes(body), codec)
        pages.append(raw)
        usize += u
    return b"".join(pages), usize, dict_len, encodings


def write_columns(dest, names: Sequence[str], types: Sequence[T.Type],
                  columns: Sequence[ColumnData], row_group_rows: int = 1 << 20,
                  codec: str = "GZIP", page_rows: int = PAGE_ROWS) -> int:
    """Write one table (a ColumnData per column, all rows) as a Parquet file
    to `dest` (a path or a binary file object).  Returns the bytes written."""
    if codec not in _CODECS:
        raise NotImplementedError(
            f"parquet writer codec {codec}: not supported (GZIP and "
            "UNCOMPRESSED are)"
        )
    cid = _CODECS[codec]
    columns = list(columns)
    nrows = len(columns[0].values) if columns else 0
    layouts = [_layout(t, cd) for t, cd in zip(types, columns)]
    schema = [{"name": "schema", "num_children": len(names)}]
    for name, lay in zip(names, layouts):
        el = {"type": lay.physical, "repetition_type": th.OPTIONAL, "name": name}
        el.update(lay.element)
        schema.append(el)
    if isinstance(dest, (str, os.PathLike)):
        with open(dest, "wb") as fh:
            return _write(fh, names, types, columns, layouts, schema, nrows,
                          row_group_rows, cid, page_rows)
    return _write(dest, names, types, columns, layouts, schema, nrows,
                  row_group_rows, cid, page_rows)


def _write(fh, names, types, columns, layouts, schema, nrows, row_group_rows,
           cid, page_rows) -> int:
    offset = 0

    def emit(b: bytes):
        nonlocal offset
        fh.write(b)
        offset += len(b)

    emit(b"PAR1")
    row_groups = []
    for ordinal, r0 in enumerate(range(0, max(nrows, 1), row_group_rows)):
        r1 = min(r0 + row_group_rows, nrows)
        if r1 <= r0 and r0 > 0:
            break
        rg_start = offset
        chunks = []
        total_u = 0
        for name, t, cd, lay in zip(names, types, columns, layouts):
            start = offset
            raw, usize, dict_len, encs = _chunk(cd, t, lay, r0, r1, cid, page_rows)
            emit(raw)
            meta = {
                "type": lay.physical,
                "encodings": encs,
                "path_in_schema": [name],
                "codec": cid,
                "num_values": r1 - r0,
                "total_uncompressed_size": usize,
                "total_compressed_size": len(raw),
                "data_page_offset": start + (dict_len or 0),
                "dictionary_page_offset": start if dict_len is not None else None,
            }
            chunks.append({"file_offset": start, "meta_data": meta})
            total_u += usize
        row_groups.append({
            "columns": chunks,
            "total_byte_size": total_u,
            "num_rows": r1 - r0,
            "file_offset": rg_start,
            "total_compressed_size": offset - rg_start,
            "ordinal": ordinal,
        })
        if nrows == 0:
            break
    footer = th.write_struct(th.FILE_META_DATA, {
        "version": 2,
        "schema": schema,
        "num_rows": nrows,
        "row_groups": row_groups,
        "created_by": CREATED_BY,
    })
    emit(footer)
    emit(len(footer).to_bytes(4, "little"))
    emit(b"PAR1")
    return offset


"""Parquet reader: footer, schema, column chunks -> engine host columns
(reference: lib/trino-parquet ParquetReader / PageReader / the
ColumnReader family, and ParquetTypeUtils for the schema mapping).

The schema maps to engine types exactly as the JAX package maps the Arrow
schema that pyarrow derives from the same file (`_arrow_to_type` in its
connectors/parquet.py).  A row group's column chunks decode into
`ColumnData` as its `_array_to_column_data` does: a NULL is 0 (or False)
under a validity mask, strings carry a `StringDictionary` (one placeholder
entry for an all-NULL column), short decimals are exact unscaled int64,
long decimals the (hi, lo) limb pair, dates int32 day numbers and
timestamps microseconds.

The reader handles what pyarrow writes: data pages v1 and v2, dictionary
pages followed by PLAIN pages once a dictionary overflowed, RLE booleans,
and SNAPPY, GZIP or no compression.  What it does not support raises
NotImplementedError naming the codec, encoding, type or column.

Host seconds of decompression (by codec) and of decoding (by encoding) add
up in a process-wide record: `decode_stats()` / `reset_decode_stats()`.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional, Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.connectors.api import ColumnData, ColumnMeta
from trino_tpu_torch.formats.parquet import thrift as th
from trino_tpu_torch.formats.parquet.compression import decompress
from trino_tpu_torch.formats.parquet.encodings import (
    decode_hybrid,
    decode_plain,
    unsupported_encoding,
)

MAGIC = b"PAR1"
_U32 = struct.Struct("<I")

# -- decode statistics --------------------------------------------------------

_STATS_LOCK = threading.Lock()


def _fresh_stats() -> dict:
    return {
        "codec_s": {},
        "encoding_s": {},
        "compressed_bytes": 0,
        "uncompressed_bytes": 0,
        "pages": 0,
        "data_pages": {},
        "column_chunks": 0,
    }


_STATS = _fresh_stats()


def reset_decode_stats() -> None:
    global _STATS
    with _STATS_LOCK:
        _STATS = _fresh_stats()


def decode_stats() -> dict:
    """Host seconds of decompression by codec (`codec_s`) and of decoding by
    encoding (`encoding_s`; `RLE` covers definition levels and RLE
    booleans, `ENGINE_DICTIONARY` the sort of a string column's values into
    the engine's dictionary), bytes before and after decompression, pages
    (`data_pages` by their value encoding) and column chunks, since the
    last reset."""
    with _STATS_LOCK:
        s = dict(_STATS)
        s["codec_s"] = dict(_STATS["codec_s"])
        s["encoding_s"] = dict(_STATS["encoding_s"])
        s["data_pages"] = dict(_STATS["data_pages"])
        return s


class _ChunkStats:
    """One column chunk's tallies, merged into the process record once."""

    __slots__ = ("codec_s", "encoding_s", "cbytes", "ubytes", "pages", "data_pages")

    def __init__(self):
        self.codec_s = {}
        self.encoding_s = {}
        self.data_pages = {}
        self.cbytes = 0
        self.ubytes = 0
        self.pages = 0

    def enc(self, name: str, seconds: float) -> None:
        self.encoding_s[name] = self.encoding_s.get(name, 0.0) + seconds

    def merge(self) -> None:
        with _STATS_LOCK:
            for k, v in self.codec_s.items():
                _STATS["codec_s"][k] = _STATS["codec_s"].get(k, 0.0) + v
            for k, v in self.encoding_s.items():
                _STATS["encoding_s"][k] = _STATS["encoding_s"].get(k, 0.0) + v
            _STATS["compressed_bytes"] += self.cbytes
            _STATS["uncompressed_bytes"] += self.ubytes
            _STATS["pages"] += self.pages
            for k, v in self.data_pages.items():
                _STATS["data_pages"][k] = _STATS["data_pages"].get(k, 0) + v
            _STATS["column_chunks"] += 1


# -- schema -------------------------------------------------------------------


def _decimal_of(el: dict):
    lt = el.get("logicalType") or {}
    if "DECIMAL" in lt:
        return lt["DECIMAL"].get("precision", 0), lt["DECIMAL"].get("scale", 0)
    if el.get("converted_type") == th.CT["DECIMAL"]:
        return el.get("precision", 0), el.get("scale", 0)
    return None


def _timestamp_unit(el: dict) -> Optional[str]:
    lt = el.get("logicalType") or {}
    if "TIMESTAMP" in lt:
        unit = lt["TIMESTAMP"].get("unit") or {}
        for name in ("MILLIS", "MICROS", "NANOS"):
            if name in unit:
                return name
        return None
    ct = el.get("converted_type")
    if ct == th.CT["TIMESTAMP_MILLIS"]:
        return "MILLIS"
    if ct == th.CT["TIMESTAMP_MICROS"]:
        return "MICROS"
    return None


def _describe(el: dict) -> str:
    phys = th.PHYSICAL_TYPES[el["type"]] if "type" in el else "group"
    ann = []
    if el.get("logicalType"):
        ann.append("/".join(el["logicalType"]))
    if el.get("converted_type") is not None:
        ct = el["converted_type"]
        ann.append(th.CONVERTED_TYPES[ct] if ct < len(th.CONVERTED_TYPES) else str(ct))
    return phys + (f" ({', '.join(ann)})" if ann else "")


def _int_annotation(el: dict):
    """(bit width, signed) of an INTEGER / INT_n / UINT_n annotation."""
    lt = el.get("logicalType") or {}
    if "INTEGER" in lt:
        return lt["INTEGER"].get("bitWidth", 32), lt["INTEGER"].get("isSigned", True)
    ct = el.get("converted_type")
    names = {"INT_8": (8, True), "INT_16": (16, True), "INT_32": (32, True),
             "INT_64": (64, True), "UINT_8": (8, False), "UINT_16": (16, False),
             "UINT_32": (32, False), "UINT_64": (64, False)}
    for name, v in names.items():
        if ct == th.CT[name]:
            return v
    return None


def engine_type(el: dict) -> T.Type:
    """The engine type of a flat leaf, as the JAX package maps the Arrow type
    pyarrow derives from it."""
    name = el.get("name")
    phys = el.get("type")
    lt = el.get("logicalType") or {}
    ct = el.get("converted_type")
    dec = _decimal_of(el)
    if dec is not None and phys in (th.INT32, th.INT64, th.FIXED_LEN_BYTE_ARRAY, th.BYTE_ARRAY):
        p, s = dec
        if p > 38:
            raise NotImplementedError(f"decimal({p},{s}) exceeds precision 38")
        return T.DecimalType(p, s)
    if phys == th.BOOLEAN:
        return T.BOOLEAN
    if phys == th.INT32:
        if "DATE" in lt or ct == th.CT["DATE"]:
            return T.DATE
        ints = _int_annotation(el)
        if ints is not None:
            width, signed = ints
            if signed and width in (8, 16):
                return T.SMALLINT
            if signed and width == 32:
                return T.INTEGER
        elif not lt and ct is None:
            return T.INTEGER
    elif phys == th.INT64:
        if _timestamp_unit(el) is not None:
            return T.TIMESTAMP
        ints = _int_annotation(el)
        if (ints is None and not lt and ct is None) or ints == (64, True):
            return T.BIGINT
    elif phys == th.FLOAT:
        if not lt:
            return T.REAL
    elif phys == th.DOUBLE_T:
        if not lt:
            return T.DOUBLE
    elif phys == th.BYTE_ARRAY:
        if "STRING" in lt or ct == th.CT["UTF8"]:
            return T.VARCHAR
    raise NotImplementedError(
        f"parquet column {name!r} of type {_describe(el)}: not supported by "
        "the port's reader"
    )


def _value_dtype(el: dict):
    """The numpy dtype pyarrow would give the column's values (int8/int16
    for the narrow integer annotations, else the physical width)."""
    ints = _int_annotation(el)
    if el.get("type") == th.INT32 and ints in ((8, True), (16, True)):
        return np.dtype(np.int8 if ints[0] == 8 else np.int16)
    return None


class _Leaf:
    __slots__ = ("name", "element", "max_def", "index", "nested")

    def __init__(self, name, element, max_def, index, nested):
        self.name = name
        self.element = element
        self.max_def = max_def
        self.index = index
        self.nested = nested


def _leaves(schema: list) -> list:
    """Top-level fields of a flat schema; a group (nested) or repeated field
    is kept with `nested` set, and raises when its type is asked for."""
    if not schema:
        raise ValueError("parquet footer has an empty schema")
    out = []
    pos = 1
    leaf_index = 0
    for _ in range(schema[0].get("num_children", 0)):
        el = schema[pos]
        n_children = el.get("num_children") or 0
        nested = n_children > 0 or el.get("repetition_type") == th.REPEATED
        # skip the whole subtree of a group
        end = pos + 1
        pending = n_children
        leaf_count = 0 if n_children else 1
        while pending:
            child = schema[end]
            pending -= 1
            sub = child.get("num_children") or 0
            pending += sub
            if not sub:
                leaf_count += 1
            end += 1
        max_def = 1 if el.get("repetition_type", th.REQUIRED) == th.OPTIONAL else 0
        out.append(_Leaf(el.get("name"), el, max_def, leaf_index, nested))
        leaf_index += leaf_count
        pos = end
    return out


# -- the file -----------------------------------------------------------------


class ParquetFile:
    """One Parquet file: its footer, schema and row groups."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size < 12:
                raise ValueError(f"{path}: too small to be a parquet file")
            fh.seek(size - 8)
            tail = fh.read(8)
            if tail[4:] != MAGIC:
                raise ValueError(f"{path}: not a parquet file (no PAR1 footer)")
            flen = _U32.unpack(tail[:4])[0]
            fh.seek(size - 8 - flen)
            footer = fh.read(flen)
        self.metadata, _ = th.read_struct(footer, th.FILE_META_DATA)
        self.fields = _leaves(self.metadata.get("schema") or [])
        self._by_name = {f.name: f for f in self.fields}

    @property
    def num_rows(self) -> int:
        return int(self.metadata.get("num_rows", 0))

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.get("row_groups") or [])

    def row_group_rows(self, i: int) -> int:
        return int(self.metadata["row_groups"][i].get("num_rows", 0))

    def columns(self) -> list:
        """[ColumnMeta] of the file's top-level fields, mapped as the JAX
        package maps them (nested or unsupported fields raise)."""
        out = []
        for f in self.fields:
            if f.nested:
                raise NotImplementedError(
                    f"parquet column {f.name!r}: nested columns are not "
                    "supported by the port's reader"
                )
            out.append(ColumnMeta(f.name, engine_type(f.element)))
        return out

    def _field(self, name: str) -> _Leaf:
        f = self._by_name.get(name)
        if f is None:
            raise KeyError(f"parquet file {self.path} has no column {name!r}")
        if f.nested:
            raise NotImplementedError(
                f"parquet column {name!r}: nested columns are not supported "
                "by the port's reader"
            )
        return f

    def read_row_group(self, row_group: int, columns: Sequence[str],
                       types: Optional[Sequence[T.Type]] = None) -> list:
        """Decode one row group's chunks of `columns` into ColumnData, each
        in its engine type (`types`, else the file's own mapping)."""
        rg = self.metadata["row_groups"][row_group]
        nrows = int(rg.get("num_rows", 0))
        out = []
        with open(self.path, "rb") as fh:
            for i, name in enumerate(columns):
                f = self._field(name)
                t = types[i] if types is not None else engine_type(f.element)
                meta = rg["columns"][f.index]["meta_data"]
                start = meta.get("dictionary_page_offset")
                data_off = meta["data_page_offset"]
                if start is None or start <= 0 or start > data_off:
                    start = data_off
                fh.seek(start)
                raw = fh.read(int(meta["total_compressed_size"]))
                out.append(_decode_chunk(raw, meta, f, t, nrows))
        return out


# -- a column chunk -----------------------------------------------------------


def _decode_chunk(raw: bytes, meta: dict, field: _Leaf, t: T.Type, nrows: int) -> ColumnData:
    st = _ChunkStats()
    el = field.element
    phys = el["type"]
    codec = meta.get("codec", th.UNCOMPRESSED)
    codec_name = th.CODECS.get(codec, str(codec))
    strings = T.is_string_kind(t)
    type_length = el.get("type_length", 0) or 0
    total = int(meta.get("num_values", nrows))
    dictionary = None
    lookup = None  # str -> index into the chunk's values (strings only)
    pieces = []  # non-null values per page (ndarray, or index arrays for strings)
    defs = []  # definition levels per page (max_def > 0)
    seen = 0
    pos = 0
    buf = raw
    while seen < total:
        if pos >= len(buf):
            raise ValueError(
                f"parquet column {field.name!r}: chunk ended after {seen} of "
                f"{total} values"
            )
        header, pos = th.read_struct(buf, th.PAGE_HEADER, pos)
        csize = header["compressed_page_size"]
        usize = header["uncompressed_page_size"]
        body = buf[pos:pos + csize]
        pos += csize
        ptype = header["type"]
        st.pages += 1
        st.cbytes += csize
        st.ubytes += usize
        if ptype == th.DICTIONARY_PAGE:
            dh = header["dictionary_page_header"]
            t0 = time.perf_counter()
            page = decompress(codec, body, usize)
            st.codec_s[codec_name] = st.codec_s.get(codec_name, 0.0) + time.perf_counter() - t0
            enc = dh.get("encoding", th.PLAIN)
            if enc not in (th.PLAIN, th.PLAIN_DICTIONARY):
                raise unsupported_encoding(enc, f"dictionary page of {field.name!r}")
            t0 = time.perf_counter()
            dictionary = decode_plain(
                page, 0, len(page), phys, dh["num_values"], type_length, as_str=strings
            )
            if strings:
                lookup = {v: i for i, v in enumerate(dictionary)}
            elif isinstance(dictionary, list):  # BYTE_ARRAY decimals
                dictionary = np.array(dictionary, dtype=object)
            st.enc("PLAIN", time.perf_counter() - t0)
            continue
        if ptype == th.DATA_PAGE:
            dh = header["data_page_header"]
            t0 = time.perf_counter()
            page = decompress(codec, body, usize)
            st.codec_s[codec_name] = st.codec_s.get(codec_name, 0.0) + time.perf_counter() - t0
            n = dh["num_values"]
            vpos = 0
            if field.max_def:
                denc = dh.get("definition_level_encoding", th.RLE)
                if denc != th.RLE:
                    raise unsupported_encoding(denc, f"definition levels of {field.name!r}")
                t0 = time.perf_counter()
                ln = _U32.unpack_from(page, 0)[0]
                lv = decode_hybrid(page, 4, 4 + ln, 1, n)
                st.enc("RLE", time.perf_counter() - t0)
                vpos = 4 + ln
                defs.append(lv)
                nn = int(lv.sum())
            else:
                nn = n
            enc = dh["encoding"]
        elif ptype == th.DATA_PAGE_V2:
            dh = header["data_page_header_v2"]
            n = dh["num_values"]
            rl = dh.get("repetition_levels_byte_length", 0) or 0
            dl = dh.get("definition_levels_byte_length", 0) or 0
            if field.max_def:
                t0 = time.perf_counter()
                lv = decode_hybrid(body, rl, rl + dl, 1, n)
                st.enc("RLE", time.perf_counter() - t0)
                defs.append(lv)
                nn = int(lv.sum())
            else:
                nn = n
            values = body[rl + dl:]
            t0 = time.perf_counter()
            if dh.get("is_compressed", True):
                page = decompress(codec, values, usize - rl - dl)
            else:
                page = bytes(values)
            st.codec_s[codec_name] = st.codec_s.get(codec_name, 0.0) + time.perf_counter() - t0
            vpos = 0
            enc = dh["encoding"]
        else:  # index pages carry nothing to decode
            continue
        seen += n
        ename = th.ENCODINGS.get(enc, str(enc))
        st.data_pages[ename] = st.data_pages.get(ename, 0) + 1
        t0 = time.perf_counter()
        if enc in (th.PLAIN_DICTIONARY, th.RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(
                    f"parquet column {field.name!r}: dictionary-encoded page "
                    "without a dictionary page"
                )
            width = page[vpos]
            idx = decode_hybrid(page, vpos + 1, len(page), width, nn)
            pieces.append(idx if strings else dictionary[idx])
            st.enc(th.ENCODINGS[enc], time.perf_counter() - t0)
        elif enc == th.PLAIN:
            vals = decode_plain(page, vpos, len(page), phys, nn, type_length, as_str=strings)
            if strings:
                if lookup is None:
                    lookup = {}
                get = lookup.setdefault
                vals = np.fromiter((get(v, len(lookup)) for v in vals), np.int64, nn)
            elif isinstance(vals, list):  # BYTE_ARRAY decimals
                vals = np.array(vals, dtype=object)
            pieces.append(vals)
            st.enc("PLAIN", time.perf_counter() - t0)
        elif enc == th.RLE and phys == th.BOOLEAN:
            ln = _U32.unpack_from(page, vpos)[0]
            pieces.append(decode_hybrid(page, vpos + 4, vpos + 4 + ln, 1, nn).astype(bool))
            st.enc("RLE", time.perf_counter() - t0)
        else:
            raise unsupported_encoding(enc, f"data page of {field.name!r}")
    if total != nrows:
        raise ValueError(
            f"parquet column {field.name!r}: {total} values in a row group of "
            f"{nrows} rows (nested data is not supported)"
        )
    valid = None
    if defs:
        lv = np.concatenate(defs) if len(defs) > 1 else defs[0]
        if not lv.all():
            valid = lv.astype(bool)
    col = _to_column(pieces, valid, nrows, el, t, list(lookup or ()), st)
    st.merge()
    return col


def _concat(pieces):
    if not pieces:
        return np.zeros(0, np.int64)
    return np.concatenate(pieces) if len(pieces) > 1 else np.asarray(pieces[0])


_PHYSICAL_DTYPES = {
    th.BOOLEAN: np.bool_, th.INT32: np.int32, th.INT64: np.int64,
    th.FLOAT: np.float32, th.DOUBLE_T: np.float64,
}


def _no_values(el: dict) -> np.ndarray:
    """The decoded values of a chunk without data pages (no rows)."""
    if el["type"] == th.FIXED_LEN_BYTE_ARRAY:
        return np.zeros((0, el.get("type_length", 0) or 0), np.uint8)
    return np.zeros(0, _PHYSICAL_DTYPES.get(el["type"], np.int64))


def _spread(values: np.ndarray, valid, nrows: int, fill=0) -> np.ndarray:
    """Non-null values -> one value per row, `fill` at the NULLs."""
    if valid is None:
        return np.ascontiguousarray(values)
    out = np.full((nrows,) + values.shape[1:], fill, dtype=values.dtype)
    out[valid] = values
    return out


def _be_to_limbs(raw: np.ndarray) -> np.ndarray:
    """Big-endian two's complement [n, w] bytes (w <= 16) -> [n, 2] int64
    (hi, lo bit pattern)."""
    n, w = raw.shape
    if w > 16:
        raise NotImplementedError(f"parquet decimal of {w} bytes exceeds 16")
    full = np.zeros((n, 16), np.uint8)
    if w:
        full[:, 16 - w:] = raw
        neg = raw[:, 0] >= 0x80
        full[neg, : 16 - w] = 0xFF
    le = full[:, ::-1].copy()  # little-endian: lo word, then hi word
    words = le.view("<i8").reshape(n, 2)
    return np.stack([words[:, 1], words[:, 0]], axis=1)


def _be_to_int64(raw: np.ndarray) -> np.ndarray:
    """Big-endian two's complement [n, w] bytes (w <= 8) -> int64."""
    n, w = raw.shape
    full = np.zeros((n, 8), np.uint8)
    full[:, 8 - w:] = raw
    if w:
        full[raw[:, 0] >= 0x80, : 8 - w] = 0xFF
    return full.view(">i8").reshape(n).astype(np.int64)


def _decimal_unscaled(values, phys: int) -> np.ndarray:
    """Decoded decimal values (non-null) -> [n, 2] (hi, lo) limbs."""
    if phys in (th.INT32, th.INT64):
        v = np.asarray(values, np.int64)
        return np.stack([v >> 63, v], axis=1)
    if phys == th.FIXED_LEN_BYTE_ARRAY:
        return _be_to_limbs(np.asarray(values, np.uint8))
    # BYTE_ARRAY: variable-width big-endian two's complement, per value
    out = np.empty((len(values), 2), np.int64)
    for i, b in enumerate(values):
        v = int.from_bytes(b, "big", signed=True)
        out[i, 0] = v >> 64
        lo = v & ((1 << 64) - 1)
        out[i, 1] = lo - (1 << 64) if lo >= 1 << 63 else lo
    return out


def _to_column(pieces, valid, nrows, el, t, dict_values, st) -> ColumnData:
    phys = el["type"]
    if T.is_string_kind(t):
        if phys != th.BYTE_ARRAY:
            raise NotImplementedError(
                f"parquet column {el.get('name')!r}: {_describe(el)} read as {t.name}"
            )
        t0 = time.perf_counter()
        values = dict_values or [""]
        d = StringDictionary.from_unsorted(values)
        index = d.index
        remap = np.fromiter((index[v] for v in values), np.int32, len(values))
        idx = _concat(pieces)
        codes = _spread(remap[idx] if len(idx) else np.zeros(0, np.int32), valid, nrows)
        st.enc("ENGINE_DICTIONARY", time.perf_counter() - t0)
        return ColumnData(codes.astype(np.int32, copy=False), valid, d)
    vals = _concat(pieces) if pieces else _no_values(el)
    if isinstance(t, T.DecimalType):
        dec = _decimal_of(el)
        file_scale = dec[1] if dec is not None else 0
        if file_scale != t.scale:
            raise NotImplementedError(
                f"parquet column {el.get('name')!r}: a decimal of scale "
                f"{file_scale} read as {t.name}"
            )
        if not t.is_long and phys == th.FIXED_LEN_BYTE_ARRAY and vals.shape[1] <= 8:
            return ColumnData(_spread(_be_to_int64(vals), valid, nrows), valid)
        limbs = _decimal_unscaled(vals, phys)
        if t.is_long:
            return ColumnData(_spread(limbs, valid, nrows), valid, None)
        return ColumnData(_spread(limbs[:, 1].copy(), valid, nrows), valid)
    if t is T.DATE:
        return ColumnData(_spread(vals.astype(np.int32), valid, nrows), valid)
    if t is T.TIMESTAMP:
        unit = _timestamp_unit(el) or "MICROS"
        v = vals.astype(np.int64)
        if unit == "MILLIS":
            v = v * 1000
        elif unit == "NANOS":
            if (v % 1000).any():
                raise ValueError(
                    f"parquet column {el.get('name')!r}: a nanosecond timestamp "
                    "would lose data as microseconds"
                )
            v = v // 1000
        return ColumnData(_spread(v, valid, nrows), valid)
    narrow = _value_dtype(el)
    if narrow is not None:
        vals = vals.astype(narrow)
    fill = False if phys == th.BOOLEAN else 0
    return ColumnData(_spread(np.asarray(vals), valid, nrows, fill), valid)


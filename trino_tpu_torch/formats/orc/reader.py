"""ORC reader: tail, schema, stripes -> engine host columns (reference:
lib/trino-orc's OrcReader, StripeReader and the ColumnReader family, as
plugin/trino-hive's OrcPageSourceFactory drives them).

The schema maps to engine types exactly as the JAX package maps the Arrow
schema that `pyarrow.orc` reads from the same file (`_arrow_to_type` in its
connectors/parquet.py): BYTE and SHORT are SMALLINT (int8 / int16 values),
INT INTEGER, LONG BIGINT, FLOAT REAL, DOUBLE DOUBLE, DECIMAL(p<=38) the
decimal, DATE, TIMESTAMP and TIMESTAMP_INSTANT TIMESTAMP, STRING, VARCHAR
and CHAR VARCHAR.  A stripe's columns decode into `ColumnData` as its
`_array_to_column_data` does: a NULL is 0 (or False) under a validity mask,
strings carry a `StringDictionary`, short decimals are exact unscaled int64,
long decimals the (hi, lo) limb pair, dates int32 day numbers and
timestamps microseconds.

Encodings read: PRESENT streams, integer RLE v1 and v2, byte and boolean
RLE, direct and dictionary strings (v1 and v2), decimal varints with a
scale per value, and timestamps as seconds from 2015-01-01 in the writer's
zone (GMT or UTC; another zone raises NotImplementedError naming it) plus
nanoseconds with their trailing-zero count.  Row-index and bloom-filter
streams are never read.  BINARY, LIST, MAP, STRUCT and UNION columns raise
NotImplementedError naming the type, and so do the ZSTD, LZ4 and LZO codecs.

Host seconds of decompression (by codec) and of decoding (by encoding, each
RLE v2 sub-encoding apart, with run counts) add up in a process-wide
record: `decode_stats()` / `reset_decode_stats()`.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.connectors.api import ColumnData, ColumnMeta
from trino_tpu_torch.formats.orc import compression as cz
from trino_tpu_torch.formats.orc import metadata as md
from trino_tpu_torch.formats.orc import rle

#: 2015-01-01 00:00:00 UTC, the zero of ORC's timestamp seconds
ORC_EPOCH_S = 1420070400
#: writer zones whose seconds are UTC's
UTC_ZONES = ("GMT", "UTC")

# -- decode statistics --------------------------------------------------------

_STATS_LOCK = threading.Lock()


def _fresh_stats() -> dict:
    return {
        "codec_s": {},
        "encoding_s": {},
        "runs": {},
        "compressed_bytes": 0,
        "uncompressed_bytes": 0,
        "streams": 0,
        "stripes": 0,
    }


_STATS = _fresh_stats()


def reset_decode_stats() -> None:
    global _STATS
    with _STATS_LOCK:
        _STATS = _fresh_stats()


def decode_stats() -> dict:
    """Host seconds of decompression by codec (`codec_s`) and of decoding by
    encoding (`encoding_s`: `RLE_V1`, the four `RLE_V2_*` sub-encodings,
    `BYTE_RLE` (booleans and PRESENT streams too), `DECIMAL_VARINT`,
    `FLOAT`, `STRING_DIRECT`, `STRING_DICTIONARY`, `TIMESTAMP`, and
    `ENGINE_DICTIONARY`, the sort of a string column's values into the
    engine's dictionary), run counts by encoding (`runs`), stream bytes
    before and after decompression, streams and stripes read, since the last
    reset."""
    with _STATS_LOCK:
        s = dict(_STATS)
        for k in ("codec_s", "encoding_s", "runs"):
            s[k] = dict(_STATS[k])
        return s


class _StripeStats:
    """One stripe read's tallies, merged into the process record once."""

    __slots__ = ("codec_s", "encoding_s", "run_counts", "cbytes", "ubytes", "streams")

    def __init__(self):
        self.codec_s = {}
        self.encoding_s = {}
        self.run_counts = {}
        self.cbytes = 0
        self.ubytes = 0
        self.streams = 0

    def enc(self, name: str, seconds: float) -> None:
        self.encoding_s[name] = self.encoding_s.get(name, 0.0) + seconds

    def runs(self, name: str, count: int) -> None:
        self.run_counts[name] = self.run_counts.get(name, 0) + count

    def merge(self) -> None:
        with _STATS_LOCK:
            for src, dst in ((self.codec_s, "codec_s"), (self.encoding_s, "encoding_s"),
                             (self.run_counts, "runs")):
                for k, v in src.items():
                    _STATS[dst][k] = _STATS[dst].get(k, 0) + v
            _STATS["compressed_bytes"] += self.cbytes
            _STATS["uncompressed_bytes"] += self.ubytes
            _STATS["streams"] += self.streams
            _STATS["stripes"] += 1


# -- schema -------------------------------------------------------------------


def _unsupported(name: str, ty: dict) -> NotImplementedError:
    kind = ty.get("kind", 0)
    what = md.KINDS[kind] if kind < len(md.KINDS) else f"kind {kind}"
    return NotImplementedError(
        f"orc column {name!r} of type {what}: not supported by the port's reader"
    )


def _decimal_of(ty: dict):
    p = ty.get("precision", 0)
    s = ty.get("scale", 0)
    if not p:  # Hive 0.11/0.12 files leave it 0: the widest, as Arrow reads it
        return 38, 6
    return p, s


def engine_type(name: str, ty: dict) -> T.Type:
    """The engine type of a top-level column, as the JAX package maps the
    Arrow type pyarrow reads it as."""
    kind = ty.get("kind", 0)
    if kind == md.BOOLEAN:
        return T.BOOLEAN
    if kind in (md.BYTE, md.SHORT):
        return T.SMALLINT
    if kind == md.INT:
        return T.INTEGER
    if kind == md.LONG:
        return T.BIGINT
    if kind == md.FLOAT:
        return T.REAL
    if kind == md.DOUBLE:
        return T.DOUBLE
    if kind == md.DECIMAL:
        p, s = _decimal_of(ty)
        if p > 38:
            raise NotImplementedError(f"decimal({p},{s}) exceeds precision 38")
        return T.DecimalType(p, s)
    if kind == md.DATE:
        return T.DATE
    if kind in (md.TIMESTAMP, md.TIMESTAMP_INSTANT):
        return T.TIMESTAMP
    if kind in (md.STRING, md.VARCHAR, md.CHAR):
        return T.VARCHAR
    raise _unsupported(name, ty)


_INT_DTYPES = {md.SHORT: np.int16, md.INT: np.int32, md.LONG: np.int64}


# -- the file -----------------------------------------------------------------


class OrcFile:
    """One ORC file: its tail, schema and stripes."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            self.tail = md.read_tail(fh, path)
        footer = self.tail.footer
        self.types = footer.get("types") or []
        if not self.types or self.types[0].get("kind") != md.STRUCT:
            raise NotImplementedError(
                f"{path}: an orc file whose root is not a STRUCT is not supported "
                "by the port's reader"
            )
        root = self.types[0]
        names = root.get("fieldNames") or []
        subtypes = root.get("subtypes") or []
        self.fields = list(zip(names, subtypes))  # (name, column id)
        self._by_name = dict(self.fields)
        self.stripes = footer.get("stripes") or []
        self.codec = self.tail.codec

    @property
    def num_rows(self) -> int:
        return int(self.tail.footer.get("numberOfRows", 0))

    @property
    def num_stripes(self) -> int:
        return len(self.stripes)

    def stripe_rows(self, i: int) -> int:
        return int(self.stripes[i].get("numberOfRows", 0))

    @property
    def version(self) -> str:
        return ".".join(str(v) for v in self.tail.postscript.get("version") or ())

    def columns(self) -> list:
        """[ColumnMeta] of the file's top-level fields, mapped as the JAX
        package maps them (unsupported types raise)."""
        return [ColumnMeta(n, engine_type(n, self.types[c])) for n, c in self.fields]

    def _column(self, name: str) -> int:
        cid = self._by_name.get(name)
        if cid is None:
            raise KeyError(f"orc file {self.path} has no column {name!r}")
        return cid

    def read_stripe(self, stripe: int, columns: Sequence[str],
                    types: Optional[Sequence[T.Type]] = None) -> list:
        """Decode one stripe's `columns` into ColumnData, each in its engine
        type (`types`, else the file's own mapping).  Only those columns'
        streams are read, and no index stream."""
        info = self.stripes[stripe]
        nrows = int(info.get("numberOfRows", 0))
        st = _StripeStats()
        out = []
        with open(self.path, "rb") as fh:
            sf = md.read_stripe_footer(fh, info, self.codec)
            where = {}
            cursor = int(info.get("offset", 0))
            for s in sf.get("streams") or ():
                length = int(s.get("length", 0))
                kind = s.get("kind", 0)
                if kind not in md.INDEX_STREAMS:
                    where[(s.get("column", 0), kind)] = (cursor, length)
                cursor += length
            encodings = sf.get("columns") or []
            zone = sf.get("writerTimezone")
            codec_name = cz.CODECS.get(self.codec, str(self.codec))
            for i, name in enumerate(columns):
                cid = self._column(name)
                ty = self.types[cid]
                own = engine_type(name, ty)  # unsupported kinds raise by name
                t = types[i] if types is not None else own
                streams = {}
                for (col, kind), (start, length) in where.items():
                    if col != cid:
                        continue
                    fh.seek(start)
                    raw = fh.read(length)
                    t0 = time.perf_counter()
                    streams[kind] = cz.decompress(self.codec, raw)
                    st.codec_s[codec_name] = st.codec_s.get(codec_name, 0.0) + time.perf_counter() - t0
                    st.cbytes += length
                    st.ubytes += len(streams[kind])
                    st.streams += 1
                enc = encodings[cid] if cid < len(encodings) else {}
                out.append(_decode_column(name, ty, t, enc, streams, nrows, zone, st))
        st.merge()
        return out


# -- a column of one stripe ---------------------------------------------------


def _spread(values: np.ndarray, valid, nrows: int, fill=0) -> np.ndarray:
    """Non-null values -> one value per row, `fill` at the NULLs."""
    if valid is None:
        return np.ascontiguousarray(values)
    out = np.full((nrows,) + values.shape[1:], fill, dtype=values.dtype)
    out[valid] = values
    return out


def _ints(enc: dict, data, n: int, signed: bool, st) -> np.ndarray:
    if data is None:
        if n:
            raise ValueError(f"orc: an integer stream of {n} values is missing")
        return np.zeros(0, np.int64)
    if enc.get("kind", md.DIRECT) in (md.DIRECT_V2, md.DICTIONARY_V2):
        return rle.decode_int_rle_v2(data, n, signed, st)
    return rle.decode_int_rle_v1(data, n, signed, st)


def _strings(raw: bytes, lengths: np.ndarray) -> list:
    """Concatenated UTF-8 values -> str per length."""
    ends = np.cumsum(lengths).tolist()
    if ends and ends[-1] > len(raw):
        raise ValueError("orc: string lengths overrun their data")
    starts = [0] + ends[:-1]
    return [raw[a:b].decode("utf-8") for a, b in zip(starts, ends)]


def _rescale(hi, lo, scales, scale: int):
    """Unscaled decimals at per-value `scales` -> at the column's `scale`
    (a finer value truncates toward zero, as ORC's readers do)."""
    off = np.flatnonzero(scales != scale)
    if not len(off):
        return hi, lo
    hi = hi.copy()
    lo = lo.copy()
    for i in off.tolist():
        v = (int(hi[i]) << 64) | (int(lo[i]) & ((1 << 64) - 1))
        s = int(scales[i])
        if s < scale:
            v *= 10 ** (scale - s)
        else:
            q = abs(v) // 10 ** (s - scale)
            v = q if v >= 0 else -q
        hi[i] = v >> 64
        low = v & ((1 << 64) - 1)
        lo[i] = low - (1 << 64) if low >= 1 << 63 else low
    return hi, lo


def _decode_column(name: str, ty: dict, t: T.Type, enc: dict, streams: dict,
                   nrows: int, zone, st) -> ColumnData:
    kind = ty.get("kind", 0)
    present = streams.get(md.PRESENT)
    valid = None
    nn = nrows
    if present is not None:
        valid = rle.decode_boolean_rle(present, nrows, st)
        nn = int(valid.sum())
        if nn == nrows:
            valid = None
    data = streams.get(md.DATA)
    if kind in (md.STRING, md.VARCHAR, md.CHAR):
        if not T.is_string_kind(t):
            raise NotImplementedError(
                f"orc column {name!r}: {md.KINDS[kind]} read as {t.name}")
        return _string_column(enc, streams, nn, nrows, valid, st)
    if T.is_string_kind(t):
        raise NotImplementedError(f"orc column {name!r}: {md.KINDS[kind]} read as {t.name}")
    if kind == md.BOOLEAN:
        vals = rle.decode_boolean_rle(data or b"", nn, st)
        return ColumnData(_spread(vals, valid, nrows, False), valid)
    if kind == md.BYTE:
        vals = rle.decode_byte_rle(data or b"", nn, st).view(np.int8)
        return ColumnData(_spread(vals, valid, nrows), valid)
    if kind in _INT_DTYPES:
        vals = _ints(enc, data, nn, True, st).astype(_INT_DTYPES[kind])
        return ColumnData(_spread(vals, valid, nrows), valid)
    if kind == md.DATE:
        vals = _ints(enc, data, nn, True, st).astype(np.int32)
        return ColumnData(_spread(vals, valid, nrows), valid)
    if kind in (md.FLOAT, md.DOUBLE):
        t0 = time.perf_counter()
        dt = np.dtype("<f4" if kind == md.FLOAT else "<f8")
        if len(data or b"") < nn * dt.itemsize:
            raise ValueError(f"orc column {name!r}: {nn} floats overrun their stream")
        vals = np.frombuffer(data or b"", dt, nn).astype(dt.newbyteorder("="))
        st.enc("FLOAT", time.perf_counter() - t0)
        return ColumnData(_spread(vals, valid, nrows), valid)
    if kind == md.DECIMAL:
        p, s = _decimal_of(ty)
        if not isinstance(t, T.DecimalType) or t.scale != s:
            raise NotImplementedError(
                f"orc column {name!r}: a decimal({p},{s}) read as {t.name}")
        t0 = time.perf_counter()
        hi, lo = rle.decode_decimal_varints(data or b"", nn)
        st.enc("DECIMAL_VARINT", time.perf_counter() - t0)
        scales = _ints(enc, streams.get(md.SECONDARY), nn, True, st)
        hi, lo = _rescale(hi, lo, scales, s)
        if t.is_long:
            return ColumnData(_spread(np.stack([hi, lo], axis=1), valid, nrows), valid, None)
        return ColumnData(_spread(lo, valid, nrows), valid)
    if kind in (md.TIMESTAMP, md.TIMESTAMP_INSTANT):
        if kind == md.TIMESTAMP and zone not in UTC_ZONES:
            raise NotImplementedError(
                f"orc column {name!r}: TIMESTAMP written in zone {zone or '(none)'}: "
                "the port's reader takes writer zones GMT and UTC only")
        secs = _ints(enc, data, nn, True, st)
        nanos = _ints(enc, streams.get(md.SECONDARY), nn, False, st)
        t0 = time.perf_counter()
        z = nanos & 7
        nanos = nanos >> 3
        scale = np.ones(nn, np.int64)
        for k in range(1, 8):
            scale[z == k] = 10 ** (k + 1)
        nanos = nanos * scale
        secs = secs + ORC_EPOCH_S
        secs = secs - ((secs < 0) & (nanos > 999_999))
        if (nanos % 1000).any():
            raise ValueError(
                f"orc column {name!r}: a nanosecond timestamp would lose data "
                "as microseconds")
        micros = secs * 1_000_000 + nanos // 1000
        st.enc("TIMESTAMP", time.perf_counter() - t0)
        return ColumnData(_spread(micros, valid, nrows), valid)
    raise _unsupported(name, ty)


def _string_column(enc: dict, streams: dict, nn: int, nrows: int, valid, st) -> ColumnData:
    kind = enc.get("kind", md.DIRECT)
    if kind in (md.DICTIONARY, md.DICTIONARY_V2):
        size = int(enc.get("dictionarySize", 0))
        codes = _ints(enc, streams.get(md.DATA), nn, False, st)
        lengths = _ints(enc, streams.get(md.LENGTH), size, False, st)
        t0 = time.perf_counter()
        values = _strings(streams.get(md.DICTIONARY_DATA) or b"", lengths)
        if len(codes) and (codes.min() < 0 or codes.max() >= size):
            raise ValueError("orc: a dictionary code beyond the stripe's dictionary")
        st.enc("STRING_DICTIONARY", time.perf_counter() - t0)
    else:
        lengths = _ints(enc, streams.get(md.LENGTH), nn, False, st)
        t0 = time.perf_counter()
        lookup: dict = {}
        get = lookup.setdefault
        codes = np.fromiter((get(v, len(lookup)) for v in _strings(streams.get(md.DATA) or b"", lengths)),
                            np.int64, nn)
        values = list(lookup)
        st.enc("STRING_DIRECT", time.perf_counter() - t0)
    t0 = time.perf_counter()
    d = StringDictionary.from_unsorted(values or [""])
    index = d.index
    remap = np.fromiter((index[v] for v in values), np.int32, len(values))
    mapped = remap[codes] if len(codes) else np.zeros(0, np.int32)
    out = _spread(mapped.astype(np.int32, copy=False), valid, nrows)
    st.enc("ENGINE_DICTIONARY", time.perf_counter() - t0)
    return ColumnData(out, valid, d)

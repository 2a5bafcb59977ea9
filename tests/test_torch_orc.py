"""The port's own ORC reader and writer (trino_tpu_torch/formats/orc) against
pyarrow and the JAX package's pyarrow-based decode on the same files.

  * the codec on files pyarrow writes, with every type the JAX
    `_arrow_to_type` accepts and NULLs in each (bool, int8-int64, float32/64,
    decimal(12,2) and decimal(38,10), date, ms and ns timestamps before 1970
    and before 2015 with fractions, strings with empty values and an
    all-NULL column): NONE, ZLIB and SNAPPY, file versions 0.11 (RLE v1)
    and 0.12, direct and dictionary strings, several stripes and streams of
    several compression chunks; each column of each stripe equals the JAX
    `_array_to_column_data` of `pyarrow.orc`'s read of that stripe (values,
    dtype, mask and strings; doubles bit for bit);
  * data shaped for each RLE v2 sub-encoding, each proven seen through
    `decode_stats()`;
  * ZSTD, LZ4, BINARY, nested and union columns and a writer zone other
    than GMT/UTC raise NotImplementedError naming themselves;
  * the protobuf wire format and the run-length coders on their own;
  * files the port writes read back through pyarrow, with the ORC types
    pyarrow gives the JAX package's Arrow table, and through the JAX
    HiveConnector with the same rows.
"""

import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest

from trino_tpu.connectors import parquet as jpq
from trino_tpu.connectors.api import CatalogManager as JaxCatalogs
from trino_tpu.connectors import hive as jhive
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.connectors.api import CatalogManager, ColumnData
from trino_tpu_torch.connectors.hive import HiveConnector
from trino_tpu_torch.formats.orc import OrcFile, decode_stats, reset_decode_stats
from trino_tpu_torch.formats.orc import compression as cz
from trino_tpu_torch.formats.orc import metadata as md
from trino_tpu_torch.formats.orc import protobuf as pb
from trino_tpu_torch.formats.orc import rle
from trino_tpu_torch.formats.orc import writer as ow
from trino_tpu_torch.formats.orc.reader import _rescale
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows
from test_torch_parquet import assert_same_column

N = 3000
#: timestamps in microseconds around 1970 and 2015, with fractions
_TS_EDGES = np.array([
    -1, -999, -1000, -1001, -999_999, -1_000_000, -1_000_001, -1_500_000,
    -86_400_000_001, 0, 1, 999_999, 1_000_000, 1_420_070_399_999_999,
    1_420_070_400_000_000, 1_420_070_400_000_001, 1_420_070_399_000_000,
    1_420_070_398_500_000, -2_208_988_800_123_456, 4_102_444_799_999_999,
], np.int64)


def _every_type_table(seed: int = 7, n: int = N) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.1

    def dec(values, p, s):
        return pa.array(
            [decimal.Decimal(int(v)).scaleb(-s) for v in values],
            type=pa.decimal128(p, s), mask=nulls(),
        )

    ts_us = np.where(rng.random(n) < 0.2, _TS_EDGES[rng.integers(0, len(_TS_EDGES), n)],
                     rng.integers(-2**50, 2**50, n))
    return pa.table({
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=nulls()),
        "i16": pa.array(rng.integers(-30000, 30000, n).astype(np.int16), mask=nulls()),
        "i32": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32), mask=nulls()),
        "i64": pa.array(rng.integers(-2**62, 2**62, n), mask=nulls()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32), mask=nulls()),
        "f64": pa.array(np.where(rng.random(n) < 0.05, -0.0, rng.standard_normal(n)), mask=nulls()),
        "d_short": dec(rng.integers(-10**11, 10**11, n), 12, 2),
        "d_18": dec(rng.integers(-10**17, 10**17, n), 18, 5),
        "d_long": dec(rng.integers(-2**62, 2**62, n) * 10**8 + 12345, 30, 4),
        "d_38": dec(rng.integers(-2**62, 2**62, n) * 10**18 - 1, 38, 10),
        "dt": pa.array(rng.integers(-30000, 30000, n).astype(np.int32), type=pa.date32(), mask=nulls()),
        "ts_ns": pa.array(ts_us * 1000, type=pa.timestamp("ns"), mask=nulls()),
        "ts_ms": pa.array(ts_us // 1000, type=pa.timestamp("ms"), mask=nulls()),
        "ts_utc": pa.array(ts_us, type=pa.timestamp("us", tz="UTC"), mask=nulls()),
        "s": pa.array([f"v{x}" for x in rng.integers(0, 40, n)], mask=nulls()),
        "s_empty": pa.array(["" if x < 0.3 else f"e{x:.2f}" for x in rng.random(n)], mask=nulls()),
        "s_wide": pa.array(["é" * int(x) + str(x) for x in rng.integers(0, 300, n)]),
        "s_null": pa.array([None] * n, type=pa.string()),
    })


def _jax_types(path):
    return [jpq._arrow_to_type(f.type) for f in po.ORCFile(path).schema]


def _compare_file(path, columns=None):
    """Every stripe of the file: the port's decode equals the JAX decode of
    pyarrow's read, column by column.  Returns the port's OrcFile."""
    f = OrcFile(path)
    ref = po.ORCFile(path)
    ports = f.columns()
    jtypes = _jax_types(path)
    assert [c.type.name for c in ports] == [t.name for t in jtypes]
    names = columns or [c.name for c in ports]
    assert f.num_rows == ref.nrows and f.num_stripes == ref.nstripes
    for i in range(f.num_stripes):
        got = f.read_stripe(i, names)
        tbl = ref.read_stripe(i, columns=names)
        assert f.stripe_rows(i) == tbl.num_rows
        for k, name in enumerate(names):
            jt = jtypes[[c.name for c in ports].index(name)]
            expected = jpq._array_to_column_data(tbl.column(k), jt)
            assert_same_column(got[k], expected, name)
            if np.asarray(got[k].values).dtype.kind == "f":  # doubles bit for bit
                assert np.asarray(got[k].values).tobytes() == np.asarray(expected.values).tobytes()
    return f


@pytest.mark.parametrize("dictionary", [0.0, 1.0], ids=["direct", "dict"])
@pytest.mark.parametrize("version", ["0.11", "0.12"])
@pytest.mark.parametrize("codec", ["uncompressed", "zlib", "snappy"])
def test_reads_pyarrow_files(tmp_path, codec, version, dictionary):
    path = str(tmp_path / "t.orc")
    po.write_table(_every_type_table(), path, compression=codec, file_version=version,
                   dictionary_key_size_threshold=dictionary)
    reset_decode_stats()
    f = _compare_file(path)
    assert f.version == version
    s = decode_stats()
    assert set(s["codec_s"]) == {cz.CODECS[f.codec]}
    assert ("STRING_DICTIONARY" in s["encoding_s"]) == (dictionary == 1.0)
    assert ("STRING_DIRECT" in s["encoding_s"]) == (dictionary == 0.0)
    ints = {k for k in s["runs"] if k.startswith("RLE_V")}
    assert ints == ({"RLE_V1"} if version == "0.11" else ints - {"RLE_V1"}) and ints
    assert s["stripes"] == f.num_stripes and s["streams"] > 0


def _chunks(codec, raw) -> int:
    """Compression chunks in one framed stream."""
    pos = count = 0
    while pos < len(raw):
        h = raw[pos] | raw[pos + 1] << 8 | raw[pos + 2] << 16
        pos += 3 + (h >> 1)
        count += 1
    return count


@pytest.mark.parametrize("codec", ["zlib", "snappy"])
def test_stripes_and_multi_chunk_streams(tmp_path, codec):
    rng = np.random.default_rng(3)
    m = 120_000
    tbl = pa.table({
        "i64": pa.array(rng.integers(-2**62, 2**62, m), mask=rng.random(m) < 0.01),
        "s": pa.array([f"k{x}" for x in rng.integers(0, 30000, m)]),
        "f64": pa.array(rng.standard_normal(m)),
    })
    path = str(tmp_path / "big.orc")
    po.write_table(tbl, path, compression=codec, stripe_size=1 << 19, batch_size=4096)
    f = _compare_file(path)
    assert f.num_stripes > 1
    with open(path, "rb") as fh:
        sf = md.read_stripe_footer(fh, f.stripes[0], f.codec)
        start = f.stripes[0]["offset"]
        most = 0
        for s in sf["streams"]:
            fh.seek(start)
            most = max(most, _chunks(f.codec, fh.read(s["length"])))
            start += s["length"]
    assert most > 1


def _sub_encoding_table(shape: str, n: int = 20_000) -> pa.Table:
    rng = np.random.default_rng(17)
    if shape == "SHORT_REPEAT":  # runs of 3-10 equal values
        v = np.repeat(rng.integers(-1000, 1000, n), rng.integers(3, 11, n))[:n]
    elif shape == "DELTA":  # monotonic, fixed and varying steps
        v = np.concatenate([np.arange(n // 2) * 7 - 50_000,
                            np.cumsum(rng.integers(1, 1000, n - n // 2))])
    elif shape == "DIRECT":
        v = rng.integers(-2**40, 2**40, n)
    else:  # PATCHED_BASE: small values with a few huge outliers
        v = rng.integers(0, 100, n)
        hit = rng.random(n) < 0.01
        v[hit] = rng.integers(2**40, 2**50, int(hit.sum()))
    return pa.table({"v": pa.array(v), "u": pa.array(v.astype(np.int32) if shape != "PATCHED_BASE" else (v % 2**31).astype(np.int32))})


@pytest.mark.parametrize("shape", ["SHORT_REPEAT", "DIRECT", "PATCHED_BASE", "DELTA"])
def test_rle_v2_sub_encodings_seen(tmp_path, shape):
    path = str(tmp_path / "r.orc")
    po.write_table(_sub_encoding_table(shape), path)
    reset_decode_stats()
    _compare_file(path)
    s = decode_stats()
    assert s["runs"].get(f"RLE_V2_{shape}", 0) > 0, s["runs"]
    assert s["encoding_s"][f"RLE_V2_{shape}"] >= 0


def test_patched_base_gaps_above_255(tmp_path):
    """Outliers 300 values apart in a run: the patch list carries a filler
    entry (gap 255, patch 0) before the second patch."""
    v = np.random.default_rng(23).integers(0, 100, 512 * 8)
    for b in range(8):
        v[b * 512 + 2] = 2**45
        v[b * 512 + 302] = 2**44 + 5
        v[b * 512 + 510] = 2**43
    path = str(tmp_path / "p.orc")
    po.write_table(pa.table({"v": pa.array(v)}), path)
    reset_decode_stats()
    _compare_file(path)
    assert decode_stats()["runs"].get("RLE_V2_PATCHED_BASE", 0) >= 8


def test_timestamp_edges_and_sub_microsecond(tmp_path):
    """Negative seconds with nanos above 999,999 (the ORC readers' shift),
    2015-01-01 on both sides; a nanosecond fraction raises in both packages."""
    path = str(tmp_path / "ts.orc")
    us = np.concatenate([_TS_EDGES, _TS_EDGES - 7, _TS_EDGES + 123_000])
    po.write_table(pa.table({
        "ns": pa.array(us * 1000, type=pa.timestamp("ns")),
        "ms": pa.array(us // 1000, type=pa.timestamp("ms")),
        "s": pa.array(us // 1_000_000, type=pa.timestamp("s")),
    }), path, compression="zlib")
    _compare_file(path)
    po.write_table(pa.table({"ns": pa.array([1, -1500], type=pa.timestamp("ns"))}), path)
    with pytest.raises(pa.ArrowInvalid):
        jpq._array_to_column_data(po.ORCFile(path).read().column(0), jpq._arrow_to_type(pa.timestamp("ns")))
    with pytest.raises(ValueError, match="lose data"):
        OrcFile(path).read_stripe(0, ["ns"])


@pytest.mark.parametrize("rows", [0, 1])
def test_empty_and_all_null(tmp_path, rows):
    path = str(tmp_path / "e.orc")
    po.write_table(pa.table({
        "i": pa.array([None] * rows, pa.int64()),
        "s": pa.array([None] * rows, pa.string()),
        "d": pa.array([None] * rows, pa.decimal128(30, 2)),
    }), path)
    f = _compare_file(path)
    assert f.num_rows == rows


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_unsupported_codec_raises_by_name(tmp_path, codec):
    path = str(tmp_path / "c.orc")
    po.write_table(pa.table({"a": [1, 2, 3]}), path, compression=codec)
    with pytest.raises(NotImplementedError, match=f"orc codec {codec.upper()}"):
        OrcFile(path)


@pytest.mark.parametrize("kind", ["BINARY", "LIST", "STRUCT", "MAP", "UNION"])
def test_unsupported_types_raise_by_name(tmp_path, kind):
    arr = {
        "BINARY": lambda: pa.array([b"x", b"y"]),
        "LIST": lambda: pa.array([[1], [2, 3]]),
        "STRUCT": lambda: pa.array([{"x": 1}, {"x": 2}]),
        "MAP": lambda: pa.array([[("a", 1)], [("b", 2)]], pa.map_(pa.string(), pa.int64())),
        "UNION": lambda: pa.UnionArray.from_sparse(
            pa.array([0, 1], pa.int8()), [pa.array([1, 2]), pa.array(["a", "b"])]),
    }[kind]()
    path = str(tmp_path / "n.orc")
    po.write_table(pa.table({"n": arr, "k": [5, 6]}), path)
    f = OrcFile(path)
    with pytest.raises(NotImplementedError, match=f"'n' of type {kind}"):
        f.columns()
    with pytest.raises(NotImplementedError, match=kind):
        f.read_stripe(0, ["n"], [TT.BIGINT])
    # the flat column beside it reads (its column id follows the nested one's)
    assert f.read_stripe(0, ["k"], [TT.BIGINT])[0].values.tolist() == [5, 6]
    with pytest.raises(NotImplementedError):
        jpq._arrow_to_type(po.ORCFile(path).schema.field("n").type)


def test_writer_zone_other_than_utc_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "z.orc")
    monkeypatch.setattr(ow, "WRITER_TIMEZONE", "America/New_York")
    ow.write_columns(path, ["t", "i"], [TT.TIMESTAMP, TT.BIGINT],
                     [ColumnData(np.array([0, 10**9], np.int64)), ColumnData(np.array([1, 2]))])
    f = OrcFile(path)
    with pytest.raises(NotImplementedError, match="America/New_York"):
        f.read_stripe(0, ["t"])
    assert f.read_stripe(0, ["i"])[0].values.tolist() == [1, 2]


def test_decimal_rescale_per_value():
    hi = np.array([0, 0, -1, 0], np.int64)
    lo = np.array([125, 7, -35, 10**6], np.int64)
    scales = np.array([2, 0, 1, 4], np.int64)
    h, l = _rescale(hi, lo, scales, 2)
    assert l.tolist() == [125, 700, -350, 10**4] and h.tolist() == [0, 0, -1, 0]
    h, l = _rescale(np.array([-1], np.int64), np.array([-1999], np.int64), np.array([3]), 2)
    assert (h.tolist(), l.tolist()) == ([-1], [-199])  # truncated toward zero


# -- the protobuf wire format and the run-length coders ------------------------


def test_protobuf_skips_unknown_fields_of_every_wire_type():
    schema = {1: ("a", "uint"), 4: ("r", "sint", "repeated"), 5: ("m", {1: ("x", "string")})}
    out = bytearray()
    pb.write_varint(out, 1 << 3 | pb.VARINT)
    pb.write_varint(out, 300)
    for number, wire, body in ((2, pb.VARINT, b"\x96\x01"), (3, pb.FIXED64, bytes(8)),
                               (6, pb.LENGTH, b"\x03abc"), (7, pb.FIXED32, bytes(4)),
                               (8, pb.START_GROUP, bytes([1 << 3 | 0, 5, 8 << 3 | 4]))):
        pb.write_varint(out, number << 3 | wire)
        out += body
    for v in (-3, 4):  # a repeated scalar one by one, then packed
        pb.write_varint(out, 4 << 3 | pb.VARINT)
        pb.write_varint(out, pb.zigzag_encode(v))
    out += pb.write_message({4: ("r", "sint", "repeated")}, {"r": [-(1 << 62), 9]})
    out += pb.write_message({5: ("m", {1: ("x", "string")})}, {"m": {"x": "é"}})
    got = pb.read_message(bytes(out), schema)
    assert got == {"a": 300, "r": [-3, 4, -(1 << 62), 9], "m": {"x": "é"}}


def test_protobuf_round_trip_of_orc_messages():
    msg = {"footerLength": 1 << 40, "compression": 1, "compressionBlockSize": 262144,
           "version": [0, 12], "metadataLength": 0, "writerVersion": 6, "magic": "ORC"}
    assert pb.read_message(pb.write_message(md.POSTSCRIPT, msg), md.POSTSCRIPT) == msg
    stats = {"numberOfValues": 3, "hasNull": True,
             "intStatistics": {"minimum": -5, "maximum": 1 << 62, "sum": 0},
             "doubleStatistics": {"minimum": -0.5, "maximum": 2.5}}
    assert pb.read_message(pb.write_message(md.COLUMN_STATISTICS, stats), md.COLUMN_STATISTICS) == stats


@pytest.mark.parametrize("signed", [True, False])
def test_int_rle_v2_round_trip(signed):
    rng = np.random.default_rng(5)
    i64 = np.iinfo(np.int64)
    parts = [np.full(7, 3), np.full(600, -9 if signed else 9), np.arange(1000) * -3 + 5,
             rng.integers(-2**20, 2**20, 777), np.array([i64.min, i64.max, 0, -1, 1]),
             rng.integers(i64.min, i64.max, 300, dtype=np.int64), np.arange(2), np.full(11, 4)]
    v = np.concatenate(parts).astype(np.int64)
    # runs are cut every 512 values: a last run of 7 equal values is a SHORT_REPEAT
    v = np.concatenate([v, rng.integers(-99, 99, -len(v) % 512), np.full(7, 3)])
    if not signed:
        v = np.abs(v) & i64.max
    enc = rle.encode_int_rle_v2(v, signed)
    st = _Tally()
    assert np.array_equal(rle.decode_int_rle_v2(enc, len(v), signed, st), v)
    assert {"RLE_V2_DIRECT", "RLE_V2_DELTA", "RLE_V2_SHORT_REPEAT"} <= set(st.counts)


class _Tally:
    def __init__(self):
        self.counts = {}

    def enc(self, name, seconds):
        pass

    def runs(self, name, count):
        self.counts[name] = self.counts.get(name, 0) + count


def test_byte_boolean_and_decimal_coders_round_trip():
    rng = np.random.default_rng(9)
    b = np.concatenate([np.full(300, 7), rng.integers(0, 256, 1000), np.full(2, 1),
                        np.full(131, 0), [5]]).astype(np.uint8)
    assert np.array_equal(rle.decode_byte_rle(rle.encode_byte_rle(b), len(b)), b)
    bits = rng.random(9999) < 0.3
    assert np.array_equal(rle.decode_boolean_rle(rle.encode_boolean_rle(bits), len(bits)), bits)
    vals = [0, 1, -1, 63, -64, 64, 2**63 - 1, -2**63, 2**63, 2**127 - 1, -2**127, 10**38 - 1]
    vals += [int(x) for x in rng.integers(-2**62, 2**62, 50)]
    hi = np.array([v >> 64 for v in vals], np.int64)
    lo = np.array([(v & (2**64 - 1)) - (2**64 if v & (1 << 63) else 0) for v in vals], np.int64)
    h, l = rle.decode_decimal_varints(rle.encode_decimal_varints(hi, lo), len(vals))
    assert np.array_equal(h, hi) and np.array_equal(l, lo)
    # pyarrow's decimal varints of the same values (decimal(38,0) DATA)
    out = bytearray()
    for v in vals[:-1]:
        pb.write_varint(out, pb.zigzag_encode(v))
    h, l = rle.decode_decimal_varints(bytes(out), len(vals) - 1)
    assert np.array_equal(h, hi[:-1]) and np.array_equal(l, lo[:-1])


# -- files the port writes -----------------------------------------------------


@pytest.mark.parametrize("codec", ["ZLIB", "NONE"])
def test_port_files_read_back_by_pyarrow_and_jax(tmp_path, codec):
    src = str(tmp_path / "src.orc")
    tbl = _every_type_table(5).drop(["ts_ms", "ts_utc"])
    po.write_table(tbl, src)
    pf = OrcFile(src)
    cols = pf.columns()
    names = [c.name for c in cols]
    data = pf.read_stripe(0, names)
    d = tmp_path / "h" / "s" / "port"
    os.makedirs(d)
    out = str(d / "part-0.orc")
    ow.write_columns(out, names, [c.type for c in cols], data, stripe_rows=1100, codec=codec)
    ref = po.ORCFile(out)
    assert ref.nstripes == 3
    back = ref.read()
    expected = po.read_table(src)
    for n in names:
        assert back.column(n).to_pylist() == expected.column(n).to_pylist(), n
    # the ORC types pyarrow writes for the JAX package's Arrow table
    arrow = pa.table({c.name: jpq._column_data_to_arrow(cd, jt)
                      for c, cd, jt in zip(cols, data, _jax_types(src))})
    po.write_table(arrow, str(tmp_path / "jax.orc"))
    assert ref.schema == po.ORCFile(str(tmp_path / "jax.orc")).schema
    _compare_file(out)
    # the JAX hive connector over the port's file, the port's over the same
    jc = JaxCatalogs()
    jc.register("h", jhive.HiveConnector(str(tmp_path / "h")))
    pc = CatalogManager()
    pc.register("h", HiveConnector(str(tmp_path / "h")))
    sql = f"select {', '.join(names)} from port"
    want = JaxRunner(jc, catalog="h", schema="s").execute(sql).rows
    got = LocalQueryRunner(pc, catalog="h", schema="s", device="cpu").execute(sql).rows
    assert_same_rows(got, want, False, 0.0)
    assert len(got) == N


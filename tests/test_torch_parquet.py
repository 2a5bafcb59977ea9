"""The port's own Parquet reader and writer (trino_tpu_torch/formats/parquet)
and its parquet connector, against pyarrow and the JAX package's pyarrow-based
connector on the same files.

  * the codec on files pyarrow writes, with every type the JAX
    `_arrow_to_type` accepts (NULLs, an all-NULL string column, long and
    short decimals, int8/int16, ns/ms timestamps): SNAPPY, GZIP and
    UNCOMPRESSED, data pages v1 and v2, with and without dictionaries, and a
    string dictionary that overflowed to PLAIN part-way; each column decodes
    to the JAX `_array_to_column_data` result (values, dtype, mask, strings);
  * unsupported codecs, encodings and types raise NotImplementedError naming
    themselves;
  * `table_metadata` types equal the JAX package's;
  * files the port writes read back through pyarrow and the JAX
    ParquetConnector with the same rows;
  * TPC-H Q1, Q6 and Q3 at tpch.tiny over parquet files that pyarrow wrote
    and that the port wrote, local and on the 4-worker mesh, give the JAX
    package's rows (integers, decimals, dates and strings exact, doubles to
    relative 1e-9), and reach K1 (`pallas_agg`) and K2 (`pallas_probe`, the
    mesh joins) as a generator-fed scan does.
"""

import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from trino_tpu.connectors.api import CatalogManager as JaxCatalogs
from trino_tpu.connectors import parquet as jpq
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.connectors.parquet import ParquetConnector, write_table_to_parquet
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.formats.parquet import ParquetFile, decode_stats, reset_decode_stats
from trino_tpu_torch.formats.parquet import thrift as th
from trino_tpu_torch.formats.parquet.compression import snappy_decompress
from trino_tpu_torch.formats.parquet.writer import write_columns
from trino_tpu_torch.ops import grouped_sums as gs
from trino_tpu_torch.ops import locate_sorted as ls
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import Q1_DOUBLE, assert_same_rows

N = 3000


def _every_type_table(seed: int = 7) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(N) < 0.1

    def dec(values, p, s):
        return pa.array(
            [decimal.Decimal(int(v)).scaleb(-s) for v in values],
            type=pa.decimal128(p, s), mask=nulls(),
        )

    return pa.table({
        "b": pa.array(rng.random(N) < 0.5, mask=nulls()),
        "i8": pa.array(rng.integers(-128, 128, N).astype(np.int8), mask=nulls()),
        "i16": pa.array(rng.integers(-30000, 30000, N).astype(np.int16), mask=nulls()),
        "i32": pa.array(rng.integers(-2**31, 2**31, N).astype(np.int32), mask=nulls()),
        "i64": pa.array(rng.integers(-2**62, 2**62, N), mask=nulls()),
        "f32": pa.array(rng.standard_normal(N).astype(np.float32), mask=nulls()),
        "f64": pa.array(rng.standard_normal(N), mask=nulls()),
        "d_short": dec(rng.integers(-10**11, 10**11, N), 12, 2),
        "d_18": dec(rng.integers(-10**17, 10**17, N), 18, 5),
        "d_long": dec(rng.integers(-2**62, 2**62, N) * 10**8 + 12345, 30, 4),
        "d_38": dec(rng.integers(-2**62, 2**62, N) * 10**18 - 1, 38, 0),
        "dt": pa.array(rng.integers(-1000, 20000, N).astype(np.int32), type=pa.date32(), mask=nulls()),
        "ts_ns": pa.array(rng.integers(0, 2**40, N) * 1000, type=pa.timestamp("ns"), mask=nulls()),
        "ts_ms": pa.array(rng.integers(0, 2**40, N), type=pa.timestamp("ms", tz="UTC")),
        "s": pa.array([f"v{x}" for x in rng.integers(0, 40, N)], mask=nulls()),
        "s_wide": pa.array(["é" * int(x) + str(x) for x in rng.integers(0, 300, N)]),
        "s_null": pa.array([None] * N, type=pa.string()),
    })


def _jax_types(path):
    return [jpq._arrow_to_type(f.type) for f in pq.read_schema(path)]


def _rows(cd, t_name):
    """A decoded column as Python values (None at NULLs)."""
    vals = np.asarray(cd.values)
    valid = None if cd.valid is None else np.asarray(cd.valid, bool)
    if cd.dictionary is not None:
        out = [cd.dictionary.values[int(c)] for c in vals]
    elif vals.ndim == 2:
        out = [(int(h), int(lo)) for h, lo in vals]
    else:
        out = vals.tolist()
    if valid is not None:
        out = [v if ok else None for v, ok in zip(out, valid)]
    return out


def assert_same_column(port, jax, t_name):
    assert _rows(port, t_name) == _rows(jax, t_name), t_name
    if port.dictionary is None:
        assert np.asarray(port.values).dtype == np.asarray(jax.values).dtype, t_name
        # NULL slots hold 0 (False) in both
        assert np.array_equal(np.asarray(port.values), np.asarray(jax.values)), t_name
    assert (port.valid is None) == (jax.valid is None), t_name
    if port.valid is not None:
        assert np.array_equal(port.valid, jax.valid), t_name
    if port.dictionary is not None:
        assert len(port.dictionary) >= 1


def _compare_file(path):
    pf = ParquetFile(path)
    ports = pf.columns()
    jtypes = _jax_types(path)
    assert [c.type.name for c in ports] == [t.name for t in jtypes]
    names = [c.name for c in ports]
    ref = pq.ParquetFile(path)
    for rg in range(pf.num_row_groups):
        assert pf.row_group_rows(rg) == ref.metadata.row_group(rg).num_rows
        got = pf.read_row_group(rg, names)
        tbl = ref.read_row_group(rg)
        for i, (c, jt) in enumerate(zip(ports, jtypes)):
            expected = jpq._array_to_column_data(tbl.column(i), jt)
            assert_same_column(got[i], expected, c.name)


@pytest.mark.parametrize("dictionary", [True, False], ids=["dict", "plain"])
@pytest.mark.parametrize("version", ["1.0", "2.0"], ids=["v1", "v2"])
@pytest.mark.parametrize("codec", ["snappy", "gzip", "none"])
def test_reads_pyarrow_files(tmp_path, codec, version, dictionary):
    path = str(tmp_path / "t.parquet")
    pq.write_table(
        _every_type_table(), path, compression=codec, data_page_version=version,
        use_dictionary=dictionary, data_page_size=4096, row_group_size=2000,
    )
    reset_decode_stats()
    _compare_file(path)
    stats = decode_stats()
    want_codec = {"snappy": "SNAPPY", "gzip": "GZIP", "none": "UNCOMPRESSED"}[codec]
    assert set(stats["codec_s"]) == {want_codec}
    want = {"RLE_DICTIONARY"} if dictionary else {"PLAIN"}
    assert want <= set(stats["data_pages"])


def test_dictionary_overflow_to_plain(tmp_path):
    """pyarrow falls back to PLAIN pages once a column's dictionary passes
    its limit: the chunk then holds a dictionary page, RLE_DICTIONARY pages
    and PLAIN pages."""
    rng = np.random.default_rng(3)
    words = [f"{i:06d}-" + "x" * 24 for i in rng.permutation(6000)]
    tbl = pa.table({"s": pa.array(words, mask=rng.random(6000) < 0.05),
                    "k": pa.array(np.arange(6000))})
    path = str(tmp_path / "overflow.parquet")
    pq.write_table(tbl, path, compression="snappy", dictionary_pagesize_limit=16384,
                   data_page_size=8192)
    reset_decode_stats()
    _compare_file(path)
    pages = decode_stats()["data_pages"]
    assert pages.get("RLE_DICTIONARY", 0) >= 1 and pages.get("PLAIN", 0) >= 1


@pytest.mark.parametrize("rows", [0, 7], ids=["empty", "all_null"])
def test_empty_and_all_null_columns(tmp_path, rows):
    """A table without rows, and columns whose every value is NULL, from
    pyarrow's writer and from the port's, decode as the JAX package's."""
    tbl = _every_type_table().slice(0, 0)
    if rows:
        tbl = pa.table({f.name: pa.nulls(rows, f.type) for f in tbl.schema})
    src = str(tmp_path / "src.parquet")
    pq.write_table(tbl, src)
    _compare_file(src)
    pf = ParquetFile(src)
    cols = pf.columns()
    data = pf.read_row_group(0, [c.name for c in cols])
    out = str(tmp_path / "port.parquet")
    write_columns(out, [c.name for c in cols], [c.type for c in cols], data)
    assert ParquetFile(out).num_rows == rows
    _compare_file(out)
    expected = tbl.cast(pa.schema([
        pa.field(f.name, pa.timestamp("us") if f.name.startswith("ts") else f.type)
        for f in tbl.schema]))
    assert pq.read_table(out).to_pylist() == expected.to_pylist()


@pytest.mark.parametrize("codec", ["zstd", "brotli", "lz4"])
def test_unsupported_codec_raises_by_name(tmp_path, codec):
    path = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"x": pa.array(np.arange(100))}), path, compression=codec)
    name = {"lz4": "LZ4_RAW"}.get(codec, codec.upper())
    with pytest.raises(NotImplementedError, match=name):
        ParquetFile(path).read_row_group(0, ["x"])


@pytest.mark.parametrize("encoding", [
    "DELTA_BINARY_PACKED", "BYTE_STREAM_SPLIT", "DELTA_LENGTH_BYTE_ARRAY",
])
def test_unsupported_encoding_raises_by_name(tmp_path, encoding):
    path = str(tmp_path / "e.parquet")
    col = (pa.array([f"s{i}" for i in range(100)]) if "BYTE_ARRAY" in encoding
           else pa.array(np.arange(100, dtype=np.int64)))
    pq.write_table(pa.table({"x": col}), path, use_dictionary=False,
                   column_encoding={"x": encoding})
    with pytest.raises(NotImplementedError, match=encoding):
        ParquetFile(path).read_row_group(0, ["x"])


@pytest.mark.parametrize("kind", ["int96", "nested", "uint8", "binary"])
def test_unsupported_types_raise_by_name(tmp_path, kind):
    path = str(tmp_path / "u.parquet")
    kw = {}
    if kind == "int96":
        col = pa.array(np.arange(10) * 10**9, type=pa.timestamp("ns"))
        kw["use_deprecated_int96_timestamps"] = True
        match = "INT96"
    elif kind == "nested":
        col = pa.array([[1, 2], [3]] * 5)
        match = "nested"
    elif kind == "uint8":
        col = pa.array(np.arange(10, dtype=np.uint8))
        match = "INT32 .*INTEGER"
    else:
        col = pa.array([b"ab"] * 10)
        match = "BYTE_ARRAY"
    pq.write_table(pa.table({"x": col}), path, **kw)
    with pytest.raises(NotImplementedError, match=match):
        ParquetFile(path).columns()
    if kind != "int96":  # pyarrow reads INT96 as timestamp[ns], which JAX maps
        with pytest.raises(NotImplementedError):
            _jax_types(path)


def test_decimal_over_38_raises_as_jax(tmp_path):
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"x": pa.array([decimal.Decimal(1)], type=pa.decimal256(40, 2))}), path)
    with pytest.raises(NotImplementedError) as jerr:
        _jax_types(path)
    with pytest.raises(NotImplementedError) as perr:
        ParquetFile(path).columns()
    assert str(perr.value) == str(jerr.value)


def test_thrift_skips_unknown_fields_of_every_wire_type():
    """A struct carrying field ids the spec does not name, of every wire
    type, decodes to the named fields alone."""
    spec = {1: ("a", "i32"), 20: ("z", "str")}
    unknown = {
        2: ("t", "bool"), 3: ("f", "bool"), 4: ("i8", "i8"), 5: ("i16", "i16"),
        6: ("i64", "i64"), 7: ("d", "double"), 8: ("bin", "binary"),
        9: ("lst", ("list", "i32")), 10: ("lstr", ("list", {1: ("q", "i64")})),
        11: ("s", {1: ("x", "i32"), 2: ("y", ("list", "bool"))}),
        30: ("far", "i64"),
    }
    full = {**spec, **unknown}
    obj = {"a": -5, "z": "zz", "t": True, "f": False, "i8": -3, "i16": 300,
           "i64": -2**40, "d": 1.5, "bin": b"\x00\x01", "lst": list(range(20)),
           "lstr": [{"q": 1}, {"q": -2}], "s": {"x": 9, "y": [True, False]},
           "far": 7}
    raw = th.write_struct(full, obj)
    assert th.read_struct(raw, full)[0] == obj
    assert th.read_struct(raw, spec)[0] == {"a": -5, "z": "zz"}
    # a map field (wire type 11) is skipped too
    w = th.Writer()
    w.out += bytes([0x1B])  # field 1, MAP
    w.varint(2)
    w.out.append((th.I32 << 4) | th.BINARY)
    for k, v in ((1, b"x"), (2, b"yy")):
        w.zigzag(k)
        w.varint(len(v))
        w.out += v
    w.out += bytes([0x15])  # field 2, I32
    w.zigzag(42)
    w.out.append(0)
    assert th.read_struct(bytes(w.out), {2: ("b", "i32")})[0] == {"b": 42}


def test_snappy_decoder_against_pyarrow():
    rng = np.random.default_rng(11)
    data = (rng.integers(0, 256, 5000, dtype=np.uint8).tobytes() + b"abcd" * 3000
            + bytes(70000) + rng.integers(0, 4, 20000, dtype=np.uint8).tobytes())
    assert snappy_decompress(pa.compress(data, "snappy", asbytes=True)) == data


# -- files the port writes ------------------------------------------------------


@pytest.mark.parametrize("codec", ["GZIP", "UNCOMPRESSED"])
def test_port_files_read_back_by_pyarrow_and_jax(tmp_path, codec):
    src = str(tmp_path / "src.parquet")
    pq.write_table(_every_type_table(5).drop(["ts_ms"]), src)
    pf = ParquetFile(src)
    cols = pf.columns()
    names = [c.name for c in cols]
    data = pf.read_row_group(0, names)
    out = str(tmp_path / "s" / "port.parquet")
    os.makedirs(os.path.dirname(out))
    write_columns(out, names, [c.type for c in cols], data, row_group_rows=1100,
                  codec=codec, page_rows=500)
    back = pq.read_table(out)
    expected = pq.read_table(src)
    for n in names:
        want = expected.column(n)
        if n == "ts_ns":
            want = want.cast(pa.timestamp("us"))
        assert back.column(n).to_pylist() == want.to_pylist(), n
    # the JAX connector over the port's file and over pyarrow's
    assert _jax_types(out) == [jpq._arrow_to_type(f.type) for f in pq.read_schema(out)]
    assert [t.name for t in _jax_types(out)] == [c.type.name for c in cols]
    jc = jpq.ParquetConnector(str(tmp_path))
    jr = JaxRunner(_one_catalog(jc, jax=True), catalog="pq", schema="s")
    pr = LocalQueryRunner(_one_catalog(ParquetConnector(str(tmp_path)), jax=False),
                          catalog="pq", schema="s", device="cpu")
    sql = ("select b, i8, i16, i32, i64, f32, f64, d_short, d_18, d_long, d_38, dt, "
           "ts_ns, s, s_wide, s_null from port")
    assert_same_rows(pr.execute(sql).rows, jr.execute(sql).rows, False, 1e-9)


def _one_catalog(conn, jax: bool):
    cm = JaxCatalogs() if jax else CatalogManager()
    cm.register("pq", conn)
    return cm


# -- TPC-H over parquet ---------------------------------------------------------

TABLES = ("lineitem", "orders", "customer", "nation", "region")


@pytest.fixture(scope="module")
def tpch_parquet(tmp_path_factory):
    """tpch.tiny written twice: by pyarrow (the JAX package's writer) and by
    the port's writer."""
    jax_root = str(tmp_path_factory.mktemp("pq_jax"))
    port_root = str(tmp_path_factory.mktemp("pq_port"))
    jt, pt = JaxTpch(), TpchConnector()
    for table in TABLES:
        jpq.write_table_to_parquet(jt, "tiny", table, jax_root)
        write_table_to_parquet(pt, "tiny", table, port_root)
    cm = JaxCatalogs()
    cm.register("tpch", jt)
    cm.register("pq", jpq.ParquetConnector(jax_root))
    jax = JaxRunner(cm, catalog="pq", schema="tiny", target_splits=2)
    return {"jax": jax, "roots": {"pyarrow": jax_root, "port": port_root}}


def _port_catalogs(root):
    cm = CatalogManager()
    cm.register("tpch", TpchConnector())
    cm.register("pq", ParquetConnector(root))
    return cm


@pytest.fixture(scope="module")
def jax_rows(tpch_parquet):
    jax = tpch_parquet["jax"]
    return {q: jax.execute(QUERIES[q]).rows for q in (1, 6, 3)}


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
def test_table_metadata_types_equal_jax(tpch_parquet, writer):
    root = tpch_parquet["roots"][writer]
    port = ParquetConnector(root).metadata()
    jax = jpq.ParquetConnector(root).metadata()
    assert port.list_tables("tiny") == jax.list_tables("tiny") == sorted(TABLES)
    for table in TABLES:
        pm, jm = port.table_metadata("tiny", table), jax.table_metadata("tiny", table)
        assert [(c.name, c.type.name) for c in pm.columns] == [
            (c.name, c.type.name) for c in jm.columns
        ]
        assert (port.table_statistics("tiny", table).row_count
                == jax.table_statistics("tiny", table).row_count)


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
def test_jax_connector_reads_both_writers(tpch_parquet, writer):
    """The JAX ParquetConnector's rows over each writer's files equal the
    JAX package's generator rows (the port's files are pyarrow-readable)."""
    cm = JaxCatalogs()
    cm.register("tpch", JaxTpch())
    cm.register("pq", jpq.ParquetConnector(tpch_parquet["roots"][writer]))
    r = JaxRunner(cm, catalog="pq", schema="tiny")
    for table in ("orders", "customer"):
        sql = f"select * from {table}"
        got = r.execute(sql).rows
        want = r.execute(f"select * from tpch.tiny.{table}").rows
        assert_same_rows(got, want, False, 1e-9)


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
@pytest.mark.parametrize("q", [1, 6, 3])
def test_tpch_local_over_parquet_equals_jax(tpch_parquet, jax_rows, writer, q):
    r = LocalQueryRunner(_port_catalogs(tpch_parquet["roots"][writer]),
                         catalog="pq", schema="tiny", target_splits=2, device="cpu")
    assert_same_rows(r.execute(QUERIES[q]).rows, jax_rows[q], q != 6, 1e-9)


@pytest.mark.parametrize("writer", ["pyarrow", "port"])
@pytest.mark.parametrize("q", [1, 6, 3])
def test_tpch_mesh_over_parquet_equals_jax(tpch_parquet, jax_rows, writer, q):
    m = DistributedQueryRunner(_port_catalogs(tpch_parquet["roots"][writer]),
                               catalog="pq", schema="tiny", n_workers=4, device="cpu")
    m.execute("set session pallas_probe = true")
    before = ls.locate_sorted_reference.launches
    assert_same_rows(m.execute(QUERIES[q]).rows, jax_rows[q], q != 6, 1e-9)
    if q == 3:  # the mesh joins search through K2 (its plain version here)
        assert ls.locate_sorted_reference.launches > before


def test_parquet_scans_reach_the_kernels_as_generated_scans_do(tpch_parquet):
    """Q1-double under `pallas_agg` launches K1 over the parquet lineitem
    as over the generator's, and the mesh Q3 under `pallas_probe` launches
    K2 over both."""
    root = tpch_parquet["roots"]["port"]
    counts = {}
    for catalog in ("tpch", "pq"):
        r = LocalQueryRunner(_port_catalogs(root), catalog=catalog, schema="tiny", device="cpu")
        r.execute("set session pallas_agg = true")
        before = gs.grouped_sums_reference.launches
        rows = r.execute(Q1_DOUBLE).rows
        k1 = gs.grouped_sums_reference.launches - before
        m = DistributedQueryRunner(_port_catalogs(root), catalog=catalog, schema="tiny",
                                   n_workers=4, device="cpu")
        m.execute("set session pallas_probe = true")
        before = ls.locate_sorted_reference.launches
        q3 = m.execute(QUERIES[3]).rows
        counts[catalog] = (k1, ls.locate_sorted_reference.launches - before, rows, q3)
    assert counts["pq"][0] > 0 and counts["tpch"][0] > 0
    assert counts["pq"][1] == counts["tpch"][1] > 0
    assert_same_rows(counts["pq"][2], counts["tpch"][2], True, 5e-5)
    assert_same_rows(counts["pq"][3], counts["tpch"][3], True, 1e-9)


def test_parquet_scan_cached(tpch_parquet):
    from trino_tpu_torch.runtime.buffer_pool import POOL

    r = LocalQueryRunner(_port_catalogs(tpch_parquet["roots"]["port"]),
                         catalog="pq", schema="tiny", device="cpu")
    r.execute("select sum(l_extendedprice) from lineitem")
    before = POOL.stats()["device_hits"]
    r.execute("select sum(l_extendedprice) from lineitem")
    assert POOL.stats()["device_hits"] > before


def test_describe_and_counts_match_generator(tpch_parquet):
    r = LocalQueryRunner(_port_catalogs(tpch_parquet["roots"]["port"]),
                         catalog="pq", schema="tiny", device="cpu")
    base = lambda t: t.split("(")[0] if t.startswith("varchar") else t
    assert [(n, base(t)) for n, t in r.execute("describe lineitem").rows] == [
        (n, base(t)) for n, t in r.execute("describe tpch.tiny.lineitem").rows
    ]
    for table in TABLES:
        assert (r.execute(f"select count(*) from {table}").rows
                == r.execute(f"select count(*) from tpch.tiny.{table}").rows)

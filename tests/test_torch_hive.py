"""The port's hive connector (trino_tpu_torch/connectors/hive.py, over the
port's own parquet and ORC readers and writers) against the JAX package's:
the parquet and the ORC cases of tests/test_hive.py on both packages, each
package reading the layout either package wrote (the JAX package writes
through pyarrow), partition pruning with the JAX package's split counts, a
table whose partitions mix parquet and ORC files, and TPC-H Q1, Q6, Q3 and
Q12 at tpch.tiny over hive ORC tables, local and on the 4-worker mesh, with
the JAX package's rows and partition pruning, reaching K1 and K2 (their
plain versions) as a generator-fed scan does."""

import os
import shutil

import pytest

from trino_tpu.connectors.api import CatalogManager as JaxCatalogs
from trino_tpu.connectors.api import TableHandle as JaxHandle
from trino_tpu.connectors import hive as jhive
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.connectors import hive as phive
from trino_tpu_torch.connectors.api import CatalogManager, TableHandle
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.ops import grouped_sums as gs
from trino_tpu_torch.ops import locate_sorted as ls
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import Q1_DOUBLE, assert_same_rows

PKGS = ("jax", "port")


def _write(pkg, root, table="nation", by=("n_regionkey",), fmt="parquet"):
    if pkg == "jax":
        return jhive.write_partitioned(JaxTpch(), "tiny", table, root, partition_by=list(by),
                                       fmt=fmt)
    return phive.write_partitioned(TpchConnector(), "tiny", table, root, partition_by=list(by),
                                   fmt=fmt)


@pytest.fixture(scope="module", params=PKGS)
def hive_root(request, tmp_path_factory):
    """tiny.nation partitioned by n_regionkey, written by one package."""
    root = str(tmp_path_factory.mktemp(f"hive_{request.param}"))
    assert _write(request.param, root) == 5
    return root


@pytest.fixture(scope="module", params=PKGS)
def hive_orc_root(request, tmp_path_factory):
    """tiny.nation partitioned by n_regionkey as ORC, written by one package
    (the JAX package's writer is pyarrow's)."""
    root = str(tmp_path_factory.mktemp(f"hive_orc_{request.param}"))
    assert _write(request.param, root, fmt="orc") == 5
    return root


def _conn(pkg, root):
    return jhive.HiveConnector(root) if pkg == "jax" else phive.HiveConnector(root)


def _runner(pkg, root):
    if pkg == "jax":
        cm = JaxCatalogs()
        cm.register("hive", jhive.HiveConnector(root))
        cm.register("tpch", JaxTpch())
        return JaxRunner(cm, catalog="hive", schema="tiny", target_splits=4)
    cm = CatalogManager()
    cm.register("hive", phive.HiveConnector(root))
    cm.register("tpch", TpchConnector())
    return LocalQueryRunner(cm, catalog="hive", schema="tiny", target_splits=4, device="cpu")


def _handle(pkg):
    return (JaxHandle if pkg == "jax" else TableHandle)("hive", "tiny", "nation")


def _check_metadata(root, pkg):
    conn = _conn(pkg, root)
    meta = conn.metadata().table_metadata("tiny", "nation")
    names = [c.name for c in meta.columns]
    assert "n_regionkey" in names and "n_name" in names
    assert conn.metadata().list_tables("tiny") == ["nation"]
    jm = jhive.HiveConnector(root).metadata().table_metadata("tiny", "nation")
    assert [(c.name, c.type.name) for c in meta.columns] == [
        (c.name, c.type.name) for c in jm.columns
    ]


def _check_full_scan(root, pkg):
    r = _runner(pkg, root)
    hive_rows = r.execute(
        "SELECT n_nationkey, n_name, n_regionkey FROM nation ORDER BY n_nationkey"
    ).rows
    tpch_rows = r.execute(
        "SELECT n_nationkey, n_name, n_regionkey FROM tpch.tiny.nation ORDER BY n_nationkey"
    ).rows
    assert hive_rows == tpch_rows
    assert len(hive_rows) == 25


def _check_pruning(root, pkg):
    conn = _conn(pkg, root)
    all_splits = conn.splits(_handle(pkg), target_splits=4)
    pruned = conn.splits(_handle(pkg), target_splits=4, predicate=[("n_regionkey", "=", 2)])
    assert len(pruned) < len(all_splits)
    assert all(s.info[2]["n_regionkey"] == "2" for s in pruned)
    rows = _runner(pkg, root).execute(
        "SELECT count(*) FROM nation WHERE n_regionkey = 2"
    ).rows
    assert rows == [(5,)]


def _check_range_pruning(root, pkg):
    conn = _conn(pkg, root)
    pruned = conn.splits(_handle(pkg), target_splits=4, predicate=[("n_regionkey", ">=", 3)])
    assert {s.info[2]["n_regionkey"] for s in pruned} == {"3", "4"}
    rows = _runner(pkg, root).execute(
        "SELECT count(*) FROM nation WHERE n_regionkey >= 3"
    ).rows
    assert rows == [(10,)]


def _check_aggregation(root, pkg):
    rows = _runner(pkg, root).execute(
        "SELECT n_regionkey, count(*) FROM nation GROUP BY n_regionkey ORDER BY n_regionkey"
    ).rows
    assert rows == [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5)]


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_metadata(hive_root, pkg):
    _check_metadata(hive_root, pkg)


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_full_scan_matches_generator(hive_root, pkg):
    _check_full_scan(hive_root, pkg)


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_partition_pruning(hive_root, pkg):
    _check_pruning(hive_root, pkg)


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_partition_range_pruning(hive_root, pkg):
    _check_range_pruning(hive_root, pkg)


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_aggregation(hive_root, pkg):
    _check_aggregation(hive_root, pkg)


_CHECKS = {"metadata": _check_metadata, "full_scan": _check_full_scan,
           "pruning": _check_pruning, "range_pruning": _check_range_pruning,
           "aggregation": _check_aggregation}


@pytest.mark.parametrize("case", list(_CHECKS))
@pytest.mark.parametrize("pkg", PKGS)
def test_hive_orc_cases(hive_orc_root, pkg, case):
    """The ORC cases of tests/test_hive.py: the layout one package wrote
    (`hive_orc_root`), read by `pkg`."""
    _CHECKS[case](hive_orc_root, pkg)


@pytest.mark.parametrize("predicate", [
    None, [("n_regionkey", "=", 2)], [("n_regionkey", ">=", 3)],
    [("n_regionkey", "in", (0, 4))], [("n_regionkey", "<", 1), ("n_name", "=", "x")],
])
def test_pruned_split_counts_equal_jax(hive_root, predicate):
    """The same splits (seq, rows, partition values) in both packages."""
    def key(splits):
        return [(s.seq, s.row_start, s.row_count, s.info[1], dict(s.info[2])) for s in splits]

    p = phive.HiveConnector(hive_root).splits(_handle("port"), 4, predicate=predicate)
    j = jhive.HiveConnector(hive_root).splits(_handle("jax"), 4, predicate=predicate)
    assert key(p) == key(j)


def test_partitioned_orders_by_priority_equal_jax(tmp_path):
    """orders partitioned by a varchar key (o_orderpriority): the
    directories, the partition types and the rows equal the JAX package's,
    and a predicate on the partition column reads one partition."""
    roots = {}
    for pkg in PKGS:
        roots[pkg] = str(tmp_path / pkg)
        assert _write(pkg, roots[pkg], "orders", ("o_orderpriority",)) == 5
    dirs = {
        pkg: sorted(os.listdir(os.path.join(roots[pkg], "tiny", "orders"))) for pkg in PKGS
    }
    assert dirs["jax"] == dirs["port"]
    sql = ("select o_orderpriority, count(*), sum(o_totalprice), max(o_orderdate) "
           "from orders where o_orderpriority = '1-URGENT' group by o_orderpriority")
    want = _runner("jax", roots["jax"]).execute(sql).rows
    for pkg in PKGS:
        r = _runner("port", roots[pkg])
        assert_same_rows(r.execute(sql).rows, want, False, 1e-9)
        conn = phive.HiveConnector(roots[pkg])
        h = TableHandle("hive", "tiny", "orders")
        pruned = conn.splits(h, 4, predicate=[("o_orderpriority", "=", "1-URGENT")])
        assert len({s.info[0] for s in pruned}) == 1
        assert len(conn.splits(h, 4)) == 5 * len(pruned)


def _split_key(splits):
    return [(s.seq, s.row_start, s.row_count, s.info[1], dict(s.info[2])) for s in splits]


@pytest.mark.parametrize("predicate", [None, [("n_regionkey", "in", (0, 4))]])
def test_orc_pruned_split_counts_equal_jax(hive_orc_root, predicate):
    """One split per stripe, the same in both packages."""
    p = phive.HiveConnector(hive_orc_root).splits(_handle("port"), 4, predicate=predicate)
    j = jhive.HiveConnector(hive_orc_root).splits(_handle("jax"), 4, predicate=predicate)
    assert _split_key(p) == _split_key(j) and p


def test_partitions_mixing_parquet_and_orc_read_as_jax(tmp_path):
    """Regions 0-1 parquet (the port's writer), 2-3 ORC (pyarrow's), 4 both
    (the port's parquet and ORC files side by side): the metadata, the
    splits and the rows equal the JAX package's."""
    layouts = {}
    for name, pkg, fmt in (("pq", "port", "parquet"), ("orc_jax", "jax", "orc"),
                           ("orc_port", "port", "orc")):
        layouts[name] = str(tmp_path / name)
        assert _write(pkg, layouts[name], fmt=fmt) == 5
    root = str(tmp_path / "mixed")
    take = {0: ["pq"], 1: ["pq"], 2: ["orc_jax"], 3: ["orc_jax"], 4: ["pq", "orc_port"]}
    for region, sources in take.items():
        d = os.path.join(root, "tiny", "nation", f"n_regionkey={region}")
        os.makedirs(d)
        for src in sources:
            sd = os.path.join(layouts[src], "tiny", "nation", f"n_regionkey={region}")
            for f in os.listdir(sd):
                shutil.copy(os.path.join(sd, f), d)
    assert sorted(os.listdir(os.path.join(root, "tiny", "nation", "n_regionkey=4"))) == [
        "part-0.orc", "part-0.parquet"]
    _check_metadata(root, "port")
    p = phive.HiveConnector(root).splits(_handle("port"), 4)
    j = jhive.HiveConnector(root).splits(_handle("jax"), 4)
    assert _split_key(p) == _split_key(j)
    assert {os.path.splitext(s.info[0])[1] for s in p} == {".parquet", ".orc"}
    for sql, ordered in (("select * from nation order by n_nationkey, n_name", False),
                         ("select n_regionkey, count(*), min(n_name), max(n_comment) "
                          "from nation group by n_regionkey order by n_regionkey", True)):
        want = _runner("jax", root).execute(sql).rows
        assert_same_rows(_runner("port", root).execute(sql).rows, want, ordered, 0.0)
    assert _runner("port", root).execute("select count(*) from nation").rows == [(30,)]


# -- TPC-H over hive ORC --------------------------------------------------------

#: the tables of Q1, Q6, Q3 and Q12 and the partition column of each
TPCH_PARTITIONS = {"lineitem": "l_shipmode", "orders": "o_orderpriority",
                   "customer": "c_mktsegment"}
TPCH_QUERIES = (1, 6, 3, 12)


def _recording(conn, seen: list):
    """Record each `splits` call's table and the partition directories it
    enumerated."""
    plain = conn.splits

    def splits(handle, target_splits, predicate=None):
        out = plain(handle, target_splits, predicate)
        seen.append((handle.table, sorted({os.path.basename(os.path.dirname(s.info[0]))
                                           for s in out})))
        return out

    conn.splits = splits
    return conn


def _orc_catalogs(root, seen=None):
    cm = CatalogManager()
    cm.register("tpch", TpchConnector())
    conn = phive.HiveConnector(root)
    cm.register("hive", conn if seen is None else _recording(conn, seen))
    return cm


@pytest.fixture(scope="module")
def tpch_orc(tmp_path_factory):
    """tpch.tiny's lineitem, orders and customer as hive ORC tables, written
    by pyarrow (the JAX package's writer) and by the port's writer; the JAX
    package's rows over pyarrow's files and the partitions each query's
    scans enumerated."""
    roots = {}
    for pkg in PKGS:
        roots[pkg] = str(tmp_path_factory.mktemp(f"tpch_orc_{pkg}"))
        for table, by in TPCH_PARTITIONS.items():
            _write(pkg, roots[pkg], table, (by,), fmt="orc")
    cm = JaxCatalogs()
    cm.register("tpch", JaxTpch())
    seen: list = []
    cm.register("hive", _recording(jhive.HiveConnector(roots["jax"]), seen))
    jax = JaxRunner(cm, catalog="hive", schema="tiny", target_splits=2)
    rows, splits = {}, {}
    for q in TPCH_QUERIES:
        seen.clear()
        rows[q] = jax.execute(QUERIES[q]).rows
        splits[q] = sorted(seen)
    return {"roots": roots, "rows": rows, "splits": splits}


def test_orc_partition_counts_and_pruning(tpch_orc):
    """Q3's `c_mktsegment = 'BUILDING'` enumerates 1 customer partition of 5,
    Q12's `l_shipmode IN ('MAIL', 'SHIP')` 2 lineitem partitions of 7."""
    for pkg in PKGS:
        base = os.path.join(tpch_orc["roots"][pkg], "tiny")
        assert [len(os.listdir(os.path.join(base, t))) for t in TPCH_PARTITIONS] == [7, 5, 5]
    q3 = dict(tpch_orc["splits"][3])
    assert q3["customer"] == ["c_mktsegment=BUILDING"] and len(q3["orders"]) == 5
    q12 = dict(tpch_orc["splits"][12])
    assert q12["lineitem"] == ["l_shipmode=MAIL", "l_shipmode=SHIP"]


@pytest.mark.parametrize("q", TPCH_QUERIES)
@pytest.mark.parametrize("writer", PKGS)
def test_tpch_local_over_hive_orc_equals_jax(tpch_orc, writer, q):
    seen: list = []
    r = LocalQueryRunner(_orc_catalogs(tpch_orc["roots"][writer], seen), catalog="hive",
                         schema="tiny", target_splits=2, device="cpu")
    assert_same_rows(r.execute(QUERIES[q]).rows, tpch_orc["rows"][q], q != 6, 1e-9)
    assert sorted(seen) == tpch_orc["splits"][q]


@pytest.mark.parametrize("q", TPCH_QUERIES)
@pytest.mark.parametrize("writer", PKGS)
def test_tpch_mesh_over_hive_orc_equals_jax(tpch_orc, writer, q):
    seen: list = []
    m = DistributedQueryRunner(_orc_catalogs(tpch_orc["roots"][writer], seen), catalog="hive",
                               schema="tiny", n_workers=4, device="cpu")
    m.execute("set session pallas_probe = true")
    before = ls.locate_sorted_reference.launches
    assert_same_rows(m.execute(QUERIES[q]).rows, tpch_orc["rows"][q], q != 6, 1e-9)
    assert {t: d for t, d in seen} == dict(tpch_orc["splits"][q])
    if q in (3, 12):  # the mesh joins search through K2 (its plain version here)
        assert ls.locate_sorted_reference.launches > before


def test_orc_scans_reach_the_kernels_as_generated_scans_do(tpch_orc):
    """Q1-double under `pallas_agg` launches K1 over the ORC lineitem as over
    the generator's, and the mesh Q3 and Q12 under `pallas_probe` launch K2
    as often over both."""
    root = tpch_orc["roots"]["port"]
    counts = {}
    for catalog in ("tpch", "hive"):
        r = LocalQueryRunner(_orc_catalogs(root), catalog=catalog, schema="tiny", device="cpu")
        r.execute("set session pallas_agg = true")
        before = gs.grouped_sums_reference.launches
        rows = r.execute(Q1_DOUBLE).rows
        k1 = gs.grouped_sums_reference.launches - before
        m = DistributedQueryRunner(_orc_catalogs(root), catalog=catalog, schema="tiny",
                                   n_workers=4, device="cpu")
        m.execute("set session pallas_probe = true")
        k2, mesh = [], []
        for q in (3, 12):
            before = ls.locate_sorted_reference.launches
            mesh.append(m.execute(QUERIES[q]).rows)
            k2.append(ls.locate_sorted_reference.launches - before)
        counts[catalog] = (k1, k2, rows, mesh)
    assert counts["hive"][0] > 0 and counts["tpch"][0] > 0
    assert counts["hive"][1] == counts["tpch"][1] and min(counts["hive"][1]) > 0
    assert_same_rows(counts["hive"][2], counts["tpch"][2], True, 5e-5)
    for got, want in zip(counts["hive"][3], counts["tpch"][3]):
        assert_same_rows(got, want, True, 1e-9)

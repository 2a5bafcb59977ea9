"""The port's hive connector (trino_tpu_torch/connectors/hive.py, over the
port's own parquet reader and writer) against the JAX package's: the parquet
cases of tests/test_hive.py on both packages, each package reading the
layout either package wrote, partition pruning with the JAX package's split
counts, and ORC raising NotImplementedError by name in the port."""

import os

import pytest

from trino_tpu.connectors.api import CatalogManager as JaxCatalogs
from trino_tpu.connectors.api import TableHandle as JaxHandle
from trino_tpu.connectors import hive as jhive
from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.connectors import hive as phive
from trino_tpu_torch.connectors.api import CatalogManager, TableHandle
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows

PKGS = ("jax", "port")


def _write(pkg, root, table="nation", by=("n_regionkey",)):
    if pkg == "jax":
        return jhive.write_partitioned(JaxTpch(), "tiny", table, root, partition_by=list(by))
    return phive.write_partitioned(TpchConnector(), "tiny", table, root, partition_by=list(by))


@pytest.fixture(scope="module", params=PKGS)
def hive_root(request, tmp_path_factory):
    """tiny.nation partitioned by n_regionkey, written by one package."""
    root = str(tmp_path_factory.mktemp(f"hive_{request.param}"))
    assert _write(request.param, root) == 5
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


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_metadata(hive_root, pkg):
    conn = _conn(pkg, hive_root)
    meta = conn.metadata().table_metadata("tiny", "nation")
    names = [c.name for c in meta.columns]
    assert "n_regionkey" in names and "n_name" in names
    assert conn.metadata().list_tables("tiny") == ["nation"]
    jm = jhive.HiveConnector(hive_root).metadata().table_metadata("tiny", "nation")
    assert [(c.name, c.type.name) for c in meta.columns] == [
        (c.name, c.type.name) for c in jm.columns
    ]


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_full_scan_matches_generator(hive_root, pkg):
    r = _runner(pkg, hive_root)
    hive_rows = r.execute(
        "SELECT n_nationkey, n_name, n_regionkey FROM nation ORDER BY n_nationkey"
    ).rows
    tpch_rows = r.execute(
        "SELECT n_nationkey, n_name, n_regionkey FROM tpch.tiny.nation ORDER BY n_nationkey"
    ).rows
    assert hive_rows == tpch_rows
    assert len(hive_rows) == 25


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_partition_pruning(hive_root, pkg):
    conn = _conn(pkg, hive_root)
    all_splits = conn.splits(_handle(pkg), target_splits=4)
    pruned = conn.splits(_handle(pkg), target_splits=4, predicate=[("n_regionkey", "=", 2)])
    assert len(pruned) < len(all_splits)
    assert all(s.info[2]["n_regionkey"] == "2" for s in pruned)
    rows = _runner(pkg, hive_root).execute(
        "SELECT count(*) FROM nation WHERE n_regionkey = 2"
    ).rows
    assert rows == [(5,)]


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_partition_range_pruning(hive_root, pkg):
    conn = _conn(pkg, hive_root)
    pruned = conn.splits(_handle(pkg), target_splits=4, predicate=[("n_regionkey", ">=", 3)])
    assert {s.info[2]["n_regionkey"] for s in pruned} == {"3", "4"}
    rows = _runner(pkg, hive_root).execute(
        "SELECT count(*) FROM nation WHERE n_regionkey >= 3"
    ).rows
    assert rows == [(10,)]


@pytest.mark.parametrize("pkg", PKGS)
def test_hive_aggregation(hive_root, pkg):
    rows = _runner(pkg, hive_root).execute(
        "SELECT n_regionkey, count(*) FROM nation GROUP BY n_regionkey ORDER BY n_regionkey"
    ).rows
    assert rows == [(0, 5), (1, 5), (2, 5), (3, 5), (4, 5)]


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


def test_orc_raises_by_name_in_the_port(tmp_path):
    root = str(tmp_path)
    with pytest.raises(NotImplementedError, match="ORC .*not ported yet"):
        phive.write_partitioned(TpchConnector(), "tiny", "nation", root,
                                partition_by=["n_regionkey"], fmt="orc")
    # a layout holding .orc files (the JAX package writes them)
    assert jhive.write_partitioned(JaxTpch(), "tiny", "nation", root,
                                   partition_by=["n_regionkey"], fmt="orc") == 5
    conn = phive.HiveConnector(root)
    with pytest.raises(NotImplementedError, match="ORC .*not ported yet"):
        conn.metadata().table_metadata("tiny", "nation")
    with pytest.raises(NotImplementedError, match="ORC .*not ported yet"):
        conn.metadata().table_statistics("tiny", "nation")
    with pytest.raises(NotImplementedError, match="ORC"):
        _runner("port", root).execute("select count(*) from nation")

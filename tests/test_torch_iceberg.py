"""The port's iceberg connector (trino_tpu_torch/connectors/iceberg.py, data
files through the port's own parquet writer and reader) against the JAX
package's (pyarrow): every case of tests/test_iceberg.py runs on both
packages, and a warehouse written by one package is read by the other
(snapshots, time travel, metadata tables, rows)."""

import pytest

from trino_tpu.connectors.api import CatalogManager as JaxCatalogs
from trino_tpu.connectors.iceberg import IcebergConnector as JaxIceberg
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.connectors.iceberg import IcebergConnector
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows

PKGS = ("jax", "port")


def make_runner(pkg: str, root: str):
    if pkg == "jax":
        cm = JaxCatalogs()
        cm.register("ice", JaxIceberg(root))
        return JaxRunner(cm, catalog="ice", schema="s")
    cm = CatalogManager()
    cm.register("ice", IcebergConnector(root))
    return LocalQueryRunner(cm, catalog="ice", schema="s", device="cpu")


def _seed(r):
    r.execute("create table t (a bigint, b varchar, c double)")
    r.execute("insert into t values (1,'x',1.5),(2,'y',2.5)")
    r.execute("insert into t values (3,'z',3.5)")
    return r


@pytest.fixture(params=PKGS)
def runner(request, tmp_path):
    return _seed(make_runner(request.param, str(tmp_path)))


def test_read_current_snapshot(runner):
    assert runner.execute("select * from t order by a").rows == [
        (1, "x", 1.5), (2, "y", 2.5), (3, "z", 3.5),
    ]


def test_snapshots_metadata_table(runner):
    rows = runner.execute(
        'select snapshot_id, operation, total_records from "t$snapshots" '
        "order by snapshot_id"
    ).rows
    assert rows == [(1, "create", 0), (2, "append", 2), (3, "append", 3)]


def test_files_metadata_table(runner):
    rows = runner.execute(
        'select record_count from "t$files" order by record_count'
    ).rows
    assert rows == [(1,), (2,)]


def test_history_metadata_table(runner):
    rows = runner.execute(
        'select snapshot_id, operation from "t$history" order by snapshot_id'
    ).rows
    assert [r[1] for r in rows] == ["create", "append", "append"]


def test_time_travel(runner):
    assert runner.execute('select * from "t@2" order by a').rows == [
        (1, "x", 1.5), (2, "y", 2.5),
    ]
    assert runner.execute('select count(*) from "t@1"').rows == [(0,)]


def test_dml_preserves_history(runner):
    runner.execute("delete from t where a = 2")
    assert runner.execute("select a from t order by a").rows == [(1,), (3,)]
    assert runner.execute('select count(*) from "t@3"').rows == [(3,)]
    runner.execute("update t set c = 99.0 where b = 'z'")
    assert runner.execute("select c from t where a = 3").rows == [(99.0,)]


def test_transaction_rollback(runner):
    runner.execute("start transaction")
    runner.execute("delete from t")
    assert runner.execute("select count(*) from t").rows == [(0,)]
    runner.execute("rollback")
    assert runner.execute("select count(*) from t").rows == [(3,)]


def test_joins_and_aggregation_over_iceberg(runner):
    rows = runner.execute(
        "select b, sum(c) s from t group by b order by b"
    ).rows
    assert rows == [("x", 1.5), ("y", 2.5), ("z", 3.5)]


# -- one warehouse, two packages ---------------------------------------------------

TYPED = (
    "create table w as select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
    "o_orderdate, o_orderpriority, cast(o_shippriority as smallint) sp, "
    "cast(o_totalprice as decimal(30,4)) big, cast(o_totalprice as double) dbl, "
    "o_orderkey % 7 = 0 flag "
    "from tpch.tiny.orders where o_orderkey < 2000"
)
STEPS = (
    "insert into w select o_orderkey + 100000, o_custkey, o_orderstatus, o_totalprice, "
    "o_orderdate, o_orderpriority, cast(o_shippriority as smallint), "
    "cast(o_totalprice as decimal(30,4)), cast(o_totalprice as double), null "
    "from tpch.tiny.orders where o_orderkey < 600",
    "delete from w where o_orderstatus = 'P'",
    "update w set dbl = 0.5 where o_custkey < 50",
)
READS = (
    "select * from w",
    'select * from "w@2"',
    'select snapshot_id, operation, file_count, total_records from "w$snapshots"',
    'select record_count, snapshot_id from "w$files"',
    'select snapshot_id, parent_id, operation from "w$history"',
    "select o_orderpriority, count(*), sum(big), sum(o_totalprice), min(o_orderdate) "
    "from w group by o_orderpriority",
)


def _warehouse_runner(pkg, root):
    from trino_tpu.connectors.tpch import TpchConnector as JaxTpch
    from trino_tpu_torch.connectors.tpch import TpchConnector

    if pkg == "jax":
        cm = JaxCatalogs()
        cm.register("ice", JaxIceberg(root))
        cm.register("tpch", JaxTpch())
        return JaxRunner(cm, catalog="ice", schema="s")
    cm = CatalogManager()
    cm.register("ice", IcebergConnector(root))
    cm.register("tpch", TpchConnector())
    return LocalQueryRunner(cm, catalog="ice", schema="s", device="cpu")


@pytest.mark.parametrize("writer", PKGS)
def test_warehouse_written_by_one_package_read_by_the_other(tmp_path, writer):
    root = str(tmp_path)
    w = _warehouse_runner(writer, root)
    w.execute(TYPED)
    for sql in STEPS:
        w.execute(sql)
    reader = _warehouse_runner("port" if writer == "jax" else "jax", root)
    for sql in READS:
        got = reader.execute(sql)
        want = w.execute(sql)
        assert [t.name for t in got.types] == [t.name for t in want.types], sql
        assert_same_rows(got.rows, want.rows, False, 1e-9)
    # the reader appends to the writer's table, and the writer reads it back
    reader.execute("insert into w select * from w where o_orderkey < 100")
    for sql in ("select * from w", 'select operation, total_records from "w$snapshots"'):
        assert_same_rows(w.execute(sql).rows, reader.execute(sql).rows, False, 1e-9)

"""DELETE, UPDATE, MERGE and transactions in the port against the JAX
package, locally and on the 4-worker mesh.

Local: every case of tests/test_dml.py (over one memory catalog named
`mem`, as its fixture builds) and of tests/test_merge.py, and the
transaction cases below, run statement by statement through the JAX
package's LocalQueryRunner and the port's LocalQueryRunner(device="cpu")
(`test_torch_ddl.StatementPair`): after each statement the result and
every stored table (rows as a multiset with each dictionary column's
codes, and the dictionaries) must be equal.  A rollback must restore the
pre-image, dictionaries included; a failed MERGE leaves the target as it
was.

Mesh: the port's 4-worker mesh runs CTAS, INSERT ... SELECT, DELETE,
UPDATE and MERGE (the queries inside them over the stage executor), each
held to ONE JAX local run of the same sequence, which keeps the JAX mesh's
compiles out of these tests; chip_smoke.py's phase-5k DML statements at
tiny likewise, local and mesh.  The mesh scan of a memory table: each
worker's rows equal the rows of the memory splits the JAX mesh assigns it
(split i to worker i mod 4, the rule of both packages' `_x_TableScanNode`)
read from the JAX package's store, for a table of four splits, one of a
single split, a created never-written table and a table emptied by a bare
DELETE.

Tolerances: integers, decimals, dates and strings exact; doubles relative
1e-9.
"""

import numpy as np
import pytest

from trino_tpu_torch.parallel.spmd import shard
from trino_tpu_torch.testing import ResultOrder, assert_rows_match

import chip_smoke
from test_torch_ddl import StatementPair
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

# -- tests/test_dml.py ------------------------------------------------------------

DML_SETUP = [
    "create table t (a bigint, b varchar, c double)",
    "insert into t values (1,'x',1.5),(2,'y',2.5),(3,'z',3.5),(4,'x',4.5)",
]

DML_CASES = {
    "delete_where": ["delete from t where b = 'x'", "select a from t order by a"],
    "delete_null_predicate_keeps_row": [
        "insert into t (a) values (9)",
        "delete from t where b = 'nope'",
        "select count(*) from t",
    ],
    "delete_all": ["delete from t", "select count(*) from t"],
    "update_multi_assign": [
        "update t set c = c * 10, b = 'w' where a >= 3",
        "select b, c from t where a = 3",
        "select b, c from t where a = 1",
    ],
    "update_expression_references_row": [
        "update t set a = a + 100 where b = 'x'",
        "select a from t order by a",
    ],
    "dml_rollback": [
        "start transaction",
        "delete from t",
        "select count(*) from t",
        "rollback",
        "select count(*) from t",
    ],
    "dml_commit": [
        "start transaction",
        "update t set c = 0.0 where a = 1",
        "commit",
        "select c from t where a = 1",
    ],
    "update_unknown_column_rejected": ["update t set nope = 1"],
}


@pytest.mark.parametrize("name", list(DML_CASES))
def test_dml_cases_match_jax(name):
    p = StatementPair(catalog="mem", schema="s", target_splits=4, catalogs="mem")
    p.run_all(DML_SETUP + DML_CASES[name])


# -- tests/test_merge.py -------------------------------------------------------------

MERGE_SETUP = [
    "create table tgt (k bigint, v varchar)",
    "insert into tgt values (1,'a'), (2,'b'), (3,'c')",
    "create table src (k bigint, v varchar)",
    "insert into src values (2,'B'), (3,'DEL'), (4,'d')",
]

MERGE_CASES = {
    "update_delete_insert": [
        "merge into tgt t using src s on t.k = s.k "
        "when matched and s.v = 'DEL' then delete "
        "when matched then update set v = s.v "
        "when not matched then insert (k, v) values (s.k, s.v)",
        "select * from tgt",
    ],
    "first_match_wins": [
        "merge into tgt t using src s on t.k = s.k "
        "when matched and s.k = 2 then update set v = 'first' "
        "when matched then delete",
        "select * from tgt",
    ],
    "matched_only": [
        "merge into tgt t using src s on t.k = s.k when matched then update set v = 'm'",
        "select * from tgt",
    ],
    "not_matched_only": [
        "merge into tgt t using src s on t.k = s.k "
        "when not matched then insert values (s.k, s.v)",
        "select * from tgt",
    ],
    "subquery_source_and_condition": [
        "merge into tgt t using (select k, v from src where k <> 3) s on t.k = s.k "
        "when matched then update set v = s.v "
        "when not matched and s.k > 3 then insert values (s.k, 'new')",
        "select * from tgt",
    ],
    "insert_condition_filters": [
        "merge into tgt t using src s on t.k = s.k "
        "when not matched and s.v = 'nope' then insert values (s.k, s.v)",
        "select count(*) from tgt",
    ],
    # a target row matched by two source rows: the cardinality error, and
    # the target untouched
    "multiple_source_matches_raises": [
        "insert into src values (2,'B2')",
        "merge into tgt t using src s on t.k = s.k when matched then update set v = s.v",
        "select * from tgt",
    ],
    "duplicate_target_rows_ok": [
        "insert into tgt values (2,'b')",
        "merge into tgt t using src s on t.k = s.k "
        "when matched and s.k = 2 then update set v = s.v",
        "select * from tgt",
    ],
}


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_cases_match_jax(name):
    p = StatementPair(catalog="memory", schema="default", target_splits=2)
    p.run_all(MERGE_SETUP + MERGE_CASES[name])


# -- transactions ----------------------------------------------------------------------

TRANSACTION_CASES = {
    # the rollback restores the pre-image of every written table, the
    # dictionaries extended inside the transaction included, and drops a
    # table created inside it
    "rollback_restores_dictionaries": [
        "create table w (k bigint, s varchar)",
        "insert into w values (1, 'b'), (2, 'd')",
        "start transaction",
        "insert into w values (3, 'a'), (4, 'e')",
        "update w set s = 'zz' where k = 1",
        "create table w2 as select * from w",
        "rollback",
        "show tables",
        "select * from w",
        "insert into w values (5, 'c')",
        "select s, count(*) from w group by s",
    ],
    "commit_keeps_writes": [
        "create table w (k bigint, s varchar)",
        "start transaction",
        "insert into w values (1, 'q')",
        "alter table w add column d double",
        "insert into w values (2, 'r', 2.5)",
        "commit",
        "select * from w",
        "rollback",
    ],
    "nested_begin_rejected": ["start transaction", "start transaction", "commit", "commit"],
}


@pytest.mark.parametrize("name", list(TRANSACTION_CASES))
def test_transactions_match_jax(name):
    StatementPair().run_all(TRANSACTION_CASES[name])


# -- the 4-worker mesh ------------------------------------------------------------------

MESH_CASES = {
    "ctas": [
        "create table o as select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
        "o_orderdate, o_comment from tpch.tiny.orders",
        "select o_orderstatus, count(*), sum(o_totalprice) from o group by 1 order by 1",
    ],
    "insert_select": [
        "create table o (k bigint, s varchar, d date)",
        "insert into o select o_orderkey, o_orderpriority, o_orderdate from tpch.tiny.orders "
        "where o_orderkey % 5 = 0",
        "insert into o select l_orderkey, l_shipmode, l_shipdate from tpch.tiny.lineitem "
        "where l_linenumber = 7",
        "select s, count(*), min(d), max(k) from o group by s order by s",
    ],
    "delete": [
        "create table o as select o_orderkey, o_orderstatus, o_totalprice from tpch.tiny.orders",
        "delete from o where o_orderstatus = 'P' or o_totalprice < 5000",
        "select count(*), sum(o_totalprice) from o",
        "delete from o",
        "select count(*), sum(o_totalprice) from o",
        "insert into o values (1, 'F', 1.50)",
        "select * from o",
    ],
    "update": [
        "create table o as select o_orderkey, o_orderpriority, o_totalprice from tpch.tiny.orders",
        "update o set o_totalprice = o_totalprice * 2, o_orderpriority = 'X' "
        "where o_orderkey % 7 = 3",
        "select o_orderpriority, count(*), sum(o_totalprice) from o group by 1 order by 1",
    ],
    "merge": [
        "create table o as select o_orderkey, o_custkey, o_totalprice from tpch.tiny.orders",
        "merge into o t using (select l_orderkey k, sum(l_quantity) q from tpch.tiny.lineitem "
        "group by l_orderkey having sum(l_quantity) > 200) s on t.o_orderkey = s.k "
        "when matched and s.q > 250 then delete "
        "when matched then update set o_totalprice = o_totalprice + 1 "
        "when not matched then insert values (s.k, 0, s.q)",
        "select count(*), sum(o_totalprice), sum(o_custkey) from o",
    ],
    # a created, never-written table and a table emptied by a bare DELETE
    "empty_tables": [
        "create table e (k bigint, s varchar, d decimal(38,2))",
        "select count(*), max(k), max(s), sum(d) from e",
        "select e.k, n_name from e join tpch.tiny.nation on e.k = n_nationkey",
        "insert into e values (1, 'a', 2.50)",
        "delete from e",
        "select count(*), max(k), max(s) from e",
        "update e set k = 2",
        "select * from e",
    ],
}


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_dml_matches_jax_local(name):
    StatementPair(where="mesh", target_splits=4).run_all(MESH_CASES[name])


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_chip_smoke_dml_statements_at_tiny(where):
    """chip_smoke.py's phase-5k write statements (D2, D3 and the blackhole
    CTAS) at tpch.tiny, held to the JAX local run statement by
    statement, stored tables included."""
    p = StatementPair(where=where, target_splits=4)
    for step in chip_smoke.statement_steps("tiny"):
        if step.group in ("D2", "D3") or step.label.startswith("D6_blackhole"):
            for sql in step.statements:
                p.run(sql)


# -- the mesh scan of a memory table ----------------------------------------------------


def _worker_rows(port_runner, sql: str) -> list:
    """Each worker's live rows of the mesh scan under `sql`'s plan."""
    from trino_tpu_torch.parallel.runner import StageExecutor
    from trino_tpu_torch.planner import plan as P

    sub = port_runner.create_subplan(port_runner.create_plan(sql))
    ex = StageExecutor(port_runner.catalogs, port_runner.wm, port_runner.properties)
    scans = []

    def walk(node):
        if isinstance(node, P.TableScanNode):
            scans.append(node)
        for c in node.children:
            walk(c)

    for frag in sub.all_fragments():
        walk(frag.root)
    assert len(scans) == 1
    stacked = ex._x_TableScanNode(scans[0]).stacked
    return [[tuple(r) for r in shard(stacked, w).to_pylist()] for w in range(port_runner.wm.n)]


def _jax_worker_rows(jax_runner, table: str, n_workers: int = 4) -> list:
    """The rows the JAX mesh places on each worker: memory split i goes to
    worker i mod n, read back from the JAX package's store."""
    from trino_tpu.connectors.api import TableHandle

    conn = jax_runner.catalogs.get("memory")
    handle = TableHandle("memory", "default", table)
    names = [c.name for c in conn.metadata().table_metadata("default", table).columns]
    out = [[] for _ in range(n_workers)]
    for i, split in enumerate(conn.splits(handle, target_splits=n_workers)):
        for page in conn.page_source(split, names).pages():
            vals = []
            for cd in page:
                col = []
                for r, v in enumerate(np.asarray(cd.values).tolist()):
                    if cd.valid is not None and not cd.valid[r]:
                        col.append(None)
                    elif cd.dictionary is not None:
                        col.append(cd.dictionary.values[v])
                    else:
                        col.append(v)
                vals.append(col)
            out[i % n_workers].extend(zip(*vals))
    return out


@pytest.mark.parametrize("rows", [20_000, 300, 0, "deleted"])
def test_mesh_scan_of_memory_table_matches_jax_placement(rows):
    p = StatementPair(where="mesh", target_splits=4)
    if rows == 0:
        p.run("create table m (k bigint, s varchar)")
    else:
        n = 20_000 if rows == "deleted" else rows
        # ORDER BY: both stores then hold the rows in one order, so the
        # splits cut the same row ranges
        p.run(f"create table m as select l_orderkey * 10 + l_linenumber k, l_shipmode s "
              f"from tpch.tiny.lineitem where l_orderkey * 10 + l_linenumber < {n * 3} "
              f"order by k")
    if rows == "deleted":
        p.run("delete from m")
    sql = "select k, s from m"
    # integer keys stay as the store holds them; strings decode on both sides
    got = _worker_rows(p.port, sql)
    want = _jax_worker_rows(p.jax, "m")
    for w in range(4):
        assert_rows_match(got[w], [tuple(r) for r in want[w]], ResultOrder((), None))
    assert sum(map(len, got)) == p.jax.execute("select count(*) from m").rows[0][0]
    if rows == 20_000:
        assert all(len(g) > 0 for g in got)  # four splits, one per worker

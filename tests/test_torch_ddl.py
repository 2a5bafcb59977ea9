"""The statement layer of the port (trino_tpu_torch/runtime/runner.py) over
the memory and blackhole connectors, against the JAX package.

Every case is a sequence of statements that runs through the JAX
package's LocalQueryRunner and the port's LocalQueryRunner(device="cpu"),
each over its own fresh catalogs (`StatementPair`).  After each statement:
  * the result: column names, type names and rows (a query's rows under
    its own ORDER BY, otherwise as a multiset; every other statement's rows
    in order); a statement the JAX package rejects must raise an
    exception of the same class name, with the same message, in the port;
  * every memory table of the two stores: column names and types, the
    stored numpy dtypes, and the rows as a multiset, where a dictionary
    column's row is its (code, value) pair and the dictionary's value list
    must be equal, so the codes and the dictionaries are held, not only the
    decoded values.

The cases: every case of tests/test_ddl.py; the memory cases of
tests/test_connector_conformance.py (the writable batteries over
`memory`, and the read-only batteries over tpch.tiny and tpcds.tiny, which
it runs from a memory-catalog runner); the blackhole connector (CTAS and
INSERT count their rows, reads return none); SHOW and DESCRIBE (catalogs,
schemas, tables, columns, functions with and without a LIKE pattern,
CREATE TABLE, STATS of a memory table and of a generated one, SESSION);
EXPLAIN, EXPLAIN (TYPE DISTRIBUTED) and EXPLAIN ANALYZE, including
chip_smoke.py's phase-5k statements at tiny; and the security statements
(GRANT, REVOKE, CREATE/DROP ROLE, SHOW ROLES/GRANTS), which give the JAX
package's rows (their cases keep the names and the test name they had
while security was unported and they raised NotImplementedError).

EXPLAIN and EXPLAIN (TYPE DISTRIBUTED) text and SHOW output are compared
exactly; EXPLAIN ANALYZE on each operator's name, depth, rows= and
batches= (its times are the host's clock); the mesh's EXPLAIN ANALYZE on
its profile's fragment ids and kinds.  SHOW CATALOGS is the JAX list,
`system` included.

Tolerances: integers, decimals, dates, timestamps and strings exact;
doubles relative 1e-9.
"""

import numpy as np
import pytest

from trino_tpu.connectors.api import CatalogManager as JCatalogs, default_catalogs as j_default
from trino_tpu.connectors.memory import MemoryConnector as JMemory
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.connectors.api import CatalogManager as TCatalogs, default_catalogs as t_default
from trino_tpu_torch.connectors.memory import MemoryConnector as TMemory
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import ResultOrder, assert_rows_match, result_order

import chip_smoke
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-9


def _catalogs(kind: str):
    """(JAX catalogs, port catalogs): the default set, or one memory
    catalog named `mem` (tests/test_dml.py's fixture)."""
    if kind == "default":
        return j_default(), t_default()
    jc, tc = JCatalogs(), TCatalogs()
    jc.register("mem", JMemory())
    tc.register("mem", TMemory())
    return jc, tc


class StatementPair:
    """One JAX LocalQueryRunner and one port runner (local, or the 4-worker
    mesh), over fresh catalogs of the same kind; `run` executes a statement
    in both and holds the port to the JAX package."""

    def __init__(self, catalog="memory", schema="default", target_splits=2,
                 where="local", catalogs="default"):
        jc, tc = _catalogs(catalogs)
        self.jax = JaxRunner(jc, catalog=catalog, schema=schema, target_splits=target_splits)
        if where == "mesh":
            self.port = DistributedQueryRunner(tc, catalog=catalog, schema=schema,
                                               n_workers=4, device="cpu")
        else:
            self.port = LocalQueryRunner(tc, catalog=catalog, schema=schema,
                                         target_splits=target_splits, device="cpu")
        #: (catalog, table key) -> the (port, JAX) column lists last held
        #: equal: a store replaces a table's column list on every write, so
        #: the same two lists need no second check
        self._held: dict = {}

    def run(self, sql: str):
        """Execute `sql` in both; returns the JAX rows (None when it
        raised, after checking the port raised alike)."""
        try:
            expected = self.jax.execute(sql)
        except Exception as e:  # noqa: BLE001 - the port must raise alike
            # the same class by name: each package has its own error classes
            with pytest.raises(Exception) as got:
                self.port.execute(sql)
            assert type(got.value).__name__ == type(e).__name__, (sql, got.value, e)
            assert str(got.value) == str(e), (sql, got.value, e)
            self.check_tables()
            return None
        actual = self.port.execute(sql)
        assert actual.column_names == expected.column_names, sql
        assert [t.name for t in actual.types] == [t.name for t in expected.types], sql
        if sql.lstrip().lower().startswith(("select", "with", "(")):
            order = result_order(self.port.create_plan(sql))
            assert_rows_match(actual.rows, expected.rows, order, float_rtol=RTOL)
        else:
            assert len(actual.rows) == len(expected.rows), sql
            assert_rows_match(actual.rows, expected.rows, ResultOrder(tuple(range(
                len(expected.rows[0]) if expected.rows else 0)), None), float_rtol=RTOL)
        self.check_tables()
        return expected.rows

    def run_all(self, statements) -> None:
        for sql in statements:
            self.run(sql)

    def check_tables(self) -> None:
        """Every memory table of the two stores is the same (see the module
        docstring)."""
        for name in self.jax.catalogs.names():
            jconn = self.jax.catalogs.get(name)
            if not isinstance(jconn, JMemory):
                continue
            tconn = self.port.catalogs.get(name)
            assert sorted(tconn.store) == sorted(jconn.store), name
            for key, jst in jconn.store.items():
                tst = tconn.store[key]
                held = self._held.get((name, key))
                if held and held[0] is tst.columns and held[1] is jst.columns \
                        and held[2] == tst.meta and held[3] == jst.meta:
                    continue
                assert_same_stored(tst, jst, f"{name}.{key}")
                self._held[name, key] = (tst.columns, jst.columns, tst.meta, jst.meta)


def stored_rows(st) -> list:
    """A stored table's rows: NULL as None, a long decimal's limb pair as
    a tuple, a dictionary column as (code, value)."""
    if not st.columns:
        return []
    cols = []
    for cd in st.columns:
        vals = np.asarray(cd.values)
        valid = np.ones(len(vals), bool) if cd.valid is None else np.asarray(cd.valid, bool)
        out = []
        for v, ok in zip(vals.tolist(), valid.tolist()):
            if not ok:
                out.append(None)
            elif cd.dictionary is not None:
                out.append((v, cd.dictionary.values[v]))
            elif isinstance(v, list):
                out.append(tuple(v))
            else:
                out.append(v)
        cols.append(out)
    return [tuple(r) for r in zip(*cols)]


def assert_same_stored(t, j, where: str) -> None:
    assert [c.name for c in t.meta.columns] == [c.name for c in j.meta.columns], where
    assert [c.type.name for c in t.meta.columns] == [c.type.name for c in j.meta.columns], where
    assert len(t.columns) == len(j.columns), where
    for tc, jc in zip(t.columns, j.columns):
        assert np.asarray(tc.values).dtype == np.asarray(jc.values).dtype, where
        assert (tc.dictionary is None) == (jc.dictionary is None), where
        if jc.dictionary is not None:
            assert tuple(tc.dictionary.values) == tuple(jc.dictionary.values), where
    assert t.rows == j.rows, where
    assert_rows_match(stored_rows(t), stored_rows(j), ResultOrder((), None), float_rtol=RTOL)


@pytest.fixture()
def pair():
    return StatementPair()


# -- tests/test_ddl.py -----------------------------------------------------------

DDL_CASES = {
    "create_insert_select": [
        "create table t (a bigint, b varchar)",
        "insert into t values (1, 'x'), (2, 'y'), (null, 'z')",
        "select a, b from t order by b",
        "insert into t values (4, 'w')",
        "select count(*), sum(a) from t",
    ],
    "ctas_from_tpch": [
        "create table nations as select n_name, n_regionkey from tpch.tiny.nation",
        "select count(*) from nations",
        "select n_regionkey, count(*) from nations group by n_regionkey order by 1",
    ],
    "insert_column_list": [
        "create table t2 (a bigint, b varchar, c double)",
        "insert into t2 (b, a) select 'v', 9",
        "select a, b, c from t2",
    ],
    "drop_table": [
        "create table gone (x bigint)",
        "show tables",
        "drop table gone",
        "show tables",
        "drop table if exists gone",
    ],
    "show_statements": [
        "show tables from tpch.tiny",
        "describe tpch.tiny.region",
    ],
    "use_and_set_session": [
        "use tpch.tiny",
        "select count(*) from region",
        "set session target_splits = 2",
        "show session",
        "set session no_such_knob = 1",
    ],
    "explain": ["explain select count(*) from tpch.tiny.region"],
    "show_create_table": [
        "create table memory.default.sct (a bigint, s varchar)",
        "show create table memory.default.sct",
    ],
    "alter_table": [
        "create table memory.default.alt (a bigint, b varchar)",
        "insert into memory.default.alt values (1, 'x'), (2, 'y')",
        "alter table memory.default.alt add column c double",
        "select * from memory.default.alt",
        "alter table memory.default.alt rename column b to bb",
        "show columns from memory.default.alt",
        "alter table memory.default.alt drop column a",
        "select * from memory.default.alt",
        "alter table memory.default.alt rename to memory.default.alt2",
        "show tables from memory.default",
    ],
}


@pytest.mark.parametrize("name", list(DDL_CASES))
def test_ddl_cases_match_jax(pair, name):
    pair.run_all(DDL_CASES[name])


def test_explain_analyze_case(pair):
    """tests/test_ddl.py's EXPLAIN ANALYZE case (held as test_explain_*
    below hold every EXPLAIN ANALYZE)."""
    assert_same_analyze(pair, "select count(*) from tpch.tiny.nation")


# -- tests/test_connector_conformance.py: the memory cases --------------------

T = "memory.default.conf_t"

WRITABLE_CASES = {
    "create_insert_select": [
        f"create table {T} (k bigint, s varchar, d double)",
        f"insert into {T} values (1, 'a', 1.5), (2, 'b', 2.5), (3, null, null)",
        f"select * from {T}",
    ],
    "predicate_and_agg": [
        f"create table {T} (k bigint, v double)",
        f"insert into {T} values (1, 10.0), (1, 20.0), (2, 5.0)",
        f"select k, sum(v) from {T} where v > 6 group by k order by k",
    ],
    "join_with_fixture": [
        f"create table {T} (rk bigint)",
        f"insert into {T} values (0), (2)",
        f"select r.r_name from {T} t join tpch.tiny.region r on t.rk = r.r_regionkey order by 1",
    ],
    "delete_update": [
        f"create table {T} (k bigint, v bigint)",
        f"insert into {T} values (1, 10), (2, 20), (3, 30)",
        f"delete from {T} where k = 2",
        f"update {T} set v = v + 1 where k = 3",
        f"select * from {T}",
    ],
    "types_roundtrip": [
        f"create table {T} (b boolean, i integer, x bigint, r double, "
        "dec decimal(10,2), dt date, s varchar)",
        f"insert into {T} values (true, 7, 9000000000, 1.25, 3.50, date '2020-02-29', 'z')",
        f"select * from {T}",
    ],
    "show_columns_and_drop": [
        f"create table {T} (k bigint, s varchar)",
        f"show columns from {T}",
        f"drop table {T}",
        "show tables from memory.default",
    ],
    "insert_column_subset": [
        f"create table {T} (a bigint, b varchar)",
        f"insert into {T} (b) values ('only-b')",
        f"select * from {T}",
    ],
    # TestWritableConnectorExtended
    "insert_all_nulls_row": [
        f"create table {T} (k bigint, s varchar)",
        f"insert into {T} values (null, null)",
        f"select * from {T}",
        f"select count(*), count(k) from {T}",
    ],
    "empty_table_aggregates": [
        f"create table {T} (k bigint)",
        f"select count(*), sum(k), min(k) from {T}",
    ],
    "ctas_roundtrip": [
        f"create table {T} as select n_nationkey k, n_name s from tpch.tiny.nation "
        "where n_nationkey < 3",
        f"select count(*) from {T}",
    ],
    "add_column_schema_evolution": [
        f"create table {T} (k bigint)",
        f"insert into {T} values (1)",
        f"alter table {T} add column s varchar",
        f"insert into {T} values (2, 'x')",
        f"select * from {T}",
    ],
    "rename_column": [
        f"create table {T} (old bigint)",
        f"insert into {T} values (5)",
        f"alter table {T} rename column old to renamed",
        f"select renamed from {T}",
    ],
    "drop_column": [
        f"create table {T} (a bigint, b bigint)",
        f"insert into {T} values (1, 2)",
        f"alter table {T} drop column b",
        f"select * from {T}",
    ],
    "insert_select_from_self": [
        f"create table {T} (k bigint)",
        f"insert into {T} values (1), (2)",
        f"insert into {T} select k + 10 from {T}",
        f"select k from {T}",
    ],
    "delete_all_then_reinsert": [
        f"create table {T} (k bigint)",
        f"insert into {T} values (1), (2)",
        f"delete from {T}",
        f"select count(*) from {T}",
        f"insert into {T} values (9)",
        f"select * from {T}",
    ],
    "long_decimal_roundtrip": [
        f"create table {T} (v decimal(38,2))",
        f"insert into {T} values (decimal '99999999999999999999.25'), (null)",
        f"select * from {T}",
    ],
    "timestamp_roundtrip": [
        f"create table {T} (ts timestamp)",
        f"insert into {T} values (timestamp '2021-07-15 13:14:15.250')",
        f"select * from {T}",
    ],
    "duplicate_create_rejected": [
        f"create table {T} (k bigint)",
        f"create table {T} (k bigint)",
        f"create table if not exists {T} (k bigint)",
    ],
    "merge_upsert": [
        f"create table {T} (k bigint, v bigint)",
        f"insert into {T} values (1, 10), (2, 20)",
        f"merge into {T} t using (values (2, 200), (3, 300)) s(k, v) on t.k = s.k "
        "when matched then update set v = s.v "
        "when not matched then insert values (s.k, s.v)",
        f"select * from {T}",
    ],
    "view_over_connector_table": [
        f"create table {T} (k bigint)",
        f"insert into {T} values (1), (2)",
        f"create view memory.default.conf_v as select k * 2 d from {T}",
        "select d from memory.default.conf_v",
        "drop view memory.default.conf_v",
    ],
    "unicode_strings": [
        f"create table {T} (s varchar)",
        f"insert into {T} values ('héllo'), ('日本語'), ('')",
        f"select s from {T}",
        f"select length(s) from {T} where s = '日本語'",
    ],
}


@pytest.mark.parametrize("name", list(WRITABLE_CASES))
def test_writable_memory_cases_match_jax(pair, name):
    pair.run_all(WRITABLE_CASES[name])


READ_ONLY = [("tpch", "tiny", "nation", "n_nationkey"), ("tpcds", "tiny", "reason", "r_reason_sk")]

READ_ONLY_CASES = {
    "count": ["select count(*) from {t}"],
    "predicate_scan": ["select count(*) from {t}", "show columns from {t}",
                       "select count(*) from {t} where {pk} >= 1"],
    "stats_present": ["show stats for {t}"],
    "writes_rejected": ["insert into {t} values (1)"],
    "limit_pushdown_shape": ["select count(*) from (select * from {t} limit 3)"],
    "order_by_first_column": ["select {pk} from {t} order by {pk}"],
    "describe_matches_select_star": ["show columns from {t}", "select * from {t} order by 1 limit 1"],
    "ddl_rejected": ["drop table {t}", "delete from {t}"],
}


@pytest.mark.parametrize("name", list(READ_ONLY_CASES))
@pytest.mark.parametrize("catalog,schema,table,pk", READ_ONLY)
def test_read_only_cases_match_jax(pair, name, catalog, schema, table, pk):
    t = f"{catalog}.{schema}.{table}"
    for sql in READ_ONLY_CASES[name]:
        sql = sql.format(t=t, pk=pk)
        if name in ("writes_rejected", "ddl_rejected"):
            # both refuse: the generated connectors take no writes
            with pytest.raises(Exception):
                pair.jax.execute(sql)
            with pytest.raises(Exception):
                pair.port.execute(sql)
        else:
            pair.run(sql)


# -- the blackhole connector ------------------------------------------------------


def test_blackhole_sink_and_source(pair):
    pair.run_all([
        "create table blackhole.default.sink as select * from tpch.tiny.orders",
        "select count(*) from blackhole.default.sink",
        "select * from blackhole.default.sink",
        "insert into blackhole.default.sink select * from tpch.tiny.orders where o_orderkey < 100",
        "create table blackhole.default.empty (k bigint, s varchar, d decimal(38,2))",
        "select k, s, d from blackhole.default.empty",
        "select count(*), sum(k), max(s) from blackhole.default.empty",
        "show tables from blackhole.default",
        "show stats for blackhole.default.sink",
        "drop table blackhole.default.sink",
        "show tables from blackhole.default",
    ])


# -- SHOW / DESCRIBE ---------------------------------------------------------------


SHOW_CASES = {
    "schemas": ["show schemas from tpch", "show schemas from memory"],
    "tables": ["create table m1 (a bigint)", "show tables", "show tables from memory.default",
               "show tables from tpcds.tiny"],
    "columns": ["show columns from tpch.tiny.lineitem", "describe tpcds.tiny.store_sales"],
    "functions": ["show functions", "show functions like 'array%'", "show functions like 'date_%'"],
    "create_table": [
        "create table ct as select o_orderkey, o_orderdate, o_totalprice, o_comment "
        "from tpch.tiny.orders where o_orderkey < 200",
        "show create table ct",
        "show create table tpch.tiny.nation",
    ],
    # a memory table's statistics are exact, computed from the stored data
    "stats": [
        "create table st as select o_orderkey, o_orderstatus, o_totalprice, o_orderdate, "
        "cast(o_totalprice as double) d from tpch.tiny.orders",
        "insert into st (o_orderkey) values (null), (-5)",
        "show stats for st",
        "show stats for tpch.tiny.orders",
        "show stats for tpcds.tiny.item",
    ],
    "session": ["show session", "set session pallas_agg = true", "show session"],
}


@pytest.mark.parametrize("name", list(SHOW_CASES))
def test_show_matches_jax(pair, name):
    pair.run_all(SHOW_CASES[name])


def test_show_catalogs(pair):
    """The JAX list, `system` included (the system connector's query
    history and runtime tables)."""
    expected = pair.jax.execute("show catalogs").rows
    assert pair.port.execute("show catalogs").rows == expected
    assert ("memory",) in expected and ("blackhole",) in expected
    assert ("system",) in expected


# -- EXPLAIN -------------------------------------------------------------------------

EXPLAIN_SETUP = [
    "create table li as select l_returnflag, l_linestatus, "
    "cast(l_quantity as double) l_quantity, cast(l_extendedprice as double) l_extendedprice, "
    "cast(l_discount as double) l_discount, cast(l_tax as double) l_tax, l_shipdate "
    "from tpch.tiny.lineitem",
    "create table ord as select o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
    "o_orderdate from tpch.tiny.orders",
]

EXPLAIN_QUERIES = {
    "count_region": "select count(*) from tpch.tiny.region",
    "q1_memory": chip_smoke.STATEMENT_Q1.format(table="li"),
    "join_memory_tpch": "select o_orderstatus, count(*), sum(l_quantity) from ord "
                        "join tpch.tiny.lineitem on l_orderkey = o_orderkey "
                        "where o_orderdate < date '1995-01-01' group by 1 order by 1",
    "recursive": "with recursive t(n) as (select 1 union all select n + 1 from t where n < 3) "
                 "select * from t",
    "view_and_filter": "select o_orderstatus, max(o_totalprice) from ord "
                       "where o_custkey % 3 = 0 group by 1",
}

def assert_same_analyze(pair, sql: str) -> None:
    """Operator names, depths, rows= and batches= (chip_smoke.analyze_lines)."""
    expected = chip_smoke.analyze_lines(pair.jax.execute("explain analyze " + sql).rows)
    actual = pair.port.execute("explain analyze " + sql).rows
    assert expected and chip_smoke.analyze_lines(actual) == expected
    assert actual[0] == ("Query execution statistics (wall = inclusive of subtree; "
                         "device = blocked-on-device per op):",)


@pytest.fixture(scope="module")
def explain_pair():
    p = StatementPair(target_splits=4)
    p.run_all(EXPLAIN_SETUP)
    return p


@pytest.mark.parametrize("name", list(EXPLAIN_QUERIES))
@pytest.mark.parametrize("kind", ["explain", "explain (type distributed)"])
def test_explain_text_matches_jax(explain_pair, name, kind):
    explain_pair.run(f"{kind} {EXPLAIN_QUERIES[name]}")


@pytest.mark.parametrize("name", list(EXPLAIN_QUERIES))
def test_explain_analyze_matches_jax(explain_pair, name):
    assert_same_analyze(explain_pair, EXPLAIN_QUERIES[name])


def test_explain_analyze_counts_waves():
    """Under a budget, the wave counters render (PressureObserver's sink)."""
    p = StatementPair(catalog="tpch", schema="tiny")
    sql = ("select l_orderkey, count(*), sum(l_quantity) from lineitem "
           "group by l_orderkey order by 1 limit 5")
    for r in (p.jax, p.port):
        r.execute("set session query_max_memory = 60000")
    assert_same_analyze(p, sql)
    text = [r[0] for r in p.port.execute("explain analyze " + sql).rows]
    jtext = [r[0] for r in p.jax.execute("explain analyze " + sql).rows]
    pressure = [line for line in text if line.startswith("memory pressure:")]
    assert pressure == [line for line in jtext if line.startswith("memory pressure:")]
    assert pressure and "memory_wave=" in pressure[0]


# -- the security statements ---------------------------------------------------------

#: piece -> (statements run first, the statement held to the JAX package).
#: The pieces are the cases that held these statements while security was
#: unported (bucketed CREATE TABLE and CTAS run in tests/test_torch_layouts.py,
#: system.runtime.compilations in tests/test_torch_observatory.py); each
#: keeps its name
UNPORTED = {
    "grant": ((), "grant select on tpch.tiny.nation to alice"),
    "revoke": (("grant select on tpch.tiny.nation to alice",),
               "revoke select on tpch.tiny.nation from alice"),
    "create_role": ((), "create role analysts"),
    "drop_role": (("create role analysts",), "drop role analysts"),
    "show_roles": (("create role analysts", "create role readers"), "show roles"),
    "show_grants": (("grant select on tpch.tiny.nation to alice",), "show grants"),
    "bucketed_create": (("grant select on tpch.tiny.nation to alice",
                         "grant delete on tpch.tiny.region to alice"),
                        "show grants on tpch.tiny.nation"),
    "bucketed_ctas": ((), "grant insert on tpch.tiny.region to bob"),
    "explain_analyze_verbose": (("grant select, insert on tpch.tiny.region to bob",),
                                "show grants on tpch.tiny.region"),
}


@pytest.mark.parametrize("piece", list(UNPORTED))
def test_unported_statements_raise(pair, piece):
    """Each statement gives the JAX package's rows after the same set-up
    (the name is the one the cases had when these statements raised
    NotImplementedError in the port); a SHOW lists what the set-up made,
    and no table is created."""
    setup, sql = UNPORTED[piece]
    pair.run_all(setup)
    rows = pair.run(sql)
    assert rows is not None
    if sql.startswith("show"):
        assert rows
    assert pair.port.execute("show tables").rows == []


def test_mesh_explain_matches_and_analyze_raises():
    """On the 4-worker mesh: EXPLAIN and EXPLAIN (TYPE DISTRIBUTED) give
    the JAX local runner's text; EXPLAIN ANALYZE now runs, and its
    profile's fragment ids and kinds are the JAX mesh's fragments of the
    same statement."""
    from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner

    p = StatementPair(where="mesh", target_splits=4)
    p.run_all(EXPLAIN_SETUP[:1])
    sql = EXPLAIN_QUERIES["q1_memory"]
    p.run("explain " + sql)
    p.run("explain (type distributed) " + sql)
    text = [r[0] for r in p.port.execute("explain analyze " + sql).rows]
    assert text[1].startswith("Mesh execution profile")
    jm = JaxMeshRunner(p.jax.catalogs, catalog="memory", schema="default", n_workers=4)
    jsub = jm.create_subplan(jm.create_plan(sql))
    expected = {f.id: str(f.partitioning) for f in jsub.all_fragments()}
    prof = p.port.last_mesh_profile
    assert {fid: st.kind for fid, st in prof.fragments.items()} == expected
    for fid, kind in expected.items():
        assert any(
            line.strip().startswith(f"Fragment {fid} [{kind}] wall=") for line in text
        ), (fid, kind)


def test_memory_runners_without_device_need_cuda():
    """The memory catalog's runners run on the card unless the caller asks
    for the CPU; without a card they raise (no fallback)."""
    import torch

    if torch.cuda.is_available():
        assert LocalQueryRunner(catalog="memory", schema="default").device.type == "cuda"
        assert DistributedQueryRunner(catalog="memory", schema="default").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalQueryRunner(catalog="memory", schema="default")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistributedQueryRunner(catalog="memory", schema="default", n_workers=4)
    r = LocalQueryRunner(catalog="memory", schema="default", device="cpu")
    assert r.execute("create table t as select 1 x").rows == [(1,)]

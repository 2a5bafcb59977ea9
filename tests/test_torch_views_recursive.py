"""Views, prepared statements and WITH RECURSIVE in the port against the
JAX package, locally and on the 4-worker mesh.

Each case runs statement by statement through the JAX package's
LocalQueryRunner and the port's runner (`test_torch_ddl.StatementPair`):
results (and any memory table) must be equal, and a statement the JAX
package rejects must raise the same error class and message in the port.

Local: every case of tests/test_views_prepared.py (CREATE [OR REPLACE]
VIEW, views over views, DROP VIEW [IF EXISTS], a definition validated
before it is kept, PREPARE/EXECUTE/DEALLOCATE with NULL and negative
parameters, DESCRIBE INPUT/OUTPUT) and of tests/test_recursive_cte.py
(counting, factorial, the UNION fixpoint, a walk over a table, the depth
guard's error after 100 iterations, an empty anchor, the anchor's dedupe,
the step's type widening to decimal, a nested WITH inside the definition,
EXPLAIN of a recursive query), plus the VALUES round trip of every value
kind a recursive step carries (dates, timestamps with microseconds,
decimals short and long, doubles, strings, booleans and NULLs).

Mesh: a view, a prepared statement and a recursive CTE joined with a
table on the port's mesh, each held to ONE JAX local run; chip_smoke.py's
phase-5k D4 and D5 statements at tiny, local and mesh.

Tolerances: integers, decimals, dates, timestamps and strings exact;
doubles relative 1e-9.
"""

import pytest

import chip_smoke
from test_torch_ddl import StatementPair
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

# -- tests/test_views_prepared.py -------------------------------------------------

VIEW_CASES = {
    "create_and_query_view": [
        "create view top_n as select n_name, n_regionkey from nation where n_nationkey < 10",
        "select count(*) from top_n",
        "select r_name, count(*) c from top_n join region on n_regionkey = r_regionkey "
        "group by r_name order by c desc, r_name limit 1",
    ],
    "view_or_replace_and_drop": [
        "create view v1 as select 1 as x",
        "create view v1 as select 2 as x",
        "create or replace view v1 as select 2 as x",
        "select x from v1",
        "drop view v1",
        "select * from v1",
        "drop view if exists v1",
    ],
    "view_over_view": [
        "create view a_v as select n_nationkey k from nation",
        "create view b_v as select k from a_v where k < 5",
        "select count(*) from b_v",
    ],
    "create_view_validates_definition": [
        "create view bad as select no_such_col from nation",
        "select * from bad",
    ],
    "prepare_execute_deallocate": [
        "prepare q1 from select n_name from nation where n_nationkey = ? or n_name = ?",
        "execute q1 using 3, 'CANADA'",
        "execute q1 using 0, 'PERU'",
        "deallocate q1",
        "execute q1 using 1, 'x'",
    ],
    "prepare_null_and_negative_params": [
        "prepare q2 from select count(*) from nation where n_nationkey > ?",
        "execute q2 using -1",
        "execute q2 using null",
    ],
    "describe_input_output": [
        "prepare dq from select n_name, n_regionkey + ? as rk from nation where n_nationkey < ?",
        "describe output dq",
        "describe input dq",
    ],
}


def _tpch_pair(where: str = "local") -> StatementPair:
    return StatementPair(catalog="tpch", schema="tiny", target_splits=2, where=where)


@pytest.mark.parametrize("name", list(VIEW_CASES))
def test_view_and_prepared_cases_match_jax(name):
    _tpch_pair().run_all(VIEW_CASES[name])


# -- tests/test_recursive_cte.py -----------------------------------------------------

RECURSIVE_CASES = {
    "counting_sequence": "with recursive t(n) as (select 1 union all "
                         "select n + 1 from t where n < 5) select * from t order by 1",
    "factorial": "with recursive f(n, v) as (select 1, 1 union all "
                 "select n + 1, v * (n + 1) from f where n < 5) select max(v) from f",
    "distinct_union_fixpoint": "with recursive t(n) as (select 1 union "
                               "select n % 3 + 1 from t) select count(*), sum(n) from t",
    "recursive_over_table": "with recursive walk(k) as ("
                            "  select n_nationkey from nation where n_nationkey = 0 "
                            "  union all "
                            "  select w.k + 5 from walk w where w.k < 20"
                            ") select count(*) from walk",
    "depth_guard": "with recursive t(n) as (select 1 union all "
                   "select n + 1 from t) select count(*) from t",
    "count_star_over_values": "select count(*) from (values (1), (2))",
    "non_recursive_with_still_works": "with r as (select r_regionkey k from region) "
                                      "select count(*) from r",
    "empty_anchor": "with recursive t(x) as (select 1 where false union all "
                    "select x+1 from t) select count(*) from t",
    "union_dedupes_anchor": "with recursive t(x) as (select * from (values (1),(1)) v(x) "
                            "union select x from t where false) select count(*) from t",
    "step_type_widening": "with recursive t(x) as (select 1 union all "
                          "select x + 0.5 from t where x < 3) select max(x) from t",
    "nested_cte_in_definition": "with recursive t(n) as (with seed as (select 1 as n) "
                                "select n from seed union all select n+1 from t where n<3) "
                                "select count(*) from t",
    "explain_recursive": "explain with recursive t(n) as (select 1 union all "
                         "select n + 1 from t where n < 3) select * from t",
    # every value kind a step carries through its VALUES relation
    "value_round_trip": (
        "with recursive t(i, d, ts, sd, ld, x, s, b, z) as ("
        "select 0, date '1998-12-30', timestamp '2021-07-15 13:14:15.250001', "
        "cast(1.25 as decimal(10,2)), cast(99999999999999999999.25 as decimal(38,2)), "
        "cast(0.1 as double), 'a''b', true, cast(null as bigint) "
        "union all select i + 1, d + interval '1' day, ts + interval '1' second, "
        "sd * 2, ld + 1, x * 3, s || 'c', not b, z from t where i < 4) "
        "select * from t order by i"
    ),
}


@pytest.fixture(scope="module")
def recursive_pair():
    return _tpch_pair()


@pytest.mark.parametrize("name", list(RECURSIVE_CASES))
def test_recursive_cases_match_jax(recursive_pair, name):
    recursive_pair.run(RECURSIVE_CASES[name])


def test_depth_guard_raises_runtime_error(recursive_pair):
    """The JAX test's own check: the guard's RuntimeError names the CTE."""
    with pytest.raises(RuntimeError, match="recursive CTE t exceeded 100 iterations"):
        recursive_pair.port.execute(RECURSIVE_CASES["depth_guard"])


# -- the 4-worker mesh ----------------------------------------------------------------

MESH_CASES = {
    "view": [
        "create view big_orders as select o_orderkey, o_custkey, o_totalprice from orders "
        "where o_totalprice > 200000",
        "select c_mktsegment, count(*), sum(o_totalprice) from big_orders "
        "join customer on o_custkey = c_custkey group by 1 order by 1",
    ],
    "prepared": [
        "prepare pq from select o_orderpriority, count(*) from orders "
        "where o_orderdate < ? and o_totalprice > ? group by 1 order by 1",
        "execute pq using '1995-01-01', 1000",
        "describe output pq",
    ],
    "recursive_join": [
        "with recursive k(n) as (select 1 union all select n + 1 from k where n < 40) "
        "select count(*), sum(l_quantity), max(l_shipdate) from k "
        "join lineitem on l_orderkey = k.n",
    ],
}


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_cases_match_jax_local(name):
    _tpch_pair("mesh").run_all(MESH_CASES[name])


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_chip_smoke_view_and_recursive_statements_at_tiny(where):
    """chip_smoke.py's phase-5k D1 CTAS, then its D4 and D5 statements for
    `where`, at tpch.tiny, held to the JAX local run."""
    p = StatementPair(where=where, target_splits=4)
    for step in chip_smoke.statement_steps("tiny"):
        if step.label == "D1_ctas" or (step.group in ("D4", "D5") and step.where == where):
            for sql in step.statements:
                p.run(sql)

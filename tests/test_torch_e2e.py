"""The port's single-device SQL path (trino_tpu_torch LocalQueryRunner on the
CPU) against the JAX package's LocalQueryRunner on tpch.tiny: TPC-H Q1 and
Q6, Q1 over DOUBLE ("Q1-double", the grouped-sums kernel's shape), the
query of tests/test_pallas_agg.py, and edge shapes (NULLs, integer group
keys with TopN, an empty global aggregation), each with `pallas_agg` off
and on.

Tolerances:
  * integers, decimals, dates and strings: exact;
  * doubles on the default path: relative 1e-9 (both engines sum in f64,
    in different orders);
  * doubles with `pallas_agg` on: relative 5e-5.  The grouped-sums kernel
    accumulates in float32 (unit roundoff 2**-24 = 6e-8).  On the card each
    output is a sequential f32 sum of at most ~530 partial terms (rows per
    warp slot + accumulator copies + block partials at N = 2**20), which
    bounds the error by ~530 * 6e-8 = 3.2e-5 of the sum of |values|; every
    value these queries sum is non-negative, so that is 3.2e-5 of the
    result.  On the CPU the plain version is tighter still (f64 sums
    rounded once).  Counts stay exact.
"""

import math
from decimal import Decimal

import pytest

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.ops import aggregation as port_agg
from trino_tpu_torch.ops import grouped_sums as gs
from trino_tpu_torch.runtime.runner import LocalQueryRunner

Q1_DOUBLE = """select l_returnflag, l_linestatus,
       sum(cast(l_quantity as double)), sum(cast(l_extendedprice as double)),
       sum(cast(l_extendedprice as double) * (1 - cast(l_discount as double))),
       avg(cast(l_quantity as double)), avg(cast(l_discount as double)), count(*)
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"""

PALLAS_AGG_QUERY = (
    "select o_orderstatus, o_orderpriority, count(*), "
    "sum(cast(o_totalprice as double)), avg(cast(o_totalprice as double)) "
    "from orders group by o_orderstatus, o_orderpriority"
)

#: name -> (sql, ordered, reaches the grouped-sums kernel under pallas_agg)
CASES = {
    "q1": (QUERIES[1], True, False),
    "q6": (QUERIES[6], True, False),
    "q1_double": (Q1_DOUBLE, True, True),
    "pallas_agg_query": (PALLAS_AGG_QUERY, False, True),
    # NULL values and a NULL group key, through a VALUES source
    "values_with_nulls": (
        "select k, sum(v), count(v), avg(v), count(*) from (values "
        "('a', 1.5e0), ('a', null), ('b', 2.0e0), (null, 4.0e0)) t(k, v) "
        "group by k",
        False,
        True,
    ),
    # integer group keys (the sort-based group path), min/max, TopN
    "integer_keys_topn": (
        "select l_linenumber, count(*), sum(l_quantity), min(l_shipdate), "
        "max(l_discount) from lineitem group by l_linenumber "
        "order by 2 desc, 1 limit 3",
        True,
        False,
    ),
    # a global aggregation over no rows: one row, NULL sums
    "empty_global": (
        "select count(*), sum(l_extendedprice), avg(l_quantity) "
        "from lineitem where l_quantity < 0",
        True,
        False,
    ),
}


@pytest.fixture(scope="module")
def runners():
    out = {}
    for pallas in (False, True):
        jax_runner = JaxRunner(catalog="tpch", schema="tiny")
        port_runner = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
        if pallas:
            jax_runner.execute("set session pallas_agg = true")
            port_runner.execute("set session pallas_agg = true")
        out[pallas] = (jax_runner, port_runner)
    return out


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: tuple("\0" if v is None else str(v) for v in r))


def assert_same_rows(actual, expected, ordered: bool, float_rtol: float):
    assert len(actual) == len(expected)
    if not ordered:
        actual, expected = _sorted_rows(actual), _sorted_rows(expected)
    for ra, re in zip(actual, expected):
        assert len(ra) == len(re)
        for va, ve in zip(ra, re):
            if isinstance(ve, float):
                assert isinstance(va, float), (va, ve)
                assert math.isclose(va, ve, rel_tol=float_rtol, abs_tol=0.0), (
                    va, ve, ra, re,
                )
            else:
                # ints, Decimals (their scale too), strings, dates, NULLs:
                # exact, same type
                assert type(va) is type(ve) and va == ve, (va, ve, ra, re)
                if isinstance(ve, Decimal):
                    assert str(va) == str(ve), (va, ve, ra, re)


@pytest.mark.parametrize("pallas", [False, True], ids=["default", "pallas_agg"])
@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_jax(runners, name, pallas):
    sql, ordered, eligible = CASES[name]
    jax_runner, port_runner = runners[pallas]
    expected = jax_runner.execute(sql)
    before = gs.grouped_sums_reference.launches
    actual = port_runner.execute(sql)
    launched = gs.grouped_sums_reference.launches - before
    assert [t.name for t in actual.types] == [t.name for t in expected.types]
    assert actual.column_names == expected.column_names
    assert_same_rows(
        actual.rows, expected.rows, ordered, float_rtol=5e-5 if pallas else 1e-9
    )
    if pallas and eligible:
        assert launched > 0
    else:
        # decimal sums and min/max are not eligible for the f32 kernel
        assert launched == 0


def test_forced_one_hot_matmul_is_exact(monkeypatch):
    """The exact f64 one-hot matmul path (the default on the card) forced
    on for CPU tensors: decimal results must equal the JAX package's."""
    expected = JaxRunner(catalog="tpch", schema="tiny").execute(QUERIES[1]).rows
    calls = {"n": 0}
    orig = port_agg.AggregationOperator._matmul_direct_sums

    def counted(self, *args):
        out = orig(self, *args)
        calls["n"] += out is not None
        return out

    monkeypatch.setattr(port_agg.AggregationOperator, "force_matmul", True)
    monkeypatch.setattr(port_agg.AggregationOperator, "_matmul_direct_sums", counted)
    rows = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu").execute(
        QUERIES[1]
    ).rows
    assert calls["n"] > 0, "the matmul path did not engage"
    assert rows == expected
    assert all(isinstance(v, Decimal) for v in rows[0][2:9])


def test_session_and_use_statements():
    r = LocalQueryRunner(catalog="tpch", schema="sf1", device="cpu")
    r.execute("use tiny")
    r.execute("set session page_rows = 4096")
    assert r.properties.get("page_rows") == 4096
    assert r.execute("select count(*) from nation").rows == [(25,)]
    # joins, semi joins, LIKE, window functions and TABLESAMPLE run in the
    # port
    joined = r.execute(
        "select n_name, r_name from nation join region "
        "on n_regionkey = r_regionkey"
    )
    assert len(joined.rows) == 25
    semi = r.execute(
        "select n_name from nation where n_regionkey in "
        "(select r_regionkey from region where r_name = 'ASIA')"
    )
    assert len(semi.rows) == 5
    liked = r.execute("select n_name from nation where n_name like 'A%'")
    assert sorted(row[0] for row in liked.rows) == ["ALGERIA", "ARGENTINA"]
    ranked = r.execute("select rank() over (order by n_name) from nation")
    assert sorted(row[0] for row in ranked.rows) == list(range(1, 26))
    sampled = r.execute("select n_name from nation tablesample bernoulli (50)").rows
    # the port reads the splits under a sample in order: the JAX package's
    # rows under serial split readers
    jax = JaxRunner(catalog="tpch", schema="tiny")
    jax.execute("set session task_concurrency = 1")
    assert sampled == jax.execute("select n_name from nation tablesample bernoulli (50)").rows
    assert 0 < len(sampled) < 25

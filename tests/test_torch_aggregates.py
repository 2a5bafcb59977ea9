"""The streaming aggregates (bool_and/bool_or/every, checksum,
approx_distinct over HyperLogLog registers, the covariance/correlation/
regression family) and the range-positional group path in the port against
the JAX package.

Module level, bit for bit on seeded numpy inputs: `_hll_hash` over int64
(INT64_MIN/MAX, negatives), dates, booleans, short decimals, doubles (±0.0,
NaN, ±inf, every exact power of two with its nextafter neighbours,
subnormals, the largest finite double, seeded values across the whole
exponent range), reals and dictionary strings; the double hash's exp2 table
against the JAX package's jnp.exp2 at every integer it reads; `_hll_registers`
with dead and NULL rows and `_hll_estimate` from the small (linear
counting) to the large range; the bivariate family's order-free sums
against the exact sum, in two orders.

As SQL at tpch.tiny, through the JAX package's LocalQueryRunner and the
port's LocalQueryRunner and 4-worker mesh: every test of
tests/test_agg_hll_waves.py (the two budgeted ones under the same budgets)
and of tests/test_bivariate_aggs.py (as a VALUES relation with the same 40
seeded rows, and in the JAX test's own form: its memory table `pts`
created and filled by INSERT in both packages, stored tables held equal),
the JAX tests' own numpy checks kept at their abs=1e-9, and the
approx_distinct cases of tests/test_functions.py; bool_and,
bool_or, every and checksum over bigint, decimal, date, varchar, double and
boolean with NULLs, global and grouped, the mesh equal to the local runner;
the range-positional path (a bigint key, a date key, a nullable key, two
keys, and a domain too large, which sorts) with the path each grouped
reduction took (`GROUP_PATHS`); the statements of chip_smoke.py's phase 5h
(A1-A4); the streaming states under budgets that force folds and state
waves.  A long-decimal or array argument of checksum or approx_distinct
raises NotImplementedError by name in the port (the JAX package fails on
the shape there, or reads limbs or padded slots as rows).

Tolerances: checksums, booleans, counts and estimates exact; doubles
relative 1e-9.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu import types as JT
from trino_tpu.columnar import Column as JColumn
from trino_tpu.columnar import StringDictionary as JDict
from trino_tpu.ops import aggregation as jagg
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Column as TColumn
from trino_tpu_torch.columnar import StringDictionary as TDict
from trino_tpu_torch.ops import aggregation as tagg
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.telemetry import metrics as pmetrics

import chip_smoke
from test_torch_arrays import SqlParity
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)


# -- the value hash, the registers and the estimate ----------------------------


def _double_edges() -> np.ndarray:
    big = np.finfo(np.float64).max
    vals = [0.0, -0.0, np.nan, np.inf, -np.inf, big, -big, 5e-324, -5e-324,
            np.finfo(np.float64).tiny, 1e-310, -1e-310]
    for k in range(-1074, 1024):
        p = math.ldexp(1.0, k)
        vals += [p, -p, np.nextafter(p, 0.0), np.nextafter(p, np.inf)]
        if k > -1000:
            vals += [np.nextafter(np.nextafter(p, 0.0), 0.0), np.nextafter(np.nextafter(p, np.inf), np.inf)]
    rng = np.random.default_rng(11)
    vals += list(rng.standard_normal(4000) * 10.0 ** rng.integers(-300, 300, 4000))
    vals += list(rng.integers(-10**9, 10**9, 2000) / 100.0)  # decimal cents as doubles
    return np.asarray(vals, dtype=np.float64)


def _hash_inputs():
    rng = np.random.default_rng(5)
    i64 = np.concatenate([
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1], dtype=np.int64),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 500, dtype=np.int64),
    ])
    words = sorted({f"w{i}-{int(x)}" for i, x in enumerate(rng.integers(0, 10**6, 300))})
    with np.errstate(over="ignore"):  # doubles past the float range become infinities
        reals = _double_edges()[:6000].astype(np.float32)
    return {
        "bigint": (i64, JT.BIGINT, TT.BIGINT, None),
        "date": (rng.integers(-30000, 30000, 400).astype(np.int32), JT.DATE, TT.DATE, None),
        "boolean": (rng.random(50) < 0.5, JT.BOOLEAN, TT.BOOLEAN, None),
        "decimal": (rng.integers(-10**17, 10**17, 400), JT.DecimalType(18, 2), TT.DecimalType(18, 2), None),
        "double": (_double_edges(), JT.DOUBLE, TT.DOUBLE, None),
        "real": (
            np.concatenate([reals, np.array([1e-40, -1e-40, 1e-38, 1.5], dtype=np.float32)]),
            JT.REAL, TT.REAL, None,
        ),
        "varchar": (rng.integers(0, len(words), 600).astype(np.int32), JT.VARCHAR, TT.VARCHAR, words),
    }


def _columns(data, jt, tt, words, valid=None):
    jcol = JColumn(jnp.asarray(data), jt, None if valid is None else jnp.asarray(valid),
                   None if words is None else JDict(words))
    tcol = TColumn(torch.from_numpy(np.ascontiguousarray(data)), tt,
                   None if valid is None else torch.from_numpy(valid),
                   None if words is None else TDict(words))
    return jcol, tcol


@pytest.mark.parametrize("kind", list(_hash_inputs()))
def test_hll_hash_bit_exact(kind):
    data, jt, tt, words = _hash_inputs()[kind]
    jcol, tcol = _columns(data, jt, tt, words)
    expected = np.asarray(jagg._hll_hash(jcol)).view(np.int64)
    actual = tagg._hll_hash(tcol).numpy()
    bad = np.flatnonzero(actual != expected)
    assert bad.size == 0, [(data[i], actual[i], expected[i]) for i in bad[:5]]


def test_double_hash_exp2_table_is_jax_exp2():
    exp2, _, _ = tagg._double_hash_host_tables()
    ks = np.arange(-1023, 1024, dtype=np.float64)
    assert np.array_equal(exp2, np.asarray(jnp.exp2(jnp.asarray(ks))))


@pytest.mark.parametrize("kind", ["bigint", "double", "varchar"])
def test_hll_registers_bit_exact(kind):
    data, jt, tt, words = _hash_inputs()[kind]
    rng = np.random.default_rng(3)
    valid = rng.random(data.shape[0]) < 0.8
    jcol, tcol = _columns(data, jt, tt, words)
    expected = np.asarray(jagg._hll_registers(jcol, jnp.asarray(valid)))
    actual = tagg._hll_registers(tcol, torch.from_numpy(valid)).numpy()
    assert actual.dtype == np.int32 and np.array_equal(actual, expected)


@pytest.mark.parametrize("n", [0, 50, 5_000, 300_000])
def test_hll_estimate_matches_jax(n):
    """From empty registers through the linear-counting range to the raw
    estimator; several registers sets per size, as [sets, HLL_M]."""
    rng = np.random.default_rng(n)
    regs = []
    for _ in range(3):
        keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)
        jcol, _ = _columns(keys, JT.BIGINT, TT.BIGINT, None)
        regs.append(np.asarray(jagg._hll_registers(jcol, jnp.ones(n, bool))))
    regs = np.stack(regs)
    expected = np.asarray(jagg._hll_estimate(jnp.asarray(regs)))
    actual = tagg._hll_estimate(torch.from_numpy(regs)).numpy()
    assert np.array_equal(actual, expected)
    if n >= 5_000:
        assert np.all(np.abs(actual - n) <= 0.04 * n)


def test_order_free_sum_is_exact_in_any_order():
    """The bivariate family's sums: the same bits in every addition order
    (the card's atomics against the CPU's sequential adds), the correctly
    rounded exact sum, and infinities and NaN as a plain sum gives them."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    n = 50_000
    # products of cents, the l_discount x l_tax shape whose covariance cancels
    v = torch.from_numpy(rng.integers(0, 11, n) * 0.01 * (rng.integers(0, 9, n) * 0.01))
    gid = torch.from_numpy(rng.integers(0, 3, n))
    perm = torch.from_numpy(rng.permutation(n))
    got = tagg._order_free_sum(v, gid, 3)
    assert torch.equal(got, tagg._order_free_sum(v[perm], gid[perm], 3))
    exact = [float(sum(map(Fraction, v[gid == g].tolist()))) for g in range(3)]
    assert got.tolist() == exact
    two = torch.stack([v, -2.0 * v], dim=1)  # [n, k] series at once
    assert torch.equal(tagg._order_free_sum(two, gid, 3)[:, 0], got)
    z = torch.zeros(2, dtype=torch.int64)
    for vals in ([math.inf, 1.0], [math.nan, 1.0], [1e308, 1e308], [-math.inf, math.inf]):
        out = tagg._order_free_sum(torch.tensor(vals, dtype=torch.float64), z, 1).item()
        assert out == sum(vals) or (math.isnan(out) and math.isnan(sum(vals)))


def test_grouped_approx_distinct_operator_raises():
    with pytest.raises(NotImplementedError, match="grouped approx_distinct"):
        tagg.AggregationOperator(
            [0], [tagg.AggSpec("approx_distinct", 1, TT.BIGINT)], [TT.BIGINT, TT.BIGINT],
            torch.device("cpu"),
        )


# -- SQL: the cases of tests/test_agg_hll_waves.py -----------------------------


@pytest.fixture(scope="module")
def parity():
    return SqlParity()


def _port(target_splits: int = 2, **props):
    r = LocalQueryRunner(catalog="tpch", schema="tiny", target_splits=target_splits, device="cpu")
    for k, v in props.items():
        r.execute(f"set session {k} = {v}")
    return r


def _jax(target_splits: int = 2, **props):
    r = JaxRunner(catalog="tpch", schema="tiny", target_splits=target_splits)
    for k, v in props.items():
        r.execute(f"set session {k} = {v}")
    return r


@pytest.mark.parametrize(
    "col,table",
    [("l_orderkey", "lineitem"), ("l_partkey", "lineitem"), ("l_shipdate", "lineitem"),
     ("l_returnflag", "lineitem"), ("l_discount", "lineitem")],
)
def test_approx_distinct_within_error(parity, col, table):
    # the port's exact DISTINCT count is held to the JAX package's elsewhere
    exact = parity.local.execute(f"select count(distinct {col}) from {table}").rows[0][0]
    got = parity.check(f"select approx_distinct({col}) from {table}", "local")[0][0]
    # p=13 registers: standard error ~1.15%; 3 sigma + small-N slack
    assert abs(got - exact) <= max(3, 0.04 * exact), (got, exact)


def test_approx_distinct_null_and_empty(parity):
    sql = "select approx_distinct(l_orderkey) from lineitem where l_orderkey < 0"
    assert parity.check(sql, "local") == [(0,)]
    sql = "select approx_distinct(nullif(l_linenumber, l_linenumber)) from lineitem"
    assert parity.check(sql, "local") == [(0,)]


def test_approx_distinct_merges_across_batches(parity):
    """Per-batch register states merge by elementwise max into the estimate
    one batch gives."""
    sql = "select approx_distinct(l_suppkey) from lineitem"
    one = _port(target_splits=1).execute(sql).rows
    assert _port(target_splits=4).execute(sql).rows == one == parity.check(sql, "local")


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_grouped_approx_distinct_falls_back_exact(parity, where):
    got = parity.check(
        "select l_returnflag, approx_distinct(l_linenumber) from lineitem "
        "group by l_returnflag order by l_returnflag", where,
    )
    assert got == parity.expected(
        "select l_returnflag, count(distinct l_linenumber) from lineitem "
        "group by l_returnflag order by l_returnflag"
    ).rows


def test_distributed_approx_distinct_matches_local(parity):
    """The sketch is deterministic and the merge an exact max: the mesh's
    registers and estimate are the local runner's."""
    sql = "select approx_distinct(o_custkey) from orders"
    assert parity.check(sql, "mesh") == parity.check(sql, "local")
    assert parity.mesh.execute(sql).rows == parity.local.execute(sql).rows


@pytest.mark.parametrize(
    "sql,budget",
    [
        ("select l_orderkey, sum(l_quantity) q, count(*) c from lineitem "
         "group by l_orderkey order by q desc, l_orderkey limit 5", 200_000),
        ("select o_custkey, avg(o_totalprice) a from orders "
         "group by o_custkey having count(*) > 2 order by a desc limit 3", 150_000),
    ],
    ids=["exact_under_budget", "having_and_avg"],
)
def test_agg_waves_under_budget(sql, budget):
    base = _port(4).execute(sql).rows
    before = pmetrics.memory_waves_counter().value(("aggregation",))
    waved = _port(4, query_max_memory_bytes=budget).execute(sql).rows
    assert pmetrics.memory_waves_counter().value(("aggregation",)) > before
    assert base == waved == _jax(4, query_max_memory_bytes=budget).execute(sql).rows


#: the approx_distinct cases of tests/test_functions.py
FUNCTION_SQL = {
    "approx_distinct": (
        "select approx_distinct(n_regionkey), approx_distinct(n_name) from nation", [(5, 25)],
    ),
    "approx_distinct_grouped": (
        "select o_orderstatus, approx_distinct(o_custkey) from orders "
        "group by o_orderstatus order by 1", None,
    ),
}


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(FUNCTION_SQL))
def test_function_cases_match_jax(parity, name, where):
    sql, rows = FUNCTION_SQL[name]
    got = parity.check(sql, where)
    assert rows is None or got == rows


# -- SQL: the cases of tests/test_bivariate_aggs.py ----------------------------


def _pts():
    """The JAX test's 40 seeded (g, y, x) rows, as a VALUES relation."""
    rng = np.random.default_rng(7)
    xs = rng.normal(size=40)
    ys = 2.5 * xs + 1.0 + rng.normal(scale=0.1, size=40)
    y = np.array([round(float(v), 12) for v in ys])
    x = np.array([round(float(v), 12) for v in xs])
    rows = ", ".join(  # exponent notation: DOUBLE literals, 17 digits round trip
        f"({1 + i % 2}, {yv:.17e}, {xv:.17e})" for i, (yv, xv) in enumerate(zip(y, x))
    )
    return f"(values {rows}) as pts(g, y, x)", y, x


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_corr_covar_match_numpy(parity, where):
    rel, y, x = _pts()
    got = parity.check(f"select corr(y, x), covar_samp(y, x), covar_pop(y, x) from {rel}", where)[0]
    assert got[0] == pytest.approx(np.corrcoef(y, x)[0, 1], abs=1e-9)
    assert got[1] == pytest.approx(np.cov(y, x, ddof=1)[0, 1], abs=1e-9)
    assert got[2] == pytest.approx(np.cov(y, x, ddof=0)[0, 1], abs=1e-9)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_regression_match_polyfit(parity, where):
    rel, y, x = _pts()
    slope, intercept = np.polyfit(x, y, 1)
    got = parity.check(f"select regr_slope(y, x), regr_intercept(y, x) from {rel}", where)[0]
    assert got[0] == pytest.approx(slope, abs=1e-9)
    assert got[1] == pytest.approx(intercept, abs=1e-9)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_bivariate_grouped(parity, where):
    rel, _, _ = _pts()
    rows = parity.check(f"select g, corr(y, x) from {rel} group by g order by g", where)
    assert len(rows) == 2 and all(0.99 < c <= 1.0 for _, c in rows)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_bivariate_memory_table_form(where):
    """tests/test_bivariate_aggs.py's own fixture: the memory table `pts`
    filled by one INSERT of the 40 seeded rows, then its four queries, in
    the JAX package and the port (test_torch_ddl.StatementPair)."""
    from test_torch_ddl import StatementPair

    rng = np.random.default_rng(7)
    xs = rng.normal(size=40)
    ys = 2.5 * xs + 1.0 + rng.normal(scale=0.1, size=40)
    vals = ", ".join(
        f"({1 + i % 2}, {round(float(y), 12)}, {round(float(x), 12)})"
        for i, (x, y) in enumerate(zip(xs, ys))
    )
    p = StatementPair(where=where)
    p.run_all([
        "create table pts (g bigint, y double, x double)",
        f"insert into pts values {vals}",
        "select corr(y, x), covar_samp(y, x), covar_pop(y, x) from pts",
        "select regr_slope(y, x), regr_intercept(y, x) from pts",
        "select g, corr(y, x) from pts group by g order by g",
    ])
    y = np.array([round(float(v), 12) for v in ys])
    x = np.array([round(float(v), 12) for v in xs])
    got = p.port.execute("select corr(y, x), covar_pop(y, x) from pts").rows[0]
    assert got[0] == pytest.approx(np.corrcoef(y, x)[0, 1], abs=1e-9)
    assert got[1] == pytest.approx(np.cov(y, x, ddof=0)[0, 1], abs=1e-9)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_pairwise_null_skip(parity, where):
    rows = parity.check(
        "select covar_pop(y, x), corr(y, x) from "
        "(values (1.0, 2.0), (null, 5.0), (3.0, null), (3.0, 4.0)) as t(y, x)", where,
    )
    # only (1,2) and (3,4) count: covar_pop = 7 - 2*3 = 1, corr = 1
    assert rows[0][0] == pytest.approx(1.0) and rows[0][1] == pytest.approx(1.0)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_degenerate_null(parity, where):
    rows = parity.check(
        "select corr(y, x), regr_slope(y, x), regr_intercept(y, x), covar_samp(y, x) "
        "from (values (1.0, 2.0)) as t(y, x)", where,
    )
    assert rows == [(None, None, None, None)]  # n <= 1: undefined


def test_bivariate_distributed_matches_local(parity):
    sql = (
        "select l_returnflag, round(corr(l_extendedprice, l_quantity), 6) "
        "from lineitem group by l_returnflag order by 1"
    )
    assert parity.check(sql, "mesh") == parity.check(sql, "local")
    assert parity.mesh.execute(sql).rows == parity.local.execute(sql).rows


# -- SQL: bool_and/bool_or/every and checksum ------------------------------------

#: every argument type with NULLs (nullif and CASE make them)
_ARGS = (
    "bool_and(nullif(l_quantity >= 2, false)) ba, bool_or(case when l_linenumber = 1 then null "
    "else l_discount > 0.09 end) bo, every(l_tax <= 0.08) ev, "
    "checksum(nullif(l_orderkey, 7)) c_bigint, checksum(nullif(l_extendedprice, l_extendedprice)) c_all_null, "
    "checksum(nullif(l_discount, 0.05)) c_decimal, checksum(nullif(l_shipdate, date '1996-01-02')) c_date, "
    "checksum(nullif(l_shipmode, 'MAIL')) c_varchar, checksum(l_comment) c_comment, "
    "checksum(nullif(l_quantity / 7e0, 1e0)) c_double, "
    "checksum(case when l_linenumber = 2 then null else l_quantity > 25 end) c_boolean"
)
#: global, and grouped by an integer key (the positional path locally; the
#: mesh's steps sort); phase 5h's A2 groups checksums by dictionary keys
CHECKSUM_SQL = {
    "global": f"select {_ARGS} from lineitem",
    "grouped": f"select l_linenumber, {_ARGS} from lineitem group by 1 order by 1",
}


@pytest.mark.parametrize("name", list(CHECKSUM_SQL))
def test_bool_and_checksum_match_jax(parity, name):
    sql = CHECKSUM_SQL[name]
    local = parity.check(sql, "local")
    assert parity.mesh.execute(sql).rows == local  # exact: no float state here


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_bool_and_checksum_over_no_rows_are_null(parity, where):
    """NULL over zero input rows, the checksum too (its count state is 0)."""
    rows = parity.runner(where).execute(f"select {_ARGS} from lineitem where l_orderkey < 0").rows
    assert rows == [(None,) * 11]


def test_checksum_merges_exactly_across_splits(parity):
    """The wrapping int64 sum gives one value in every fold order."""
    sql = CHECKSUM_SQL["global"]
    assert _port(1).execute(sql).rows == _port(6).execute(sql).rows == parity.check(sql, "local")


@pytest.mark.parametrize(
    "sql,match",
    [
        ("select checksum(cast(l_extendedprice as decimal(30,2))) from lineitem",
         "checksum over a long-decimal"),
        ("select l_returnflag, checksum(cast(l_extendedprice as decimal(30,2))) "
         "from lineitem group by 1", "checksum over a long-decimal"),
        ("select approx_distinct(cast(l_extendedprice as decimal(30,2))) from lineitem",
         "approx_distinct over a long-decimal"),
        ("select checksum(array[l_orderkey]) from lineitem", r"checksum over an array\(bigint\)"),
        ("select approx_distinct(array[l_orderkey]) from lineitem",
         r"approx_distinct over an array\(bigint\)"),
        ("select corr(array[l_quantity], l_tax) from lineitem", r"corr over an array"),
    ],
    ids=["checksum_long_decimal", "checksum_long_decimal_grouped", "approx_long_decimal",
         "checksum_array", "approx_array", "corr_array"],
)
@pytest.mark.parametrize("where", ["local", "mesh"])
def test_unsupported_arguments_raise_by_name(parity, sql, match, where):
    with pytest.raises(NotImplementedError, match=match):
        parity.runner(where).execute(sql)


# -- SQL: the range-positional group path ---------------------------------------

#: name -> (sql, the path every grouped reduction of the local run takes)
POSITIONAL_SQL = {
    "bigint_key": (
        "select l_orderkey, count(*), sum(l_quantity), min(l_shipdate) from lineitem "
        "group by l_orderkey order by 3 desc, 1 limit 20", "positional",
    ),
    "date_key": (
        "select l_shipdate, count(*), checksum(l_partkey), corr(l_quantity, l_tax) "
        "from lineitem group by 1 order by 1", "positional",
    ),
    "nullable_key": (
        "select nullif(l_suppkey % 7, 3) k, count(*), bool_or(l_quantity > 49), "
        "avg(l_extendedprice) from lineitem group by 1 order by 1", "positional",
    ),
    "two_keys": (
        "select l_suppkey, l_linenumber, count(*), max(l_comment) from lineitem "
        "group by 1, 2 order by 3 desc, 1, 2 limit 20", "positional",
    ),
    "domain_too_large": (
        "select l_orderkey * 100000 k, count(*) from lineitem group by 1 "
        "order by 2 desc, 1 limit 20", "sorted",
    ),
}


@pytest.mark.parametrize("name", list(POSITIONAL_SQL))
def test_positional_path_matches_jax(parity, name):
    sql, path = POSITIONAL_SQL[name]
    tagg.GROUP_PATHS.clear()
    parity.check(sql, "local")
    assert set(tagg.GROUP_PATHS) == {path}, tagg.GROUP_PATHS
    parity.check(sql, "mesh")


# -- SQL: chip_smoke.py phase 5h at tiny ----------------------------------------


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", sorted(chip_smoke.AGGREGATE_QUERIES))
def test_phase_5h_statements_match_jax_at_tiny(parity, name, where):
    """chip_smoke.py phase 5h's statements are forms the JAX package
    answers, and the port gives its rows at tiny, locally and on the mesh
    (A1's checksums and estimates exactly); the local A4 groups take the
    positional path."""
    tagg.GROUP_PATHS.clear()
    rows = parity.check(chip_smoke.AGGREGATE_QUERIES[name], where)
    assert rows
    if name.startswith("A4") and where == "local":
        assert tagg.GROUP_PATHS.get("positional", 0) > 0 and "sorted" not in tagg.GROUP_PATHS
    if name == "A1" and where == "mesh":
        assert parity.mesh.execute(chip_smoke.AGGREGATE_QUERIES[name]).rows == \
            parity.local.execute(chip_smoke.AGGREGATE_QUERIES[name]).rows


# -- the streaming states under budgets ----------------------------------------


def test_sketch_state_folds_under_budget():
    """Eight register states (32 KiB each) pass a 100 kB budget: the
    operator folds them, and the estimate stays the unbudgeted one."""
    sql = "select approx_distinct(l_partkey), checksum(l_partkey) from lineitem"
    base = _port(8).execute(sql).rows
    assert _port(8, query_max_memory_bytes=100_000).execute(sql).rows == base
    assert base == _jax(8, query_max_memory_bytes=100_000).execute(sql).rows


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_streaming_states_in_waves_under_budget(parity, where):
    """checksum, bool_and and bivariate states spill and merge in
    group-hash waves (locally) and in the exchange's waves (mesh)."""
    sql = (
        "select l_orderkey, checksum(l_partkey), bool_and(l_quantity > 2), "
        "corr(l_quantity, l_extendedprice), count(*) from lineitem group by 1"
    )
    expected = parity.expected(sql)
    if where == "local":
        r = _port(2, query_max_memory=150_000)
    else:
        from trino_tpu_torch.parallel import DistributedQueryRunner

        r = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        r.execute("set session query_max_memory = 150000")
    before = pmetrics.memory_waves_counter().value(("aggregation",))
    actual = r.execute(sql)
    assert pmetrics.memory_waves_counter().value(("aggregation",)) > before
    from trino_tpu_torch.testing import ResultOrder, assert_rows_match

    assert_rows_match(actual.rows, expected.rows, ResultOrder((), None), float_rtol=1e-9)

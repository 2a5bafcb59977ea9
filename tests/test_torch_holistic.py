"""The holistic aggregates (approx_percentile over a qdigest state, the exact
grouped percentile, min_by/max_by and their n form) in the port against the
JAX package.

Module level, bit for bit on seeded numpy inputs: `qdigest.bucket_ids`,
`histogram` and `estimate` over doubles (negatives, zeros, NaN, ±inf,
subnormals, the smallest normal and the largest finite double, every edge
of a bucket with its two neighbours, seeded values across the exponent
range), the bucket representatives, and the qdigest state a short decimal
builds (including decimal(18,5) values whose bucket depends on how the
decimal is descaled: the JAX package divides, and XLA folds that into a
multiplication by the reciprocal); the aggregation operator of each package,
single-stage, over one seeded batch (a bigint group key with NULLs, dead
rows, NULL and NaN keys, tied keys, a varchar value): min_by, max_by, the n
form and the exact percentile, grouped and global.

As SQL at tpch.tiny, through the JAX package's LocalQueryRunner and the
port's LocalQueryRunner (both with one split reader, so rows arrive in one
order and min_by/max_by break ties alike) and through both 4-worker meshes:
every case of tests/test_qdigest.py (the JAX tests' own numpy checks kept),
the min_by/max_by cases of tests/test_collect_aggs.py (its memory-connector
table becomes a VALUES relation with the same rows), the
rejected forms, which raise the same error in both, approx_percentile and
min_by over long decimals, and chip_smoke.py's phase-5i statements H1-H3
(min_by/max_by values among tied keys also through chip_smoke's witness
check).  A long-decimal min_by key and a long-decimal value of the n form
raise NotImplementedError by name in the port (the JAX package reads limb
planes as rows there).  A grouped holistic aggregation takes the sorted
group path locally and the single-stage repartition on the mesh; under
`query_max_memory` it waves as often as the JAX package's does.

Tolerances: integers, decimals, dates, strings and qdigest counts exact;
doubles relative 1e-9.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trino_tpu import types as JT
from trino_tpu.ops import qdigest as jqd
from trino_tpu.ops.aggregation import AggregationOperator as JAgg, AggSpec as JSpec
from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu.telemetry import metrics as jmetrics
from trino_tpu_torch import types as TT
from trino_tpu_torch.ops import aggregation as tagg
from trino_tpu_torch.ops import qdigest as tqd
from trino_tpu_torch.ops.aggregation import AggregationOperator as TAgg, AggSpec as TSpec
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.telemetry import metrics as pmetrics
from trino_tpu_torch.testing import ResultOrder, assert_rows_match, result_order

import chip_smoke
from test_torch_arrays import Col, pair
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fte import no_spool_leaks  # noqa: F401 (autouse: private spool directory)


# -- the qdigest sketch ---------------------------------------------------------


def _sketch_doubles() -> np.ndarray:
    big = np.finfo(np.float64).max
    vals = [0.0, -0.0, np.nan, np.inf, -np.inf, big, -big, 5e-324, -5e-324, 1e-310,
            -1e-310, np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny]
    for e in range(-140, 140, 3):
        for k in range(64):
            edge = math.ldexp(0.5 + k / 64, e)
            vals += [edge, -edge, np.nextafter(edge, 0.0), np.nextafter(edge, np.inf)]
    rng = np.random.default_rng(3)
    vals += list(rng.standard_normal(3000) * 10.0 ** rng.integers(-300, 300, 3000))
    vals += list(rng.integers(-10**9, 10**9, 2000) / 100.0)
    return np.asarray(vals, dtype=np.float64)


def test_bucket_ids_bit_exact():
    f = _sketch_doubles()
    expected = np.asarray(jqd.bucket_ids(jnp.asarray(f)))
    actual = tqd.bucket_ids(torch.from_numpy(f)).numpy()
    bad = np.flatnonzero(actual != expected)
    assert bad.size == 0, [(f[i], actual[i], expected[i]) for i in bad[:5]]
    assert np.array_equal(tqd.REPS, np.asarray(jqd.REPS))
    assert tqd.NBUCKETS == jqd.NBUCKETS == 16385


@pytest.mark.parametrize("p", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_and_estimate_bit_exact(p):
    f = _sketch_doubles()
    rng = np.random.default_rng(4)
    valid = rng.random(f.shape[0]) >= 0.1
    jcounts = np.asarray(jqd.histogram(jnp.asarray(f), jnp.asarray(valid)))
    tcounts = tqd.histogram(torch.from_numpy(f), torch.from_numpy(valid))
    assert np.array_equal(tcounts.numpy(), jcounts)
    jval, jtotal = jqd.estimate(jnp.asarray(jcounts), p)
    tval, ttotal = tqd.estimate(tcounts, p)
    assert int(ttotal) == int(jtotal)
    assert float(tval) == float(jval) or (math.isnan(float(tval)) and math.isnan(float(jval)))
    # an empty sketch: the JAX package's argmax of no True is slot 0
    jval0, _ = jqd.estimate(jnp.zeros(jqd.NBUCKETS, jnp.int64), p)
    tval0, ttotal0 = tqd.estimate(torch.zeros(tqd.NBUCKETS, dtype=torch.int64), p)
    assert float(tval0) == float(jval0) and int(ttotal0) == 0


#: decimal(18,5) values whose bucket is not the same under x / 10**5 and
#: x * (1 / 10**5) (found by search), and their negatives, plus short
#: decimals of other scales at and around bucket edges
_DESCALE_EDGES = [7945689497599999, 8375186227199999, 15891378995199998,
                  16750372454399998, 31782757990399997, 33500744908799997]


@pytest.mark.parametrize("scale", [0, 2, 5])
def test_decimal_qdigest_state_bit_exact(scale):
    rng = np.random.default_rng(scale)
    xs = [x for x in _DESCALE_EDGES] if scale == 5 else []
    for e in range(-5, 40):
        for k in (0, 17, 63):
            x = int(round(math.ldexp(0.5 + k / 64, e) * 10**scale))
            xs += [x - 1, x, x + 1]
    xs += list(rng.integers(-10**17, 10**17, 500))
    xs = np.asarray([x for x in xs if abs(x) < 10**18], dtype=np.int64)
    xs = np.concatenate([xs, -xs])
    n = 1 << int(np.ceil(np.log2(len(xs) + 8)))
    data = np.zeros(n, dtype=np.int64)
    data[: len(xs)] = xs
    valid = rng.random(n) >= 0.05
    mask = np.arange(n) < len(xs) + 4
    jb, tb = pair([Col(data, JT.DecimalType(18, scale), TT.DecimalType(18, scale), valid)], mask)
    jt, tt = JT.DecimalType(18, scale), TT.DecimalType(18, scale)
    jop = JAgg([], [JSpec("approx_percentile", 0, jt, param=0.5)], [jt], mode="partial")
    top = TAgg([], [TSpec("approx_percentile", 0, tt, param=0.5)], [tt], tb.device, mode="partial")
    expected = np.asarray(jop._step(jb, out_cap=1).columns[0].data)
    actual = top._reduce_step(tb, out_cap=1).columns[0].data.numpy()
    assert actual.shape == (1, tqd.NBUCKETS)
    bad = np.flatnonzero(actual[0] != expected[0])
    assert bad.size == 0, bad[:10]
    if scale == 5:
        # the division, unfolded, would put the searched values in other slots
        divided = tqd.histogram(torch.from_numpy(xs / 1e5), torch.ones(len(xs), dtype=torch.bool))
        assert not np.array_equal(divided.numpy(), tqd.histogram(
            torch.from_numpy(xs * (1.0 / 1e5)), torch.ones(len(xs), dtype=torch.bool)).numpy())


# -- the operator ---------------------------------------------------------------


def _holistic_batch(seed: int, n: int = 128):
    rng = np.random.default_rng(seed)
    words = ["ant", "bee", "cat", "dog", "eel"]
    kd = rng.integers(0, 6, n).astype(np.float64)  # ties
    kd[rng.random(n) < 0.1] = np.nan
    kd[: 4] = np.nan  # a group whose every key may be NaN
    cols = [
        Col(rng.integers(0, 7, n).astype(np.int64), JT.BIGINT, TT.BIGINT, rng.random(n) >= 0.1),
        Col(rng.integers(0, 5, n).astype(np.int32), JT.VARCHAR, TT.VARCHAR, rng.random(n) >= 0.15, words),
        Col(kd, JT.DOUBLE, TT.DOUBLE, rng.random(n) >= 0.15),
        Col(rng.integers(-9, 9, n).astype(np.int64), JT.BIGINT, TT.BIGINT, rng.random(n) >= 0.15),
        Col(rng.integers(-10**6, 10**6, n).astype(np.int64), JT.DecimalType(12, 2),
            TT.DecimalType(12, 2), rng.random(n) >= 0.1),
    ]
    return pair(cols, rng.random(n) < 0.9)


def _holistic_specs(S, T):
    return {
        "min_by_nan_key": S("min_by", 1, T.VARCHAR, arg2=2),
        "max_by_nan_key": S("max_by", 1, T.VARCHAR, arg2=2),
        "min_by_tied_key": S("min_by", 4, T.DecimalType(12, 2), arg2=3),
        "max_by_tied_key": S("max_by", 3, T.BIGINT, arg2=4),
        "min_by_n": S("min_by", 1, T.ArrayType(T.VARCHAR), arg2=3, param=3),
        "max_by_n_nan_key": S("max_by", 3, T.ArrayType(T.BIGINT), arg2=2, param=2),
        "percentile": S("percentile", 4, T.DecimalType(12, 2), param=0.5),
        "percentile_double": S("percentile", 2, T.DOUBLE, param=0.9),
    }


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("agg", list(_holistic_specs(TSpec, TT)))
@pytest.mark.parametrize("seed", [0, 1])
def test_holistic_one_matches_jax(seed, agg, grouped):
    jb, tb = _holistic_batch(seed)
    keys = [0] if grouped else []
    jop = JAgg(keys, [_holistic_specs(JSpec, JT)[agg]], [c.type for c in jb.columns],
               mode="single", streaming=False)
    top = TAgg(keys, [_holistic_specs(TSpec, TT)[agg]], [c.type for c in tb.columns],
               tb.device, mode="single")
    assert not top.streaming  # a holistic aggregate keeps its raw batches
    tagg.GROUP_PATHS.clear()
    (jout,) = list(jop.process(iter([jb])))
    (tout,) = list(top.process(iter([tb])))
    expected = jout.to_pylist()
    assert len(expected) == (8 if grouped else 1)  # 7 keys + the NULL key
    assert_rows_match(tout.to_pylist(), expected, ResultOrder((), None))
    # the bigint group key could take the positional path: a holistic
    # aggregate must not
    assert tagg.GROUP_PATHS == ({"sorted": 1} if grouped else {})


def test_holistic_over_no_rows_matches_jax():
    jb, tb = _holistic_batch(2, n=8)
    jb, tb = jb.filter(jb.mask() & False), tb.filter(tb.mask() & False)
    for name, spec in _holistic_specs(TSpec, TT).items():
        jop = JAgg([], [_holistic_specs(JSpec, JT)[name]], [c.type for c in jb.columns],
                   streaming=False)
        top = TAgg([], [spec], [c.type for c in tb.columns], tb.device)
        assert list(top.process(iter([tb])))[0].to_pylist() == \
            list(jop.process(iter([jb])))[0].to_pylist(), name


def test_grouped_sketches_refused():
    with pytest.raises(NotImplementedError, match="grouped approx_distinct or approx_percentile"):
        TAgg([0], [TSpec("approx_percentile", 1, TT.DOUBLE, param=0.5)],
             [TT.BIGINT, TT.DOUBLE], torch.device("cpu"))


# -- SQL ------------------------------------------------------------------------


class Parity:
    """The JAX LocalQueryRunner and the port's, each with one split reader
    (rows arrive in one order, so min_by/max_by break ties alike; each JAX
    result computed once), and both 4-worker meshes."""

    def __init__(self):
        self.jax = JaxRunner(catalog="tpch", schema="tiny", target_splits=2)
        self.local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
        for r in (self.jax, self.local):
            r.execute("set session task_concurrency = 1")
        self.mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        self.jax_mesh = JaxMesh(catalog="tpch", schema="tiny", n_workers=4)
        self._expected = {}

    def expected(self, sql: str, where: str):
        key = (sql, where)
        if key not in self._expected:
            self._expected[key] = (self.jax if where == "local" else self.jax_mesh).execute(sql)
        return self._expected[key]

    def check(self, sql: str, where: str):
        """`sql` through the port's `where` runner against the JAX
        package's runner of the same kind; returns the JAX result."""
        expected = self.expected(sql, where)
        actual = (self.local if where == "local" else self.mesh).execute(sql)
        assert actual.column_names == expected.column_names
        assert [t.name for t in actual.types] == [t.name for t in expected.types]
        assert_rows_match(actual.rows, expected.rows, result_order(self.local.create_plan(sql)),
                          float_rtol=1e-9)
        return expected


@pytest.fixture(scope="module")
def parity():
    return Parity()


#: the statements of tests/test_qdigest.py
QDIGEST = {
    "global_sketch": (
        "select approx_percentile(l_quantity, 0.5), approx_percentile(l_quantity, 0.9), "
        "approx_percentile(l_extendedprice, 0.25), approx_percentile(l_extendedprice, 0.99) "
        "from lineitem"
    ),
    "negative_and_double": (
        "select approx_percentile(x, 0.5) from (values -100.0, -50.0, -10.0, 10.0, 50.0) t(x)"
    ),
    "grouped_exact": (
        "select l_returnflag, approx_percentile(l_quantity, 0.5) from lineitem "
        "group by l_returnflag order by l_returnflag"
    ),
    "distributed_sketch": "select approx_percentile(l_extendedprice, 0.5) from lineitem",
    # not in the JAX test file: long-decimal limb planes, global and grouped
    "long_decimal": (
        "select approx_percentile(cast(l_extendedprice as decimal(30,2)), 0.5), "
        "approx_percentile(cast(l_extendedprice as decimal(30,2)) * 1000000, 0.9) "
        "from lineitem"
    ),
    "long_decimal_grouped": (
        "select l_returnflag, approx_percentile(cast(l_extendedprice as decimal(30,2)), 0.5), "
        "min_by(cast(l_extendedprice as decimal(30,2)), l_orderkey) from lineitem "
        "group by 1 order by 1"
    ),
}

#: the min_by/max_by statements of tests/test_collect_aggs.py (mmnan as VALUES)
_MMNAN = (
    "(values (1, 'a', 1.0e0), (1, 'b', cast('NaN' as double)), (2, 'c', 5.0e0), "
    "(3, 'd', cast('NaN' as double))) t(g, v, k)"
)
MINMAX = {
    "global": "select min_by(n_name, n_nationkey), max_by(n_name, n_nationkey) from nation",
    "grouped": (
        "select n_regionkey, min_by(n_name, n_nationkey) from nation group by 1 order by 1"
    ),
    "all_null_keys": "select min_by(n_name, n_nationkey) from nation where n_nationkey > 99",
    "numeric_value": (
        "select l_returnflag, max_by(l_extendedprice, l_orderkey) from lineitem "
        "group by 1 order by 1"
    ),
    "distributed": (
        "select l_returnflag, max_by(l_comment, l_extendedprice) from lineitem "
        "group by 1 order by 1"
    ),
    "nan_keys_max": f"select g, max_by(v, k) from {_MMNAN} group by 1 order by 1",
    "nan_keys_min": f"select g, min_by(v, k) from {_MMNAN} group by 1 order by 1",
    "n_form_global": (
        "select min_by(n_name, n_nationkey, 3), max_by(n_name, n_nationkey, 2) from nation"
    ),
    "n_form_grouped": (
        "select n_regionkey, min_by(n_name, n_nationkey, 2) from nation "
        "group by 1 order by 1 limit 2"
    ),
    "n_form_no_rows": (
        "select min_by(n_name, n_nationkey, 3) from nation where n_nationkey > 99"
    ),
    "n_form_distributed": (
        "select l_returnflag, max_by(l_comment, l_extendedprice, 2) from lineitem "
        "group by 1 order by 1"
    ),
    "null_values_and_keys": (
        "select g, min_by(v, k), max_by(v, k), min_by(v, k, 2), max_by(k, v) from (values "
        "(1, 'a', 3), (1, null, 1), (1, 'c', null), (2, null, null), (3, 'x', 2), "
        "(3, 'y', 2), (3, 'z', 5)) t(g, v, k) group by 1 order by 1"
    ),
}

#: (the JAX test's expected rows) for the cases that state them
MINMAX_ROWS = {
    "global": [("ALGERIA", "UNITED STATES")],
    "all_null_keys": [(None,)],
    "nan_keys_max": [(1, "b"), (2, "c"), (3, "d")],
    "nan_keys_min": [(1, "a"), (2, "c"), (3, "d")],
    "n_form_global": [(["ALGERIA", "ARGENTINA", "BRAZIL"], ["UNITED STATES", "UNITED KINGDOM"])],
    "n_form_grouped": [(0, ["ALGERIA", "ETHIOPIA"]), (1, ["ARGENTINA", "BRAZIL"])],
    "n_form_no_rows": [([],)],
}

#: statements the JAX mesh runs too (the mesh cases of both JAX test files)
MESH_CASES = ("distributed_sketch", "global_sketch", "grouped_exact", "distributed",
              "n_form_distributed", "grouped", "n_form_global")


@pytest.mark.parametrize("name", list(QDIGEST))
def test_qdigest_statements_match_jax(parity, name):
    rows = parity.check(QDIGEST[name], "local").rows
    from trino_tpu.testing import tpch_pandas

    li = tpch_pandas("tiny", "lineitem")
    if name == "global_sketch":
        exact = [li.l_quantity.quantile(0.5), li.l_quantity.quantile(0.9),
                 li.l_extendedprice.quantile(0.25), li.l_extendedprice.quantile(0.99)]
        for got, want in zip(rows[0], exact):
            # 1/64 per-bucket value resolution: ~2% worst case
            assert abs(float(got) - float(want)) / abs(float(want)) < 0.02
    elif name == "negative_and_double":
        assert abs(float(rows[0][0]) + 10.0) / 10.0 < 0.02
    elif name == "grouped_exact":
        for flag, value in rows:
            vals = np.sort(li[li.l_returnflag == flag].l_quantity.values)
            assert float(value) == float(vals[int(round(0.5 * (len(vals) - 1)))])


def test_sketch_state_is_mergeable_across_splits(parity):
    sql = QDIGEST["distributed_sketch"]
    one = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu", target_splits=1)
    many = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu", target_splits=7)
    many.execute("set session page_rows = 1024")  # many partial states to merge
    assert one.execute(sql).rows == many.execute(sql).rows == parity.expected(sql, "local").rows


@pytest.mark.parametrize("name", list(MINMAX))
def test_minmax_by_statements_match_jax(parity, name):
    rows = parity.check(MINMAX[name], "local").rows
    if name in MINMAX_ROWS:
        assert rows == MINMAX_ROWS[name]


@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_statements_match_jax_mesh(parity, name):
    sql = QDIGEST.get(name) or MINMAX[name]
    expected = parity.check(sql, "mesh")
    # the mesh agrees with the local runner too (no ties in these keys)
    assert_rows_match(expected.rows, parity.expected(sql, "local").rows,
                      result_order(parity.local.create_plan(sql)), float_rtol=1e-9)
    events = parity.mesh.last_stage_executor.counters
    if name in ("grouped_exact", "distributed", "n_form_distributed", "grouped"):
        # the group keys' repartition and one single-stage step per worker
        assert events.get("agg_single_stage") == 1 and "agg_partial_states" not in events
    elif name in ("distributed_sketch", "global_sketch"):
        # partial qdigest states per worker, merged on the coordinator
        assert events.get("agg_partial_states") == 1


@pytest.mark.parametrize("sql, match", [
    ("select min_by(n_name) from nation", "min_by requires 2"),
    ("select min_by(n_name, n_nationkey, 0) from nation", "positive integer literal"),
    ("select approx_percentile(n_nationkey, 0.5, 0.01) from nation", "exactly"),
])
def test_rejected_forms_raise_like_jax(parity, sql, match):
    with pytest.raises(Exception, match=match) as jerr:
        parity.jax.execute(sql)
    with pytest.raises(Exception, match=match) as terr:
        parity.local.execute(sql)
    assert type(terr.value).__name__ == type(jerr.value).__name__


@pytest.mark.parametrize("sql, match", [
    ("select min_by(l_orderkey, cast(l_extendedprice as decimal(30,2))) from lineitem",
     "long-decimal key"),
    ("select max_by(cast(l_extendedprice as decimal(30,2)), l_orderkey, 2) from lineitem",
     "long-decimal value"),
])
def test_long_decimal_minmax_by_forms_raise(parity, sql, match):
    """The JAX package reads limb planes as rows here and returns wrong
    rows (a min_by of 1, an array of zeros); the port raises by name."""
    parity.jax.execute(sql)
    with pytest.raises(NotImplementedError, match=match):
        parity.local.execute(sql)


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", ["H1", "H2", "H3"])
def test_chip_smoke_holistic_statements(parity, name, where):
    """chip_smoke.py's phase 5i statements at tiny; H1's min_by ties are
    held by chip_smoke's own witness check as well."""
    sql = chip_smoke.HOLISTIC_QUERIES[name]
    expected = parity.check(sql, where)
    assert expected.rows
    if name == "H2" and where == "mesh":
        events = parity.mesh.last_stage_executor.counters
        assert events.get("agg_single_stage") == 1 and "agg_partial_states" not in events


def test_chip_smoke_tie_witnesses(parity):
    """Every HOLISTIC_TIES witness query runs in the port, and admits the
    port's own rows and the JAX package's (which break ties in their own
    arrival order on the mesh)."""
    for name, (_, columns) in chip_smoke.HOLISTIC_TIES.items():
        rows = parity.local.execute(chip_smoke.HOLISTIC_QUERIES[name]).rows
        witness = {
            ("ties", name, col): parity.local.execute(
                chip_smoke.holistic_witness_sql(name, sql, rows)
            ).rows
            for col, _, _, sql in columns
        }
        masked = chip_smoke.mask_ties(name, rows, witness)
        assert masked == chip_smoke.mask_ties(
            name, parity.expected(chip_smoke.HOLISTIC_QUERIES[name], "mesh").rows, witness
        )
    assert chip_smoke.tie_admissible(2, "min", None, [(1, 2), (1, 3), (4, 5)])
    assert not chip_smoke.tie_admissible(5, "min", None, [(1, 2), (1, 3), (4, 5)])
    assert chip_smoke.tie_admissible([5, 2], "max", 2, [(1, 2), (1, 3), (4, 5)])
    assert not chip_smoke.tie_admissible([5], "max", 2, [(1, 2), (4, 5)])
    assert chip_smoke.tie_admissible(None, "max", None, [(None, 2)])


def test_grouped_holistic_takes_the_sorted_path(parity):
    sql = ("select l_suppkey, approx_percentile(l_quantity, 0.5), min_by(l_orderkey, l_shipdate) "
           "from lineitem group by l_suppkey order by l_suppkey limit 5")
    tagg.GROUP_PATHS.clear()
    parity.check(sql, "local")
    assert tagg.GROUP_PATHS == {"sorted": 1}  # never positional, never direct
    tagg.GROUP_PATHS.clear()
    parity.local.execute("select l_suppkey, count(*) from lineitem group by 1")
    assert "positional" in tagg.GROUP_PATHS  # the same keys, without one


@pytest.mark.parametrize("budget", [300_000, 150_000])
def test_budgeted_holistic_waves_like_jax(parity, budget):
    """Under `query_max_memory` a grouped holistic aggregation takes raw-input
    waves by group hash in both packages, as many, with the same rows."""
    sql = ("select o_custkey, approx_percentile(o_totalprice, 0.5), "
           "min_by(o_orderdate, o_totalprice), max_by(o_orderkey, o_orderdate, 2) "
           "from orders group by o_custkey")
    jax = JaxRunner(catalog="tpch", schema="tiny", target_splits=2)
    port = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    for r in (jax, port):
        r.execute("set session task_concurrency = 1")
        r.execute(f"set session query_max_memory = {budget}")
    j0 = jmetrics.memory_waves_counter().value(("aggregation",))
    expected = jax.execute(sql).rows
    jwaves = jmetrics.memory_waves_counter().value(("aggregation",)) - j0
    p0 = pmetrics.memory_waves_counter().value(("aggregation",))
    actual = port.execute(sql).rows
    pwaves = pmetrics.memory_waves_counter().value(("aggregation",)) - p0
    assert jwaves >= 2 and pwaves == jwaves
    assert len(expected) == 1000
    assert_rows_match(actual, expected, ResultOrder((), None))
    assert_rows_match(actual, parity.local.execute(sql).rows, ResultOrder((), None))

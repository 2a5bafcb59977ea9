"""The collect aggregates (array_agg with and without ORDER BY, map_agg,
listagg) and array_join in the port against the JAX package.

Module level: the aggregation operator of each package, single-stage and
non-streaming, over the same seeded numpy batch (a bigint group key with
NULLs, dead rows, a bigint argument with NULLs, a varchar argument coded in
one dictionary and a varchar map value coded in another): grouped and
global array_agg (input order, and ORDER BY a unique key ascending and
descending), map_agg and listagg; every output row must be equal, arrays
and maps element by element.  The two packages number groups by the same
stable sort, so even array_agg without ORDER BY gives the same element
order on one batch.

As SQL at tpch.tiny, through the JAX package's LocalQueryRunner and the
port's LocalQueryRunner and 4-worker mesh (where the fragmenter places a
collect aggregate in the coordinator fragment, over the gathered rows): the
array_agg, map_agg, listagg and array_join cases of
tests/test_collect_aggs.py (its memory-connector table as a VALUES
relation with the same rows, and in the JAX test's own memory-table form),
the rejected forms, which raise the same error in both, and the statements of
chip_smoke.py's phase 5g (U1-U7), which it runs at sf1 on the card.  Cases marked
order-free compare each array's elements as a sorted list: an array_agg
without ORDER BY has no defined element order, and the mesh gathers rows in
its own order.

Under `query_max_memory`, locally and on the mesh: a grouped collect
aggregate (raw-input waves, the input spilled to disk) and a grouped
aggregation over an UNNEST (state waves locally, the exchange's waves on
the mesh) must force waves and return the unbudgeted rows.

Tolerances: integers, decimals and strings exact; doubles relative 1e-9,
inside arrays too.
"""

import os

import numpy as np
import pytest

from trino_tpu import types as JT
from trino_tpu.ops.aggregation import AggregationOperator as JAgg, AggSpec as JSpec
from trino_tpu_torch import types as TT
from trino_tpu_torch.ops import aggregation as tagg
from trino_tpu_torch.ops.aggregation import AggregationOperator as TAgg, AggSpec as TSpec
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.telemetry import metrics as pmetrics
from trino_tpu_torch.testing import ResultOrder, assert_rows_match

import chip_smoke
from test_torch_arrays import Col, SqlParity, pair
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fte import no_spool_leaks  # noqa: F401 (autouse: private spool directory)


# -- the operator ---------------------------------------------------------------


def _collect_batch(seed: int, n: int = 96):
    rng = np.random.default_rng(seed)
    words, values = ["ant", "bee", "cat", "dog"], ["p", "q", "r"]
    cols = [
        Col(rng.integers(0, 6, n).astype(np.int64), JT.BIGINT, TT.BIGINT, rng.random(n) >= 0.1),
        Col(rng.integers(-99, 99, n).astype(np.int64), JT.BIGINT, TT.BIGINT, rng.random(n) >= 0.2),
        # a unique order key (a permutation): ORDER BY leaves no ties
        Col(rng.permutation(n).astype(np.int64), JT.BIGINT, TT.BIGINT),
        Col(rng.integers(0, 4, n).astype(np.int32), JT.VARCHAR, TT.VARCHAR,
            rng.random(n) >= 0.2, words),
        Col(rng.integers(0, 3, n).astype(np.int32), JT.VARCHAR, TT.VARCHAR, None, values),
    ]
    return pair(cols, rng.random(n) < 0.9)


def _specs(S, T):
    a_big, a_str = T.ArrayType(T.BIGINT), T.ArrayType(T.VARCHAR)
    return {
        "array_agg": S("array_agg", 1, a_big),
        "array_agg_strings": S("array_agg", 3, a_str),
        "array_agg_order_by": S("array_agg", 1, a_big, param=(True, False), arg2=2),
        "array_agg_order_by_desc": S("array_agg", 3, a_str, param=(False, False), arg2=2),
        "map_agg": S("map_agg", 2, T.MapType(T.BIGINT, T.VARCHAR), arg2=4),
        "map_agg_string_keys": S("map_agg", 4, T.MapType(T.VARCHAR, T.BIGINT), arg2=1),
        "listagg": S("listagg", 3, T.VARCHAR, param=("|", True, False), arg2=2),
    }


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("agg", list(_specs(TSpec, TT)))
@pytest.mark.parametrize("seed", [0, 1])
def test_collect_one_matches_jax(seed, agg, grouped):
    jb, tb = _collect_batch(seed)
    types_j = [c.type for c in jb.columns]
    types_t = [c.type for c in tb.columns]
    keys = [0] if grouped else []
    jop = JAgg(keys, [_specs(JSpec, JT)[agg]], types_j, mode="single", streaming=False)
    top = TAgg(keys, [_specs(TSpec, TT)[agg]], types_t, tb.device, mode="single")
    assert not top.streaming  # a collect aggregate keeps its raw batches
    (jout,) = list(jop.process(iter([jb])))
    before = len(tagg.COLLECT_LOG)
    (tout,) = list(top.process(iter([tb])))
    expected = jout.to_pylist()
    assert len(expected) == (6 if grouped else 1) + (1 if grouped else 0)  # + the NULL key
    assert_rows_match(tout.to_pylist(), expected, ResultOrder((), None))
    # one data-dependent width (one host read) per collect aggregate
    assert len(tagg.COLLECT_LOG) - before == 1


def test_collect_over_no_rows_matches_jax():
    jb, tb = _collect_batch(2, n=4)
    jb, tb = jb.filter(jb.mask() & False), tb.filter(tb.mask() & False)
    for name, spec in _specs(TSpec, TT).items():
        jop = JAgg([], [_specs(JSpec, JT)[name]], [c.type for c in jb.columns], streaming=False)
        top = TAgg([], [spec], [c.type for c in tb.columns], tb.device)
        assert list(top.process(iter([tb])))[0].to_pylist() == list(jop.process(iter([jb])))[0].to_pylist()


# -- SQL ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parity():
    return SqlParity()


#: name -> (sql, order-free arrays)
SQL = {
    "array_agg_global": (
        "select array_agg(n_nationkey) from nation where n_regionkey = 2", True,
    ),
    "array_agg_grouped": (
        "select n_regionkey, array_agg(n_nationkey) from nation "
        "group by n_regionkey order by n_regionkey", True,
    ),
    "array_agg_strings": ("select array_agg(r_name) from region", True),
    "array_agg_empty_group": ("select array_agg(x) from (select 1 x) where x > 5", False),
    "map_agg": (
        "select map_agg(n_nationkey, n_name) from nation where n_nationkey < 3", False,
    ),
    "map_agg_grouped": (
        "select n_regionkey, map_agg(n_nationkey, n_name) from nation "
        "where n_nationkey < 6 group by n_regionkey order by n_regionkey", False,
    ),
    "array_agg_skips_nulls": (
        "select array_agg(v) from (values (1, 10), (1, null), (1, 30)) t(g, v) group by g", True,
    ),
    "listagg_ordered": (
        "select listagg(r_name, ', ') within group (order by r_name) from region", False,
    ),
    "listagg_grouped": (
        "select n_regionkey, listagg(n_name, '|') within group (order by n_name) "
        "from nation where n_nationkey < 6 group by n_regionkey order by 1", False,
    ),
    "listagg_empty_is_null": (
        "select listagg(r_name) from region where r_regionkey > 99", False,
    ),
    "array_agg_order_by": (
        "select array_agg(n_name order by n_nationkey desc) from nation where n_regionkey = 1",
        False,
    ),
    "array_agg_order_by_grouped": (
        "select n_regionkey, array_agg(n_nationkey order by n_name desc) "
        "from nation group by 1 order by 1 limit 2", False,
    ),
    "array_join": (
        "select array_join(array[1,2,3], '-'), array_join(array['a','b'], ', '), "
        "array_join(array[1.5, 2.0], '|'), array_join(array[true, false], ','), "
        "array_join(cast(null as array(varchar)), ',')", False,
    ),
    "array_join_of_array_agg": (
        "select n_regionkey, array_join(array_agg(n_name order by n_name), ',') "
        "from nation where n_nationkey < 6 group by 1 order by 1", False,
    ),
    "array_join_temporal": (
        "select array_join(array[date '2024-01-01', date '2024-01-02'], ',')", False,
    ),
    # beside plain aggregates, over a join, and unnested again
    "collect_beside_plain_aggregates": (
        "select r_name, count(*), sum(n_nationkey), listagg(n_name, ',') within group "
        "(order by n_name), cardinality(map_agg(n_name, n_nationkey)) "
        "from nation join region on n_regionkey = r_regionkey group by r_name order by r_name",
        False,
    ),
}

#: forms the analyzer rejects: the same error, same message, in both
REJECTED = {
    "distinct_with_order_by": (
        "select array_agg(distinct n_regionkey order by n_nationkey) from nation",
        "DISTINCT with ORDER BY",
    ),
    "map_agg_order_by": (
        "select map_agg(n_nationkey, n_name order by n_name) from nation",
        "not supported for map_agg",
    ),
}


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_array_agg_skips_nulls_memory_table_form(where):
    """tests/test_collect_aggs.py's own form of the NULL-skipping case: the
    memory table memory.default.aa created and filled by INSERT in the JAX
    package and the port (test_torch_ddl.StatementPair, stored tables held
    equal), then array_agg over it; an array_agg without ORDER BY has no
    defined element order, so the arrays compare sorted."""
    from test_torch_ddl import StatementPair

    p = StatementPair(where=where)
    p.run_all([
        "create table memory.default.aa (g bigint, v bigint)",
        "insert into memory.default.aa values (1, 10), (1, null), (1, 30)",
    ])
    sql = "select array_agg(v) from memory.default.aa group by g"
    expected = p.jax.execute(sql).rows
    actual = p.port.execute(sql).rows
    assert [sorted(r[0]) for r in actual] == [sorted(r[0]) for r in expected] == [[10, 30]]


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(SQL))
def test_collect_sql_matches_jax(parity, name, where):
    sql, order_free = SQL[name]
    parity.check(sql, where, order_free_arrays=order_free)


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", sorted(chip_smoke.ARRAY_QUERIES))
def test_phase_5g_statements_match_jax_at_tiny(parity, name, where):
    """chip_smoke.py phase 5g's statements (U1-U7: the UNNESTs, the
    collect aggregates, split, and U6's transform/filter/reduce/map lookup)
    are forms the JAX package answers, and the port gives its rows at
    tiny, locally and on the mesh (U4's round trip and U3's reductions
    make the arrays' element order irrelevant)."""
    assert parity.check(chip_smoke.ARRAY_QUERIES[name], where)


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(REJECTED))
def test_rejected_forms_raise_as_in_jax(parity, name, where):
    sql, match = REJECTED[name]
    with pytest.raises(Exception, match=match) as jerr:
        parity.jax.execute(sql)
    with pytest.raises(Exception, match=match) as terr:
        parity.runner(where).execute(sql)
    assert type(terr.value).__name__ == type(jerr.value).__name__


# -- under a memory budget ---------------------------------------------------------

#: name -> (sql, session properties, operator that waves)
BUDGETED = {
    "collect_raw_waves_disk": (
        "select l_orderkey, array_agg(l_linenumber order by l_linenumber), "
        "listagg(l_shipmode, ',') within group (order by l_linenumber), "
        "map_agg(l_linenumber, l_quantity) from lineitem group by l_orderkey",
        dict(query_max_memory=600_000),
    ),
    "unnest_state_waves": (
        "select l_orderkey, sum(e), count(*) from lineitem "
        "cross join unnest(array[l_quantity, l_discount]) u(e) group by l_orderkey",
        dict(query_max_memory=150_000),
    ),
}


@pytest.fixture(scope="module")
def spill_dir(tmp_path_factory):
    from trino_tpu_torch import config

    d = tmp_path_factory.mktemp("port_collect_spill")
    config.install_config(config.load_cluster_config({"memory.spill-dir": str(d)}, {}))
    yield str(d)
    config.reset_config()


def _runner(where: str, props: dict):
    if where == "local":
        r = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    else:
        r = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
    for k, v in props.items():
        r.properties.set(k, v)
    return r


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(BUDGETED))
def test_budgeted_collect_and_unnest_match_unbudgeted(name, where, spill_dir):
    sql, props = BUDGETED[name]
    expected = _runner(where, {}).execute(sql)
    waves0 = pmetrics.memory_waves_counter().value(("aggregation",))
    spill0 = pmetrics.spill_bytes_counter().value()
    actual = _runner(where, props).execute(sql)
    waves = pmetrics.memory_waves_counter().value(("aggregation",)) - waves0
    if name.startswith("collect"):
        # the raw input crossed to the spill directory
        assert pmetrics.spill_bytes_counter().value() > spill0
    assert waves >= 2, "the budget forced no waves"
    pinned = props.get("memory_wave_partitions")
    assert pinned is None or waves == pinned
    assert len(expected.rows) == 15000
    assert_rows_match(actual.rows, expected.rows, ResultOrder((), None))
    assert os.listdir(spill_dir) == []


@pytest.mark.parametrize("breached", [False, True], ids=["under_budget", "over_budget"])
def test_raw_waves_pull_to_host_only_after_a_breach(breached, spill_dir, monkeypatch):
    """A collect aggregate under a budget it never breaches keeps its input
    where it is (no copy to the host); a breach pulls every batch."""
    from trino_tpu_torch.runtime import spill

    pulled = []
    original = spill.pull_host_async
    monkeypatch.setattr(spill, "pull_host_async",
                        lambda b, copies: pulled.append(b) or original(b, copies))
    sql = BUDGETED["collect_raw_waves_disk"][0]
    expected = _runner("local", {}).execute(sql)
    assert not pulled  # no budget, no raw-wave path
    actual = _runner("local", {"query_max_memory": 600_000 if breached else 1 << 40}).execute(sql)
    assert bool(pulled) == breached
    assert_rows_match(actual.rows, expected.rows, ResultOrder((), None))

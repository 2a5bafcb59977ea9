"""Queries under memory budgets through the port's LocalQueryRunner on the
CPU, against the JAX package's LocalQueryRunner under the same budgets at
tpch.tiny: the over-budget join in waves (spill to disk and in host RAM,
the wave count pinned and automatic), a LEFT join, and a join revoked
mid-probe by a shrinking pool limit; the grouped aggregation in state
waves, the partitioned window in waves and the external ORDER BY are in
tests/test_torch_spill_ops.py, with the helpers of this file.  The budgets are
the JAX package's own tests' (tests/test_spill.py, tests/test_memory.py).

Each case holds the port's rows to the JAX package's (integers, decimals,
dates and strings exact; doubles relative 1e-9; ORDER BY rows in order)
and its wave count per operator to the JAX package's (where the
aggregation picks k itself, from the bytes of the spilled group states,
too: an integer group key takes the range-positional path in both
packages, so the states have the same capacities); spill bytes appear
exactly when the JAX package spills; the spill directory is empty and no
revocable handle is live after every query; unbudgeted runs record zero
waves, zero spill and zero revocations.  The 4-worker mesh is in
tests/test_torch_spill_mesh.py.
"""

import os

import pytest

from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu.telemetry import metrics as jmetrics
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.runtime.spill import REVOCABLES
from trino_tpu_torch.telemetry import metrics as pmetrics

from test_torch_e2e import assert_same_rows
from test_torch_fte import no_spool_leaks  # noqa: F401 (autouse: private spool directory)

JOIN_SQL = (
    "select o_orderpriority, count(*) c from orders join lineitem "
    "on o_orderkey = l_orderkey group by o_orderpriority"
)
OUTER_JOIN_SQL = (
    "select count(*), count(l_orderkey) from orders left join "
    "(select l_orderkey from lineitem where l_quantity > 45) t "
    "on o_orderkey = l_orderkey"
)
AGG_SQL = (
    "select l_orderkey, count(*), sum(l_quantity) from lineitem group by l_orderkey"
)
WINDOW_SQL = (
    "select o_custkey, o_orderkey, "
    "row_number() over (partition by o_custkey order by o_orderdate, o_orderkey) rn, "
    "sum(o_totalprice) over (partition by o_custkey order by o_orderdate, o_orderkey) s "
    "from orders"
)
SORT_SQL = "select l_orderkey, l_comment from lineitem order by l_comment, l_orderkey"

#: name -> (sql, target_splits, session properties, ORDER BY rows in order);
#: the aggregation, window and ORDER BY cases are in
#: tests/test_torch_spill_ops.py
CASES = {
    "join_k2_disk": (JOIN_SQL, 2, dict(query_max_memory=200_000, memory_wave_partitions=2), False),
    "join_k2_ram": (
        JOIN_SQL, 2,
        dict(query_max_memory=200_000, spill_enabled=False, memory_wave_partitions=2), False,
    ),
    "join_auto_k": (JOIN_SQL, 2, dict(query_max_memory_bytes=200_000), False),
    "join_tight": (JOIN_SQL, 2, dict(query_max_memory_bytes=50_000), False),
    "left_join": (OUTER_JOIN_SQL, 2, dict(query_max_memory_bytes=300_000), False),
}

OPERATORS = ("join", "aggregation", "window", "sort")


def _snapshot(metrics) -> dict:
    out = {op: metrics.memory_waves_counter().value((op,)) for op in OPERATORS}
    out["spill"] = metrics.spill_bytes_counter().value()
    out["revocations"] = metrics.memory_revocations_counter().value()
    return out


def _delta(metrics, before: dict) -> dict:
    after = _snapshot(metrics)
    return {k: after[k] - before[k] for k in after}


def _runner(cls, target_splits: int, props: dict, **kw):
    r = cls(catalog="tpch", schema="tiny", target_splits=target_splits, **kw)
    for k, v in props.items():
        r.properties.set(k, v)
    return r


@pytest.fixture(scope="module")
def spill_dir(tmp_path_factory):
    """The port's spill directory (memory.spill-dir), checked empty after
    every query.  The JAX package's spills go to a directory of their own
    too: its default, a `trino_tpu_spool_*` temporary directory, is what
    tests/test_fte.py's leak check watches in the shared temp directory
    while other test files run beside it."""
    from trino_tpu import config as jconfig
    from trino_tpu_torch import config

    d = tmp_path_factory.mktemp("port_spill")
    config.install_config(config.load_cluster_config({"memory.spill-dir": str(d)}, {}))
    jmemory = jconfig.get_config().memory
    jdir = jmemory.spill_dir
    jmemory.spill_dir = str(tmp_path_factory.mktemp("jax_spill"))
    yield str(d)
    jmemory.spill_dir = jdir
    config.reset_config()


def _run_port(sql, target_splits, props, spill_dir):
    before = _snapshot(pmetrics)
    res = _run(LocalQueryRunner, sql, target_splits, props, device="cpu")
    assert os.listdir(spill_dir) == []
    assert not REVOCABLES.live()
    return res, _delta(pmetrics, before)


def _run(cls, sql, target_splits, props, **kw):
    return _runner(cls, target_splits, props, **kw).execute(sql)


def check_budgeted_query(case, spill_dir):
    """One budgeted query on both engines: the port's rows, wave counts per
    operator and spill against the JAX package's."""
    sql, splits, props, ordered = case
    jbefore = _snapshot(jmetrics)
    expected = _run(JaxRunner, sql, splits, props)
    jdelta = _delta(jmetrics, jbefore)
    actual, pdelta = _run_port(sql, splits, props, spill_dir)
    assert actual.column_names == expected.column_names
    assert_same_rows(actual.rows, expected.rows, ordered, float_rtol=1e-9)
    assert {op: pdelta[op] for op in OPERATORS} == {op: jdelta[op] for op in OPERATORS}
    assert sum(pdelta[op] for op in OPERATORS) > 0, "the budget forced no waves"
    assert (pdelta["spill"] > 0) == (jdelta["spill"] > 0)
    assert (pdelta["spill"] > 0) == (props.get("spill_enabled", True) is not False)
    assert pdelta["revocations"] == 0


def check_unbudgeted_query(sql, spill_dir):
    actual, pdelta = _run_port(sql, 2, {}, spill_dir)
    assert actual.rows
    assert all(v == 0 for v in pdelta.values()), pdelta


@pytest.mark.parametrize("name", list(CASES))
def test_budgeted_query_matches_jax(name, spill_dir):
    check_budgeted_query(CASES[name], spill_dir)


def test_unbudgeted_query_records_no_pressure(spill_dir):
    check_unbudgeted_query(JOIN_SQL, spill_dir)


def test_budget_through_set_session(spill_dir):
    r = LocalQueryRunner(catalog="tpch", schema="tiny", target_splits=2, device="cpu")
    r.execute("set session query_max_memory = 200000")
    r.execute("set session memory_wave_partitions = 4")
    before = _snapshot(pmetrics)
    rows = sorted(r.execute(JOIN_SQL).rows)
    assert _delta(pmetrics, before)["join"] == 4
    assert rows == sorted(_run(JaxRunner, JOIN_SQL, 2, {}).rows)


def test_revocation_mid_query_finishes_in_waves(spill_dir):
    """A running join's build is revoked mid-probe: the pool limit shrinks
    under it after the first probe batch, the aggregation above the join
    trips the escalation on its next reservation, and the revoke tier asks
    the build to spill.  The probe's remainder finishes in waves, the rows
    equal the JAX package's, and no handle stays live."""
    from trino_tpu_torch.ops.join import HashJoinOperator
    from trino_tpu_torch.runtime.lifecycle import set_memory_pool_limit

    expected = sorted(_run(JaxRunner, JOIN_SQL, 2, {}).rows)
    calls = []
    orig = HashJoinOperator._join_batch

    def tripping(self, pb):
        out = orig(self, pb)
        if not calls:
            set_memory_pool_limit(300_000)
        calls.append(1)
        return out

    HashJoinOperator._join_batch = tripping
    try:
        actual, pdelta = _run_port(JOIN_SQL, 2, dict(memory_wave_partitions=2), spill_dir)
    finally:
        HashJoinOperator._join_batch = orig
        set_memory_pool_limit(0)
    assert sorted(actual.rows) == expected
    assert pdelta["revocations"] >= 1
    assert pdelta["join"] == 2
    assert pdelta["spill"] > 0

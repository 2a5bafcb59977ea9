"""The port's semi join and nested-loop (cross) join against the JAX package.

  * `SemiJoinOperator` on the same seeded numpy inputs in both packages:
    the mark column's values and validity bit for bit, null-aware (IN) and
    not (EXISTS), with NULL keys in the probe and in the build, an empty
    build, a wide key domain (the sorted search, not the direct-address
    table) and a residual (correlated EXISTS through each package's
    expression compiler);
  * `NestedLoopJoinOperator` over an empty build, one row and several rows;
  * TPC-H Q4, Q11, Q12, Q18, Q19 and Q21 through the port's
    LocalQueryRunner(device="cpu") against the JAX LocalQueryRunner at
    tpch.tiny, and Q4, Q18 and Q21 on the port's 4-worker mesh against the
    JAX mesh under default knobs, `pallas_probe = true` and partitioned
    joins (the kernel path runs under `pallas_probe` only, as for the
    join), plus Q21 at W = 3, where the residual semi join marks per shard
    over the connector's aligned splits, and a correlated EXISTS over a
    source a partitioned join has moved, where both sides are hash-placed
    on the key first.  Integers, decimals, dates and strings exact and in
    order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.expr import ExprCompiler as JCompiler
from trino_tpu.expr import ir as jir
from trino_tpu.ops import join as jjoin
from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.expr import ExprCompiler as TCompiler
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.ops import join as tjoin
from trino_tpu_torch.ops import locate_sorted as ls
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

_TYPES = {"bigint": (JT.BIGINT, TT.BIGINT), "integer": (JT.INTEGER, TT.INTEGER)}


def _both(cols, mask):
    """(JAX Batch, port Batch) over the same numpy columns:
    cols = [(type name, data, valid or None)]."""
    jcols, tcols = [], []
    for tname, data, valid in cols:
        jt, tt = _TYPES[tname]
        jcols.append(JColumn(jnp.asarray(data), jt, None if valid is None else jnp.asarray(valid)))
        tcols.append(TColumn(torch.from_numpy(np.ascontiguousarray(data)), tt,
                             None if valid is None else torch.from_numpy(valid)))
    return JBatch(jcols, jnp.asarray(mask)), TBatch(tcols, torch.from_numpy(mask))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert str(t.numpy().dtype) == str(np.asarray(j).dtype)


def _batch_eq(tb, jb):
    assert tb.width == jb.width
    for tc, jc in zip(tb.columns, jb.columns):
        _eq(tc.data, jc.data)
        assert (tc.valid is None) == (jc.valid is None)
        if tc.valid is not None:
            _eq(tc.valid, jc.valid)
    _eq(tb.mask(), jb.mask())


def _side(rng, n, domain, null_rate):
    """A (key, payload) side: keys in [0, domain) with NULLs, dead rows."""
    key = rng.integers(0, domain, n).astype(np.int64)
    valid = rng.random(n) >= null_rate
    pay = rng.integers(0, 5, n).astype(np.int64)
    mask = rng.random(n) < 0.85
    return [("bigint", key, valid), ("bigint", pay, None)], mask


#: name -> (build rows, key domain, build NULL rate, probe NULL rate)
SEMI_CASES = {
    "no_nulls": (200, 64, 0.0, 0.0),
    "probe_nulls": (200, 64, 0.0, 0.2),
    "build_nulls": (200, 64, 0.1, 0.0),
    "both_nulls": (200, 64, 0.1, 0.2),
    "empty_build": (0, 64, 0.0, 0.2),
    "wide_domain": (300, 1 << 40, 0.05, 0.1),
}


def _residual_pair():
    """probe.payload <> filtering.payload (Q21's l_suppkey shape), compiled
    by each package's own expression compiler over probe ++ build."""
    je = jir.comparison("<>", jir.InputRef(1, JT.BIGINT), jir.InputRef(3, JT.BIGINT))
    te = tir.comparison("<>", tir.InputRef(1, TT.BIGINT), tir.InputRef(3, TT.BIGINT))
    return (
        lambda b, _e=je: JCompiler(b).filter_mask(_e),
        lambda b, _e=te: TCompiler(b).filter_mask(_e),
    )


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("null_aware", [True, False], ids=["in", "exists"])
@pytest.mark.parametrize("case", list(SEMI_CASES))
def test_semi_join_marks_bit_exact(case, null_aware, residual):
    n_build, domain, bnull, pnull = SEMI_CASES[case]
    rng = np.random.default_rng(list(SEMI_CASES).index(case))
    bcols, bmask = _side(rng, max(n_build, 1), domain, bnull)
    pcols, pmask = _side(rng, 512, domain, pnull)
    if domain > 1024:  # probe keys drawn from the build keys, and misses
        pcols[0][1][::2] = bcols[0][1][rng.integers(0, n_build, 256)]
    jb, tb = _both(bcols, bmask)
    jp, tp = _both(pcols, pmask)
    jres = tres = None
    if residual:
        jres, tres = _residual_pair()
    jop = jjoin.SemiJoinOperator(0, 0, [JT.BIGINT] * 2, null_aware=null_aware, residual=jres)
    top = tjoin.SemiJoinOperator(0, 0, [TT.BIGINT] * 2, null_aware=null_aware, residual=tres)
    jop.set_build([jb] if n_build else [])
    top.set_build([tb] if n_build else [], "cpu")
    assert top._filter_has_null == jop._filter_has_null
    assert top._n_match == jop._n_match
    if case == "wide_domain":  # the sorted search, not the direct table
        assert top._table is None and jop._table is None
    (jout,) = list(jop.process(iter([jp])))
    (tout,) = list(top.process(iter([tp])))
    _batch_eq(tout, jout)
    mark = tout.columns[-1]
    if case == "both_nulls" and null_aware:
        # NULL marks: a NULL key, or a miss while the build holds a NULL
        assert not bool(mark.valid[tp.mask()].all())
    if case == "empty_build":
        assert not bool(mark.data.any())


@pytest.mark.parametrize("n_build", [0, 1, 5])
def test_nested_loop_join_bit_exact(n_build):
    rng = np.random.default_rng(50 + n_build)
    bcols, bmask = _side(rng, max(n_build, 1), 10, 0.2)
    bmask[:] = True
    pcols, pmask = _side(rng, 300, 10, 0.2)
    jb, tb = _both(bcols, bmask)
    jp, tp = _both(pcols, pmask)
    jop = jjoin.NestedLoopJoinOperator([JT.BIGINT] * 2)
    top = tjoin.NestedLoopJoinOperator([TT.BIGINT] * 2)
    jop.set_build([jb] if n_build else [])
    top.set_build([tb] if n_build else [], "cpu")
    jout = list(jop.process(iter([jp, jp])))
    tout = list(top.process(iter([tp, tp])))
    assert len(tout) == len(jout) == (2 if n_build else 0)
    for t, j in zip(tout, jout):
        _batch_eq(t, j)
        assert t.num_rows_host() == int(pmask.sum()) * n_build


# -- end to end through the local runner ---------------------------------------

LOCAL_QIDS = [4, 11, 12, 18, 19, 21]


@pytest.fixture(scope="module")
def runners():
    return (
        JaxRunner(catalog="tpch", schema="tiny"),
        LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    )


def _same_rows(actual, expected) -> None:
    """Exact values and Python types (Decimal scale included, through
    repr), in order: every query's ORDER BY gives one order here."""
    assert [repr(tuple(r)) for r in actual] == [repr(tuple(r)) for r in expected]


@pytest.mark.parametrize("qid", LOCAL_QIDS)
def test_local_tpch_queries_match_jax(runners, qid):
    jax_runner, port_runner = runners
    expected = jax_runner.execute(QUERIES[qid])
    actual = port_runner.execute(QUERIES[qid])
    assert actual.column_names == expected.column_names
    assert len(expected.rows) > 0
    _same_rows(actual.rows, expected.rows)


# -- end to end on the mesh ----------------------------------------------------

MESH_QIDS = [4, 18, 21]


def _run_both(jax_mesh, port_mesh, sql, settings):
    for s in settings:
        jax_mesh.execute("set session " + s)
        port_mesh.execute("set session " + s)
    try:
        return jax_mesh.execute(sql), port_mesh.execute(sql)
    finally:
        for s in ("pallas_probe = false", "join_distribution_type = 'AUTOMATIC'"):
            jax_mesh.execute("set session " + s)
            port_mesh.execute("set session " + s)


@pytest.fixture(scope="module")
def meshes():
    return (
        JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=4),
        DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu"),
    )


@pytest.mark.parametrize(
    "settings",
    [[], ["pallas_probe = true"],
     ["join_distribution_type = 'PARTITIONED'", "pallas_probe = true"]],
    ids=["default", "pallas_probe", "partitioned_pallas_probe"],
)
@pytest.mark.parametrize("qid", MESH_QIDS)
def test_mesh_semi_join_queries_match_jax(meshes, qid, settings):
    jax_mesh, port_mesh = meshes
    before = ls.locate_sorted_reference.launches
    expected, actual = _run_both(jax_mesh, port_mesh, QUERIES[qid], settings)
    assert actual.column_names == expected.column_names
    assert len(expected.rows) > 0
    _same_rows(actual.rows, expected.rows)
    ran_kernel_path = ls.locate_sorted_reference.launches - before
    if "pallas_probe = true" in settings:
        assert ran_kernel_path > 0
    else:
        assert ran_kernel_path == 0
    counters = port_mesh.last_stage_executor.counters
    if qid in (4, 18):  # IN / EXISTS without a residual: a broadcast build
        assert counters.get("broadcast", 0) >= 1
    if qid == 21 and settings and "PARTITIONED" in settings[0]:
        # moved sides: the residual semi joins hash-place both inputs
        assert counters.get("repartition_collective", 0) >= 4


def test_mesh_q21_three_workers_matches_jax():
    jax_mesh = JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=3)
    port_mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=3, device="cpu")
    expected, actual = _run_both(jax_mesh, port_mesh, QUERIES[21], [])
    assert len(expected.rows) > 0
    _same_rows(actual.rows, expected.rows)
    # l1's l_orderkey reaches the residual semi joins as a broadcast join's
    # build column (lineitem joined onto the orders splits), so it is off
    # lineitem's split alignment: the first semi join hash-places both of
    # its sides on the key, the second its filtering side (its source is
    # placed already).  The JAX package marks per shard regardless, which
    # loses matches when the splits do not line up (TPC-DS q94).
    counters = port_mesh.last_stage_executor.counters
    assert counters.get("repartition_collective") == 3
    assert counters.get("exchange_elided", 0) >= 1


#: a correlated EXISTS whose source was hash-placed on other keys (a
#: partitioned join on partkey/suppkey): no side is placed on the semi
#: join's key, but the source has moved off the aligned splits, so both
#: sides must be hash-placed on it before the per-shard marking
MOVED_SOURCE_EXISTS = """select l1.l_returnflag, count(*) from lineitem l1 join partsupp
on l1.l_partkey = ps_partkey and l1.l_suppkey = ps_suppkey
where exists (select * from lineitem l2 where l2.l_orderkey = l1.l_orderkey
and l2.l_suppkey <> l1.l_suppkey) group by 1 order by 1"""


def test_mesh_residual_semi_join_over_a_moved_source_matches_jax(meshes):
    jax_mesh, port_mesh = meshes
    expected, actual = _run_both(
        jax_mesh, port_mesh, MOVED_SOURCE_EXISTS, ["join_distribution_type = 'PARTITIONED'"]
    )
    assert len(expected.rows) > 0
    _same_rows(actual.rows, expected.rows)
    # the join's two sides, then both semi-join sides
    assert port_mesh.last_stage_executor.counters.get("repartition_collective") == 4


def test_mesh_cross_join_runs_on_the_coordinator(meshes):
    """Q11's scalar-subquery cross join: the coordinator's local engine runs
    the nested loop over the gathered sides."""
    jax_mesh, port_mesh = meshes
    expected, actual = _run_both(jax_mesh, port_mesh, QUERIES[11], [])
    assert len(expected.rows) > 0
    _same_rows(actual.rows, expected.rows)

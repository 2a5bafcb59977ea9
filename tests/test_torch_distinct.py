"""DISTINCT aggregates, aggregate FILTER clauses and MarkDistinct in the port
against the JAX package.

  * `MarkDistinctOperator` on the same seeded numpy batch in both packages
    (bigint and dictionary-coded varchar keys with NULLs, dead rows, one and
    two key columns): the mark column bit for bit;
  * SQL through both LocalQueryRunners at tpch.tiny and over VALUES rows
    with NULLs: count(distinct) with and without group keys, uniform
    DISTINCT sets (the dedupe pre-aggregation), mixed DISTINCT sets and
    DISTINCT beside plain aggregates (the optimizer's MarkDistinct plus
    FILTERed aggregates), FILTER over NULLs, count(*) FILTER;
  * the same statements on the port's 4-worker mesh against the JAX mesh
    (uniform DISTINCT repartitions the raw rows on the group keys and
    dedupes per worker; a MarkDistinct marks per worker over a source
    placed on its keys), and a few on a 3-worker mesh, where the exchange
    hash's unsigned remainder decides the placement.

Integers, decimals and strings exact; doubles relative 1e-9.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar import StringDictionary as JDict
from trino_tpu.ops.aggregation import MarkDistinctOperator as JMark
from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.columnar import StringDictionary as TDict
from trino_tpu_torch.ops.aggregation import MarkDistinctOperator as TMark
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows


def _mark_batches(seed: int, n: int):
    rng = np.random.default_rng(seed)
    words = ["x", "y", "zz", ""]
    k1 = rng.integers(0, 6, n).astype(np.int64)
    v1 = rng.random(n) >= 0.2
    k2 = rng.integers(0, len(words), n).astype(np.int32)
    v2 = rng.random(n) >= 0.2
    k1[~v1] = 0
    k2[~v2] = 77  # a NULL row's code lies outside the dictionary
    mask = rng.random(n) < 0.8
    jd, td = JDict(sorted(words)), TDict(sorted(words))
    jb = JBatch(
        [JColumn(jnp.asarray(k1), JT.BIGINT, jnp.asarray(v1)),
         JColumn(jnp.asarray(k2), JT.VARCHAR, jnp.asarray(v2), jd)],
        jnp.asarray(mask),
    )
    tb = TBatch(
        [TColumn(torch.from_numpy(k1), TT.BIGINT, torch.from_numpy(v1)),
         TColumn(torch.from_numpy(k2), TT.VARCHAR, torch.from_numpy(v2), td)],
        torch.from_numpy(mask),
    )
    return jb, tb


@pytest.mark.parametrize("keys", [[0], [1], [0, 1]], ids=["bigint", "varchar", "both"])
@pytest.mark.parametrize("n", [1, 100, 256])
def test_mark_distinct_bit_exact(keys, n):
    jb, tb = _mark_batches(seed=n + len(keys), n=n)
    (jout,) = list(JMark(keys).process(iter([jb])))
    (tout,) = list(TMark(keys).process(iter([tb])))
    assert tout.width == jout.width == 3
    np.testing.assert_array_equal(tout.columns[2].data.numpy(), np.asarray(jout.columns[2].data))
    np.testing.assert_array_equal(tout.mask().numpy(), np.asarray(jout.mask()))
    # one mark per distinct live key combination, NULL keys grouping together
    live = tout.mask()[:n]
    seen = {
        tuple(
            (bool(tb.columns[c].valid[k]), int(tb.columns[c].data[k]))
            for c in keys
        )
        for k in range(n)
        if live[k]
    }
    assert int(tout.columns[2].data[tout.mask()].sum()) == len(seen)


NULLS = (
    "(values ('a', 1, 10), ('a', 1, null), ('a', null, 20), ('b', 2, 20), "
    "('b', 2, 20), (null, 3, null), (null, 3, 30), ('c', null, null)) t(k, v, w)"
)

SQL = {
    "count_distinct_global": "select count(distinct o_custkey) from orders",
    "count_distinct_grouped": "select o_orderpriority, count(distinct o_custkey) "
                              "from orders group by 1 order by 1",
    "uniform_distinct_set": "select o_orderstatus, count(distinct o_clerk), "
                            "min(distinct o_clerk), max(distinct o_clerk) "
                            "from orders group by 1 order by 1",
    "sum_avg_distinct": "select l_returnflag, sum(distinct l_quantity), "
                        "avg(distinct l_quantity) from lineitem group by 1 order by 1",
    "mixed_distinct_sets": "select o_orderstatus, count(distinct o_custkey), "
                           "count(distinct o_orderpriority), count(*) "
                           "from orders group by 1 order by 1",
    "distinct_beside_plain": "select o_orderpriority, count(distinct o_custkey), "
                             "sum(o_totalprice), max(o_orderdate) "
                             "from orders group by 1 order by 1",
    "mixed_global": "select count(distinct l_suppkey), count(distinct l_partkey), "
                    "sum(l_quantity) from lineitem",
    "filter_over_nulls": f"select k, count(*) filter (where w is null), "
                         f"count(v) filter (where w > 10), sum(w) filter (where v is not null), "
                         f"min(w) filter (where k = 'a') from {NULLS} group by k",
    "distinct_over_nulls": f"select k, count(distinct v), count(distinct w), count(*) "
                           f"from {NULLS} group by k",
    "uniform_distinct_nulls": f"select k, count(distinct w), sum(distinct w) from {NULLS} group by k",
    "count_star_filter": "select o_orderstatus, count(*) filter (where o_totalprice > 150000), "
                         "avg(o_totalprice) filter (where o_orderpriority like '2%') "
                         "from orders group by 1 order by 1",
}

#: statements whose groups may come back in any order
UNORDERED = {"filter_over_nulls", "distinct_over_nulls", "uniform_distinct_nulls"}


def _check(expected, actual, name):
    assert actual.column_names == expected.column_names
    assert [t.name for t in actual.types] == [t.name for t in expected.types]
    assert len(expected.rows) > 0
    assert_same_rows(actual.rows, expected.rows, ordered=name not in UNORDERED, float_rtol=1e-9)


@pytest.fixture(scope="module")
def runners():
    return (
        JaxRunner(catalog="tpch", schema="tiny"),
        LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    )


@pytest.mark.parametrize("name", list(SQL))
def test_local_distinct_and_filter_match_jax(runners, name):
    jax_runner, port_runner = runners
    _check(jax_runner.execute(SQL[name]), port_runner.execute(SQL[name]), name)


@pytest.fixture(scope="module")
def meshes():
    return (
        JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=4),
        DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu"),
    )


@pytest.mark.parametrize("name", list(SQL))
def test_mesh_distinct_and_filter_match_jax(meshes, name):
    jax_mesh, port_mesh = meshes
    _check(jax_mesh.execute(SQL[name]), port_mesh.execute(SQL[name]), name)
    if name in ("count_distinct_grouped", "uniform_distinct_set", "sum_avg_distinct"):
        # the raw rows moved to the workers that own their groups
        assert port_mesh.last_stage_executor.counters.get("repartition_collective", 0) >= 1


@pytest.mark.parametrize(
    "name", ["count_distinct_grouped", "mixed_distinct_sets", "uniform_distinct_nulls"]
)
def test_three_worker_mesh_distinct_matches_jax(name):
    jax_mesh = JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=3)
    port_mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=3, device="cpu")
    _check(jax_mesh.execute(SQL[name]), port_mesh.execute(SQL[name]), name)

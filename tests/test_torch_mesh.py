"""The port's mesh of logical workers (trino_tpu_torch/parallel/) against the
JAX package's device mesh (8 XLA host devices in the test process, the
first W of them used).

  * exchange: the row hash and its destination `h % W` bit-equal to the
    JAX `_hash_rows` for W in {1, 3, 4, 8} (3 is not a power of two, where
    an int64 floor-mod would differ from the unsigned remainder), with NULL,
    boolean, int32 and long-decimal keys; `repartition` and `broadcast` of a
    4-worker stack give every worker the JAX package's rows in the same
    order (the all-to-all is source-major);
  * fragmenter: the port's EXPLAIN (TYPE DISTRIBUTED) text for TPC-H Q3 and
    Q5 at W = 4 equals the JAX package's, at tiny and at sf1, and the
    port's `check_subplan` and `check_collective_uniformity` accept them;
  * end to end at tpch.tiny: the port's DistributedQueryRunner(n_workers=4,
    device="cpu") against the JAX DistributedQueryRunner(n_workers=4) on Q3
    and Q5 with `pallas_probe` off and on (on, the sorted-probe kernel's
    plain version runs), and with partitioned joins forced, plus Q1, Q6,
    Q10, LIMIT, ORDER BY and a join count; integers, decimals, dates and
    strings exact and in order (the ORDER BY keys are unique; the LIMIT
    without ORDER BY takes the same rows in both packages because the
    workers' row order is the same).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
from trino_tpu.parallel import exchange as jex
from trino_tpu.parallel.spmd import WorkerMesh as JaxMesh
from trino_tpu.parallel.spmd import stack_batches as jax_stack
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.ops import locate_sorted as ls
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.parallel import exchange as tex
from trino_tpu_torch.parallel.spmd import WorkerMesh, shard, stack_batches

from test_torch_e2e import assert_same_rows
from test_torch_observatory import assert_same_ledger, attach_stores

W = 4

_TYPES = {
    "bigint": (JT.BIGINT, TT.BIGINT),
    "integer": (JT.INTEGER, TT.INTEGER),
    "boolean": (JT.BOOLEAN, TT.BOOLEAN),
    "decimal30": (JT.DecimalType(30, 2), TT.DecimalType(30, 2)),
}


def _key_columns(rng, n):
    """[(type name, data, valid)] covering every hashed key form."""
    i64 = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)
    return [
        ("bigint", i64, rng.random(n) < 0.9),
        ("integer", rng.integers(-50, 50, n).astype(np.int32), None),
        ("boolean", rng.random(n) < 0.5, rng.random(n) < 0.8),
        ("decimal30", np.stack([rng.integers(-3, 3, n), i64[::-1].copy()], axis=-1), None),
    ]


def _jax_batch(cols, mask):
    return JBatch(
        [JColumn(jnp.asarray(d), _TYPES[t][0], None if v is None else jnp.asarray(v))
         for t, d, v in cols],
        jnp.asarray(mask),
    )


def _port_batch(cols, mask):
    return TBatch(
        [TColumn(torch.from_numpy(np.ascontiguousarray(d)), _TYPES[t][1],
                 None if v is None else torch.from_numpy(v)) for t, d, v in cols],
        torch.from_numpy(mask),
    )


@pytest.mark.parametrize("chans", [(0,), (1,), (2,), (3,), (0, 1, 2, 3)])
def test_row_hash_bit_equal(chans):
    rng = np.random.default_rng(sum(chans) + 10 * len(chans))
    cols = _key_columns(rng, 4096)
    mask = np.ones(4096, bool)
    jh = np.asarray(jex._hash_rows(_jax_batch(cols, mask), list(chans)))
    th = tex._hash_rows(_port_batch(cols, mask), list(chans)).numpy()
    np.testing.assert_array_equal(th.view(np.uint64), jh)


@pytest.mark.parametrize("n_workers", [1, 3, 4, 8])
def test_destinations_bit_equal(n_workers):
    rng = np.random.default_rng(n_workers)
    cols = _key_columns(rng, 4096)
    mask = np.ones(4096, bool)
    chans = [0, 1, 2, 3]
    jh = jex._hash_rows(_jax_batch(cols, mask), chans)
    want = np.asarray((jh % jnp.uint64(n_workers)).astype(jnp.int64))
    got = tex.unsigned_mod(tex._hash_rows(_port_batch(cols, mask), chans), n_workers)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != (np.asarray(jh).view(np.int64) % n_workers)).any() or n_workers in (1, 4, 8)


def _worker_batches(seed):
    """One host batch per worker, of different lengths, with dead rows."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(W):
        n = 300 + 97 * w
        cols = _key_columns(rng, n)
        mask = rng.random(n) < 0.8
        out.append((cols, mask))
    return out


def _jax_rows(stacked):
    return [np.asarray(c.data) for c in stacked.columns], [
        None if c.valid is None else np.asarray(c.valid) for c in stacked.columns
    ], np.asarray(stacked.mask())


def _assert_stacked_equal(tb, jb):
    jd, jv, jm = _jax_rows(jb)
    for c, d, v in zip(tb.columns, jd, jv):
        np.testing.assert_array_equal(c.data.numpy(), d)
        assert (c.valid is None) == (v is None)
        if v is not None:
            np.testing.assert_array_equal(c.valid.numpy(), v)
    np.testing.assert_array_equal(tb.mask().numpy(), jm)


@pytest.mark.parametrize("chans", [(0,), (1, 2), (3,)])
def test_repartition_matches_jax(chans):
    parts = _worker_batches(len(chans) + sum(chans))
    jwm = JaxMesh(n_workers=W)
    twm = WorkerMesh(W, "cpu")
    jst = jax_stack([_jax_batch(c, m) for c, m in parts], jwm)
    tst = stack_batches([_port_batch(c, m) for c, m in parts], twm)
    _assert_stacked_equal(tst, jst)
    jslot = jex.exchange_slot_cap(jst, list(chans), jwm)
    assert tex.exchange_slot_cap(tst, list(chans), twm) == jslot
    jout = jex.repartition(jst, list(chans), jwm)
    tout = tex.repartition(tst, list(chans), twm)
    _assert_stacked_equal(tout, jout)
    # every live row landed on the worker its hash names
    for w in range(W):
        b = shard(tout, w)
        dest = tex.unsigned_mod(tex._hash_rows(b, list(chans)), W)
        assert bool((dest[b.mask()] == w).all())


def test_broadcast_matches_jax():
    parts = _worker_batches(99)
    jwm = JaxMesh(n_workers=W)
    twm = WorkerMesh(W, "cpu")
    jst = jax_stack([_jax_batch(c, m) for c, m in parts], jwm)
    tst = stack_batches([_port_batch(c, m) for c, m in parts], twm)
    _assert_stacked_equal(tex.broadcast(tst, twm), jex.broadcast(jst, jwm))


# -- fragmenter ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh():
    return JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=W)


@pytest.mark.parametrize("schema", ["tiny", "sf1"])
@pytest.mark.parametrize("qid", [3, 5])
def test_fragments_match_jax(qid, schema):
    from trino_tpu_torch.verify import check_subplan
    from trino_tpu_torch.verify.collectives import check_collective_uniformity

    jr = JaxMeshRunner(catalog="tpch", schema=schema, n_workers=W)
    tr = DistributedQueryRunner(catalog="tpch", schema=schema, n_workers=W, device="cpu")
    assert tr.explain_distributed(QUERIES[qid]) == jr.explain_distributed(QUERIES[qid])
    sub = tr.create_subplan(tr.create_plan(QUERIES[qid]))
    assert check_subplan(sub) == []
    assert check_collective_uniformity(sub) == []


# -- end to end ------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_mesh():
    return DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=W, device="cpu")


def _run_both(jax_mesh, port_mesh, sql, settings):
    for s in settings:
        jax_mesh.execute("set session " + s)
        port_mesh.execute("set session " + s)
    attach_stores(jax_mesh, port_mesh)
    try:
        expected, actual = jax_mesh.execute(sql), port_mesh.execute(sql)
        # and the decision ledgers (tests/test_torch_observatory.py)
        assert_same_ledger(jax_mesh, port_mesh, sql)
        return expected, actual
    finally:
        for s in ("pallas_probe = false", "join_distribution_type = 'AUTOMATIC'"):
            jax_mesh.execute("set session " + s)
            port_mesh.execute("set session " + s)


@pytest.mark.parametrize(
    "settings",
    [[], ["pallas_probe = true"],
     ["join_distribution_type = 'PARTITIONED'", "pallas_probe = true"]],
    ids=["default", "pallas_probe", "partitioned_pallas_probe"],
)
@pytest.mark.parametrize("qid", [3, 5])
def test_mesh_queries_match_jax(jax_mesh, port_mesh, qid, settings):
    before = ls.locate_sorted_reference.launches
    expected, actual = _run_both(jax_mesh, port_mesh, QUERIES[qid], settings)
    assert actual.column_names == expected.column_names
    assert len(expected.rows) > 0
    # exact values and Python types, in order (the ORDER BY keys are unique)
    assert_same_rows(actual.rows, expected.rows, ordered=True, float_rtol=1e-9)
    ran_kernel_path = ls.locate_sorted_reference.launches - before
    if "pallas_probe = true" in settings:
        assert ran_kernel_path > 0
    else:
        assert ran_kernel_path == 0


#: other fragment shapes on the mesh: grouped aggregation over dictionary
#: keys (Q1), a global aggregation gathered as partial states (Q6), a
#: three-join TopN (Q10), a per-worker LIMIT, a merge-exchange ORDER BY and
#: a global count over a join
MORE_SHAPES = {
    "q1": QUERIES[1],
    "q6": QUERIES[6],
    "q10": QUERIES[10],
    "limit": "select o_orderkey, o_totalprice from orders where o_totalprice > 100000 limit 5",
    "order_by": "select n_name, n_regionkey from nation order by n_regionkey, n_name",
    "join_count": (
        "select count(*) from lineitem join orders on l_orderkey = o_orderkey "
        "where o_orderstatus = 'F'"
    ),
}


@pytest.mark.parametrize("name", list(MORE_SHAPES))
def test_more_mesh_shapes_match_jax(jax_mesh, port_mesh, name):
    expected, actual = _run_both(jax_mesh, port_mesh, MORE_SHAPES[name], [])
    assert_same_rows(actual.rows, expected.rows, ordered=True, float_rtol=1e-9)


def test_mesh_runner_matches_local_runner(port_mesh):
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    sql = (
        "select c_custkey, count(o_orderkey) from customer left join orders "
        "on c_custkey = o_custkey group by c_custkey order by 2 desc, 1 limit 7"
    )
    assert port_mesh.execute(sql).rows == local.execute(sql).rows


@pytest.mark.parametrize(
    "setting",
    ["fault_tolerant_execution = true", "retry_policy = 'TASK'",
     "query_max_memory = 1000000",
     "table_layouts = 'tpch.tiny.orders:o_orderkey:8'"],
)
def test_unported_mesh_settings_raise(setting):
    """The mesh settings that once raised by name run now: the memory
    budget's path (partition waves), bucketed layouts (co-located scans)
    and fault-tolerant execution (spooled stage outputs, task retries).
    Each case runs Q3 and holds the rows to the local run; the TASK cases
    spool every distributed stage and leave no spool behind, and the
    layouts case then resizes the mesh to W / 2 (`resize_mesh`, a layout
    whose bucket count W / 2 still divides) and holds Q3 again."""
    import os

    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    r = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=W, device="cpu")
    r.execute("set session " + setting)
    local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    assert r.execute(QUERIES[3]).rows == local.execute(QUERIES[3]).rows
    if setting.startswith("table_layouts"):
        assert r.last_mesh_profile.counters.get("scan_bucketize", 0) == 1
        r.resize_mesh(W // 2)
        assert r.wm.n == W // 2 and r.last_resize_invalidated >= 1
        assert r.execute(QUERIES[3]).rows == local.execute(QUERIES[3]).rows
    if setting.startswith(("fault_tolerant", "retry_policy")):
        ex = r.last_stage_executor
        assert ex.retry_task and ex.counters.get("spool_write", 0) == 4
        assert not os.path.exists(ex.spool.dir)


@pytest.mark.parametrize("pallas_probe", [False, True], ids=["default", "pallas_probe"])
def test_cpu_mesh_join_routing_follows_pallas_probe(port_mesh, monkeypatch, pallas_probe):
    """On the card every kernel-eligible mesh join takes the sorted-probe
    kernel; on the CPU `pallas_probe` still decides: off, the mesh join
    calls `_locate_sorted` and never `locate_sorted`; on, the reverse for
    Q3's two single-key bigint joins."""
    import trino_tpu_torch.parallel.runner as mesh_runner

    calls = {"locate_sorted": 0, "_locate_sorted": 0}

    def counting(name):
        fn = getattr(mesh_runner, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return call

    for name in calls:
        monkeypatch.setattr(mesh_runner, name, counting(name))
    port_mesh.execute(f"set session pallas_probe = {str(pallas_probe).lower()}")
    try:
        assert len(port_mesh.execute(QUERIES[3]).rows) > 0
    finally:
        port_mesh.execute("set session pallas_probe = false")
    used, unused = (
        ("locate_sorted", "_locate_sorted") if pallas_probe
        else ("_locate_sorted", "locate_sorted")
    )
    assert calls[used] > 0
    assert calls[unused] == 0


def test_mesh_query_frees_its_stage_outputs(port_mesh):
    """Every stage output points back at its executor; the executor drops
    them when the query ends, so no device memory waits for the garbage
    collector across queries."""
    import gc

    def live_bytes():
        return sum(
            o.untyped_storage().nbytes()
            for o in gc.get_objects()
            if type(o) is torch.Tensor
        )

    port_mesh.execute(QUERIES[3])
    gc.collect()
    gc.disable()
    try:
        sizes = []
        for _ in range(3):
            port_mesh.execute(QUERIES[3])
            sizes.append(live_bytes())
    finally:
        gc.enable()
    assert sizes[0] == sizes[1] == sizes[2]

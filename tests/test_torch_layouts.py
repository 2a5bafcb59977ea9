"""Bucketed table layouts and co-located joins in the port, against the JAX
package; and the read of an array or map column stored in a memory table.

The cases of tests/test_partitioning.py that the port's mesh runs: the
layout parser, registry and resolver; the host layout hash against the
port's device exchange hash (torch) and the JAX package's host hash; scan
eligibility (a varchar bucket column through the global dictionary);
the placed plans and fragments (`explain_distributed` text equal to the
JAX mesh's); CREATE TABLE and CTAS WITH (bucketed_by, bucket_count) held
statement by statement to the JAX LocalQueryRunner, stored tables and
their layouts included (`test_torch_ddl.StatementPair`), locally and on
the 4-worker mesh; and on the port's 4-worker mesh the co-located join
with zero repartitions, TPC-H Q3, Q5, Q9 and Q18 under `table_layouts`,
the varchar-keyed co-located join, the residual semi join over a
misaligned bucketized scan, a TPC-DS join under layouts, the join with
the speculative capacity off, and the warm co-located Q3 under
`device_residency`, each giving the JAX local runner's rows.

Tolerances: integers, decimals, dates and strings exact; doubles
relative 1e-9.
"""

import numpy as np
import pytest
import torch

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import partitioning as PT
from trino_tpu_torch.connectors.api import TableHandle
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.partitioning import (
    GLOBAL_LAYOUTS,
    LayoutResolver,
    TableLayout,
    declare_layout,
    drop_layout,
    parse_layout_property,
)
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

from test_torch_ddl import StatementPair
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

W = 4
LINEITEM_ORDERS = "tpch.tiny.lineitem:l_orderkey:8,tpch.tiny.orders:o_orderkey:8"
RTOL = 1e-9


@pytest.fixture()
def clean_layouts():
    from trino_tpu.partitioning import GLOBAL_LAYOUTS as JLAYOUTS

    saved, jsaved = dict(GLOBAL_LAYOUTS), dict(JLAYOUTS)
    GLOBAL_LAYOUTS.clear()
    JLAYOUTS.clear()
    yield
    GLOBAL_LAYOUTS.clear()
    GLOBAL_LAYOUTS.update(saved)
    JLAYOUTS.clear()
    JLAYOUTS.update(jsaved)


@pytest.fixture(scope="module")
def dist():
    d = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=W, device="cpu")
    d.execute(f"set session table_layouts = '{LINEITEM_ORDERS}'")
    return d


@pytest.fixture(scope="module")
def jax_dist():
    from trino_tpu.parallel import DistributedQueryRunner as JaxDist

    d = JaxDist(catalog="tpch", schema="tiny", n_workers=W)
    d.execute(f"set session table_layouts = '{LINEITEM_ORDERS}'")
    return d


@pytest.fixture(scope="module")
def jax_local():
    return JaxRunner(catalog="tpch", schema="tiny", target_splits=3)


def _same(port_runner, sql, actual, expected):
    order = result_order(port_runner.create_plan(sql))
    assert_rows_match(actual.rows, expected.rows, order, float_rtol=RTOL)


# -- the fault: array and map columns stored in a memory table -------------------

TX = (
    "create table memory.default.tx as select o_orderkey a, "
    "array[o_orderkey, o_custkey] e from tpch.tiny.orders"
)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_stored_array_column_read_raises_by_name(where):
    """`select a, e` over a stored array column raises NotImplementedError
    naming the piece, locally and on the mesh, where the JAX package fails
    with an internal shape error; CTAS and `typeof(e)` answer as the JAX
    local runner does."""
    jax = JaxRunner(catalog="memory", schema="default")
    if where == "mesh":
        port = DistributedQueryRunner(catalog="memory", schema="default", n_workers=W,
                                      device="cpu")
    else:
        port = LocalQueryRunner(catalog="memory", schema="default", device="cpu")
    assert port.execute(TX).rows == jax.execute(TX).rows
    typeof = "select typeof(e) from memory.default.tx limit 1"
    assert port.execute(typeof).rows == jax.execute(typeof).rows == [("array(bigint)",)]
    with pytest.raises(Exception) as jerr:
        jax.execute("select a, e from memory.default.tx")
    assert not isinstance(jerr.value, NotImplementedError)
    for sql in ("select a, e from memory.default.tx", "select * from memory.default.tx",
                "select cardinality(e) from memory.default.tx"):
        with pytest.raises(NotImplementedError, match="array.bigint. column stored in a memory"):
            port.execute(sql)
    assert port.execute("select count(*) from memory.default.tx").rows == [(15000,)]


def test_map_insert_raises_by_name():
    """An INSERT of a map value fails with a TypeError in the JAX package
    and raises NotImplementedError by name in the port."""
    jax = JaxRunner(catalog="memory", schema="default")
    port = LocalQueryRunner(catalog="memory", schema="default", device="cpu")
    ddl = "create table memory.default.tm (a bigint, m map(bigint, bigint))"
    ins = "insert into memory.default.tm select 1, map(array[1], array[2])"
    jax.execute(ddl)
    port.execute(ddl)
    with pytest.raises(TypeError):
        jax.execute(ins)
    with pytest.raises(NotImplementedError, match="writing map.bigint, bigint. values"):
        port.execute(ins)


# -- layouts: registry, session property, resolver, the hash mirror ---------------


def test_parse_session_property():
    got = parse_layout_property(LINEITEM_ORDERS)
    assert got[("tpch", "tiny", "lineitem")] == TableLayout(("l_orderkey",), 8)
    assert got[("tpch", "tiny", "orders")] == TableLayout(("o_orderkey",), 8)
    assert parse_layout_property("c.s.t:a+b:16")[("c", "s", "t")] == TableLayout(("a", "b"), 16)
    with pytest.raises(ValueError):
        parse_layout_property("not-an-entry")


def test_registry_and_resolver_precedence(clean_layouts):
    h = TableHandle("tpch", "tiny", "lineitem")
    declare_layout("tpch.tiny.lineitem", ["l_orderkey"], 8)
    r = LayoutResolver(None, None)
    assert r(h) == TableLayout(("l_orderkey",), 8)

    class _Props:
        def get(self, name):
            if name == "global_dictionaries":
                return True
            assert name == "table_layouts"
            return "tpch.tiny.lineitem:l_orderkey:16"

    assert LayoutResolver(None, _Props())(h).bucket_count == 16
    drop_layout("tpch.tiny.lineitem")
    assert r(h) is None


@pytest.mark.parametrize("n", [257, 4096])
def test_host_hash_mirrors_device_exchange_hash(n):
    """The host layout hash equals the port's torch exchange hash and the
    JAX package's host hash, bit for bit, NULLs included; so do the
    destinations of every row."""
    from trino_tpu import partitioning as JPT
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.parallel.exchange import _hash_rows, unsigned_mod

    rng = np.random.default_rng(7 + n)
    data = rng.integers(-(10**12), 10**12, size=n, dtype=np.int64)
    other = rng.integers(0, 50, size=n, dtype=np.int32)
    valid = rng.random(n) > 0.1
    host = PT.host_bucket_hash([data, other], [valid, None], n)
    assert (host == JPT.host_bucket_hash([data, other], [valid, None], n)).all()
    dev = Batch(
        [Column(torch.from_numpy(data), T.BIGINT, torch.from_numpy(valid)),
         Column(torch.from_numpy(other), T.INTEGER)],
        torch.ones(n, dtype=torch.bool),
    )
    h = _hash_rows(dev, [0, 1])
    assert (h.numpy().view(np.uint64) == host).all()
    for w in (4, 8):
        dest = PT.bucket_rows(dev, (0, 1), w)
        assert (dest == (host % np.uint64(w)).astype(np.int64)).all()
        assert (unsigned_mod(h, w).numpy() == dest).all()


def test_scan_partitioning_eligibility(clean_layouts):
    from trino_tpu_torch.planner import plan as P

    local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    declare_layout("tpch.tiny.lineitem", ["l_orderkey"], 8)
    declare_layout("tpch.tiny.orders", ["o_comment"], 8)  # string key
    r = LayoutResolver(local.catalogs, None)
    plan = local.create_plan("select l_orderkey, o_comment from lineitem, orders")
    scans = {n.handle.table: n for n in P.walk(plan) if isinstance(n, P.TableScanNode)}
    hit = PT.scan_partitioning(scans["lineitem"], r, 8)
    assert hit is not None and hit[1] == ("l_orderkey",)
    # a string bucket column is usable only through the global dictionary
    hit_o = PT.scan_partitioning(scans["orders"], r, 8)
    assert hit_o is not None and hit_o[1] == ("o_comment",)
    r_off = LayoutResolver(local.catalogs, None)
    r_off.global_dicts = False
    assert PT.scan_partitioning(scans["orders"], r_off, 8) is None
    # bucket_count must be a multiple of the worker count
    assert PT.scan_partitioning(scans["lineitem"], r, 3) is None
    plan2 = local.create_plan("select l_quantity from lineitem")
    scan2 = next(n for n in P.walk(plan2) if isinstance(n, P.TableScanNode))
    assert PT.scan_partitioning(scan2, r, 8) is None


# -- placed plans (planning only) --------------------------------------------------

PLANS = {
    "colocated_join": "select count(*) from lineitem join orders on l_orderkey = o_orderkey",
    "covering_agg": "select l_orderkey, sum(l_quantity) from lineitem group by l_orderkey",
    "q3": QUERIES[3],
    "q18": QUERIES[18],
    "partial": (
        "select count(*) from lineitem join orders on l_orderkey = o_orderkey "
        "join customer on o_custkey = c_custkey"
    ),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_fragments_equal_jax_mesh(dist, jax_dist, name):
    """Under the layouts the port's fragments print as the JAX mesh's: the
    co-located join keeps both sides in place (`dist=colocated`, no
    repartition), the covering aggregation runs single-stage in the scan
    fragment."""
    sql = PLANS[name]
    txt = dist.explain_distributed(sql)
    assert txt == jax_dist.explain_distributed(sql)
    if name == "colocated_join":
        assert "dist=colocated" in txt and "repartition" not in txt
    if name == "covering_agg":
        assert "repartition" not in txt and "Aggregation[single]" in txt
        assert "SOURCE[l_orderkey" in txt


def test_colocated_join_off_restores_exchanges(dist):
    sql = PLANS["colocated_join"]
    dist.execute("set session colocated_join = false")
    try:
        assert "colocated" not in dist.explain_distributed(sql)
    finally:
        dist.execute("set session colocated_join = true")


# -- CREATE TABLE / CTAS WITH (bucketed_by, bucket_count) --------------------------

BUCKETED = {
    "create": [
        "create table bk (k bigint, v bigint) with (bucketed_by = array['k'], bucket_count = 4)",
        "insert into bk select o_orderkey, o_custkey from tpch.tiny.orders",
        "select count(*), sum(v) from bk",
        "drop table bk",
    ],
    "ctas": [
        "create table bk2 with (bucketed_by = array['o_orderkey'], bucket_count = 4) as "
        "select o_orderkey from tpch.tiny.orders",
        "select count(*), max(o_orderkey) from bk2",
    ],
    "ctas_join": [
        "create table memory.default.bk with (bucketed_by = array['o_custkey'], "
        "bucket_count = 4) as select o_custkey from tpch.tiny.orders",
        "select count(*) from memory.default.bk b join tpch.tiny.customer c "
        "on b.o_custkey = c.c_custkey",
    ],
    "ctas_colocated": [
        "create table ob with (bucketed_by = array['o_orderkey'], bucket_count = 8) as "
        "select o_orderkey, o_totalprice from tpch.tiny.orders",
        "create table lb with (bucketed_by = array['l_orderkey'], bucket_count = 8) as "
        "select l_orderkey, l_quantity from tpch.tiny.lineitem",
        "select count(*), sum(l_quantity), sum(o_totalprice) from lb join ob "
        "on l_orderkey = o_orderkey",
    ],
    "bad_properties": [
        "create table bad (k bigint) with (compression = 'zstd')",
        "create table bad (k bigint) with (bucketed_by = array['nope'], bucket_count = 8)",
        "create table bad (k bigint) with (bucketed_by = array['k'])",
    ],
    "rollback": [
        "start transaction",
        "create table bt (k bigint) with (bucketed_by = array['k'], bucket_count = 8)",
        "rollback",
        "show tables",
    ],
}


def _layouts(pair) -> tuple:
    """Each memory table's stored layout in both stores."""
    def of(conn):
        return {
            key: None if st.layout is None
            else (tuple(st.layout.bucket_columns), st.layout.bucket_count)
            for key, st in conn.store.items()
        }

    return of(pair.port.catalogs.get("memory")), of(pair.jax.catalogs.get("memory"))


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("case", list(BUCKETED))
def test_bucketed_statements_equal_jax(clean_layouts, case, where):
    """Each statement's result, every stored memory table and the layout
    each holds equal the JAX LocalQueryRunner's; the memory connector owns
    the layout, so the engine registry stays clean."""
    pair = StatementPair(where=where)
    for sql in BUCKETED[case]:
        pair.run(sql)
        port_l, jax_l = _layouts(pair)
        assert port_l == jax_l, sql
    assert dict(GLOBAL_LAYOUTS) == {}
    if case == "ctas_colocated" and where == "mesh":
        c = pair.port.last_mesh_profile.counters
        assert c.get("repartition_collective", 0) == 0
        assert c.get("exchange_elided", 0) >= 2
        assert c.get("scan_bucketize", 0) == 2


def test_registry_layout_for_a_connector_without_one(clean_layouts):
    """A connector that cannot store a layout (blackhole) leaves it in the
    process registry, as in the JAX runner, and DROP TABLE clears it."""
    from trino_tpu.partitioning import GLOBAL_LAYOUTS as JLAYOUTS

    pair = StatementPair()
    sql = ("create table blackhole.default.bh with (bucketed_by = array['k'], "
           "bucket_count = 8) as select o_orderkey k from tpch.tiny.orders")
    pair.run(sql)
    key = ("blackhole", "default", "bh")
    assert GLOBAL_LAYOUTS[key] == TableLayout(("k",), 8)
    assert JLAYOUTS[key].bucket_columns == ("k",) and JLAYOUTS[key].bucket_count == 8
    pair.run("drop table blackhole.default.bh")
    assert key not in GLOBAL_LAYOUTS and key not in JLAYOUTS


# -- the co-located mesh -----------------------------------------------------------


def test_colocated_join_zero_repartitions(dist, jax_local):
    sql = ("select count(*), sum(l_quantity) from lineitem join orders "
           "on l_orderkey = o_orderkey")
    assert dist.execute(sql).rows == jax_local.execute(sql).rows
    c = dist.last_mesh_profile.counters
    assert c.get("repartition_collective", 0) == 0
    assert c.get("exchange_elided", 0) >= 2
    assert c.get("scan_bucketize", 0) + c.get("scan_cache_hit", 0) >= 2


@pytest.mark.parametrize("qid", [3, 5, 9, 18])
def test_tpch_under_layouts_matches_jax_local(dist, jax_local, qid):
    actual = dist.execute(QUERIES[qid])
    _same(dist, QUERIES[qid], actual, jax_local.execute(QUERIES[qid]))
    assert dist.last_mesh_profile.counters.get("exchange_elided", 0) >= 2


def test_colocated_aggregation_single_stage(dist, jax_local):
    """The aggregation by l_orderkey over the bucketed lineitem runs in the
    scan fragment (no exchange), with the JAX local rows."""
    sql = ("select l_orderkey, sum(l_quantity), count(*) from lineitem "
           "group by l_orderkey order by 2 desc, 1 limit 10")
    actual = dist.execute(sql)
    _same(dist, sql, actual, jax_local.execute(sql))
    assert dist.last_mesh_profile.counters.get("repartition_collective", 0) == 0


def test_varchar_key_colocated_join_via_global_dictionary():
    """A varchar business key under a layout co-locates through the
    global dictionary's codes: zero repartitions, the JAX local rows, and
    the same rows with the global dictionaries off."""
    d = DistributedQueryRunner(catalog="tpcds", schema="tiny", n_workers=W, device="cpu")
    d.execute("set session table_layouts = 'tpcds.tiny.customer:c_customer_id:8'")
    sql = ("select count(*) from tpcds.tiny.customer c1 join tpcds.tiny.customer c2 "
           "on c1.c_customer_id = c2.c_customer_id")
    expected = JaxRunner(catalog="tpcds", schema="tiny").execute(sql).rows
    assert d.execute(sql).rows == expected
    c = d.last_mesh_profile.counters
    assert c.get("repartition_collective", 0) == 0
    assert c.get("exchange_elided", 0) > 0
    d.execute("set session global_dictionaries = false")
    assert d.execute(sql).rows == expected


def test_tpcds_subset_under_layouts():
    """store_sales and store_returns bucketed on the item key: their join
    gives the JAX local runner's rows."""
    d = DistributedQueryRunner(catalog="tpcds", schema="tiny", n_workers=W, device="cpu")
    d.execute("set session table_layouts = "
              "'tpcds.tiny.store_sales:ss_item_sk:8,tpcds.tiny.store_returns:sr_item_sk:8'")
    sql = ("select count(*), sum(ss_quantity) from tpcds.tiny.store_sales "
           "join tpcds.tiny.store_returns on ss_item_sk = sr_item_sk "
           "and ss_ticket_number = sr_ticket_number")
    assert d.execute(sql).rows == JaxRunner(catalog="tpcds", schema="tiny").execute(sql).rows
    assert d.last_mesh_profile.counters.get("scan_bucketize", 0) == 2


def test_speculative_off_matches_on(dist, jax_local):
    sql = ("select o_orderstatus, count(*) from lineitem join orders "
           "on l_orderkey = o_orderkey group by o_orderstatus")
    on = dist.execute(sql).rows
    dist.execute("set session join_speculative_capacity = 'off'")
    try:
        off = dist.execute(sql).rows
    finally:
        dist.execute("set session join_speculative_capacity = 'on'")
    assert sorted(on) == sorted(off) == sorted(jax_local.execute(sql).rows)


def test_residual_semi_with_misaligned_bucketized_scan(jax_local):
    d = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=W, device="cpu")
    d.execute("set session table_layouts = 'tpch.tiny.lineitem:l_orderkey:8'")
    sql = ("select count(*) from partsupp where ps_partkey in "
           "(select l_partkey from lineitem where l_orderkey > partsupp.ps_availqty)")
    assert d.execute(sql).rows == jax_local.execute(sql).rows


def test_bucket_count_not_multiple_of_workers_repartitions(jax_local):
    """bucket_count % W != 0: the scan keeps its splits and the join
    repartitions, as in the JAX package."""
    d = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=W, device="cpu")
    d.execute("set session table_layouts = "
              "'tpch.tiny.lineitem:l_orderkey:6,tpch.tiny.orders:o_orderkey:6'")
    sql = "select count(*) from lineitem join orders on l_orderkey = o_orderkey"
    assert d.execute(sql).rows == jax_local.execute(sql).rows
    c = d.last_mesh_profile.counters
    assert c.get("scan_bucketize", 0) == 0


def test_scan_cache_keys_the_layout(dist):
    """The device scan cache keys the layout: the same splits stacked by
    layout and round-robin are two entries, each hit on its own rerun."""
    from trino_tpu_torch.runtime.buffer_pool import POOL

    sql = "select count(*) from orders where o_orderkey > 10"
    POOL.clear()
    dist.execute(sql)
    assert dist.last_mesh_profile.counters.get("scan_bucketize", 0) == 1
    dist.execute(sql)
    assert dist.last_mesh_profile.counters.get("scan_cache_hit", 0) == 1
    dist.execute("set session colocated_join = false")
    try:
        dist.execute(sql)
        assert dist.last_mesh_profile.counters.get("scan_cache_miss", 0) == 1
        assert dist.last_mesh_profile.counters.get("scan_bucketize", 0) == 0
        dist.execute(sql)
        assert dist.last_mesh_profile.counters.get("scan_cache_hit", 0) == 1
    finally:
        dist.execute("set session colocated_join = true")


def test_warm_colocated_q3_is_device_resident(dist):
    from trino_tpu_torch import verify as V

    rep = V.device_residency(dist, QUERIES[3], warmups=2)
    assert rep["retraces"] == 0 and rep["trace_misses"] == 0
    assert rep["counters"].get("host_restack", 0) == 0
    assert rep["counters"].get("join_capacity_sync", 0) == 0
    assert rep["counters"].get("exchange_elided", 0) >= 2
    assert rep["cache_keys_checked"] > 0

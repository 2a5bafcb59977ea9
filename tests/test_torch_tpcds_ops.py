"""The plan nodes and aggregates of the TPC-DS slice against the JAX
package's LocalQueryRunner, on the same inputs: VALUES relations made from
a seeded numpy generator, and tpcds.tiny tables.

  * UNION ALL and UNION with a branch CAST (decimal under double, a
    narrower varchar) and a NULL-literal branch;
  * INTERSECT and EXCEPT with NULLs and duplicates on both sides;
  * ROLLUP with grouping();
  * EnforceSingleRow over 0, 1 and 2 rows (the last raising), locally and
    on the mesh;
  * stddev_samp, stddev_pop, var_samp, var_pop over groups of 0, 1 and 2+
    values, over decimal and double inputs, grouped and global (and over
    long decimals, where the JAX package raises, against short ones);
  * a mesh stage fed by a coordinator fragment that produced no batch;
  * a residual EXISTS on the mesh whose source key is a broadcast join's
    build column (the JAX mesh loses a match there);
  * a partitioned FULL join on the mesh whose probe side holds a long
    decimal (the JAX mesh fails to concatenate its unmatched rows there).

Every statement runs through the port's LocalQueryRunner and its 4-worker
mesh; rows compare under the statement's ORDER BY (or as a multiset
without one); doubles to relative 1e-9, everything else exact.
"""

import numpy as np
import pytest

from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runners():
    return {
        "jax": JaxRunner(catalog="tpcds", schema="tiny"),
        "local": LocalQueryRunner(catalog="tpcds", schema="tiny", device="cpu"),
        "mesh": DistributedQueryRunner(
            catalog="tpcds", schema="tiny", n_workers=4, device="cpu"
        ),
    }


def check(runners, sql: str, nonempty: bool = True) -> list:
    expected = runners["jax"].execute(sql)
    if nonempty:
        assert expected.rows
    order = result_order(runners["local"].create_plan(sql))
    for where in ("local", "mesh"):
        actual = runners[where].execute(sql)
        assert actual.column_names == expected.column_names, where
        assert [t.name for t in actual.types] == [t.name for t in expected.types], where
        assert_rows_match(actual.rows, expected.rows, order, float_rtol=1e-9)
    return expected.rows


def _lit(v, kind: str) -> str:
    if v is None:
        return "null"
    if kind == "dec":
        return f"{v:.2f}"  # a decimal(p, 2) literal
    if kind == "dbl":
        return f"{v!r}e0"
    if kind == "str":
        return f"'{v}'"
    return str(int(v))


def values_relation(name: str, columns, kinds, rows) -> str:
    body = ", ".join(
        "(" + ", ".join(_lit(v, k) for v, k in zip(r, kinds)) + ")" for r in rows
    )
    return f"{name}({', '.join(columns)}) as (values {body})"


def _rng_rows(seed: int, n: int, kinds, null_share: float = 0.2, domain: int = 5):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        row = []
        for k in kinds:
            if rng.random() < null_share:
                row.append(None)
            elif k == "dec":
                row.append(int(rng.integers(-50000, 50000)) / 100)
            elif k == "dbl":
                row.append(float(rng.normal(3.0, 10.0)))
            elif k == "str":
                row.append("abcde"[int(rng.integers(0, domain))] * 2)
            else:
                row.append(int(rng.integers(0, domain)))
        rows.append(row)
    return rows


# -- UNION -------------------------------------------------------------------


def _union_relations() -> str:
    a = values_relation(
        "a", ["k", "v", "s"], ["int", "dec", "str"],
        _rng_rows(1, 24, ["int", "dec", "str"], null_share=0.1),
    )
    # b's strings are longer (varchar(4) under a's varchar(2))
    b_rows = [
        [k, v, None if s is None else s + "xy"]
        for k, v, s in _rng_rows(2, 20, ["int", "dbl", "str"], null_share=0.1)
    ]
    b = values_relation("b", ["k", "v", "s"], ["int", "dbl", "str"], b_rows)
    return f"with {a}, {b} "


@pytest.mark.parametrize("op", ["union all", "union"])
def test_union_casts_branches_and_types_null_branch(runners, op):
    sql = (
        _union_relations()
        + f"select k, v, s from a {op} select k, v, s from b {op} "
        "select null, null, null order by k, v, s"
    )
    rows = check(runners, sql)
    assert (None, None, None) in rows
    assert all(v is None or isinstance(v, float) for _, v, _ in rows)


def test_union_feeds_an_aggregation(runners):
    # the branches' string columns carry different dictionaries into one
    # grouped aggregation
    check(
        runners,
        _union_relations()
        + "select s, count(*), sum(v) from (select s, v from a union all "
        "select s, v from b) group by s order by s",
    )


def test_union_over_tables_with_decimal_and_double_branches(runners):
    check(
        runners,
        "select channel, sum(amt), count(*) from ("
        "select 'store' as channel, ss_net_paid as amt from store_sales "
        "where ss_quantity > 90 union all "
        "select 'web', cast(ws_net_paid as double) / 2 from web_sales "
        "where ws_quantity > 90 union all "
        "select 'none', null from reason where r_reason_sk < 3) "
        "group by channel order by channel",
    )


# -- INTERSECT / EXCEPT ----------------------------------------------------------


@pytest.mark.parametrize("op", ["intersect", "except"])
def test_intersect_except_with_nulls_and_duplicates(runners, op):
    kinds = ["int", "str"]
    a = values_relation("a", ["x", "s"], kinds, _rng_rows(3, 40, kinds, domain=4))
    b = values_relation("b", ["x", "s"], kinds, _rng_rows(4, 30, kinds, domain=4))
    rows = check(
        runners, f"with {a}, {b} select x, s from a {op} select x, s from b order by x, s"
    )
    assert len(rows) == len(set(rows))
    if op == "intersect":
        assert any(None in r for r in rows)


def test_intersect_except_over_tables(runners):
    check(
        runners,
        "select count(*) from ((select ss_customer_sk from store_sales "
        "intersect select cs_bill_customer_sk from catalog_sales) "
        "except select ws_bill_customer_sk from web_sales)",
    )


# -- ROLLUP ------------------------------------------------------------------------


def test_rollup_with_grouping(runners):
    kinds = ["int", "str", "dec"]
    t = values_relation("t", ["k1", "k2", "v"], kinds, _rng_rows(5, 60, kinds, domain=3))
    rows = check(
        runners,
        f"with {t} select k1, k2, sum(v), count(*), grouping(k1, k2) "
        "from t group by rollup(k1, k2) order by 5, 1, 2",
    )
    assert {r[4] for r in rows} == {0, 1, 3}


def test_rollup_over_a_table(runners):
    check(
        runners,
        "select i_category, i_class, sum(ss_ext_sales_price), "
        "grouping(i_category) + grouping(i_class) as lochierarchy "
        "from store_sales join item on ss_item_sk = i_item_sk "
        "where ss_quantity < 10 group by rollup(i_category, i_class) "
        "order by lochierarchy desc, i_category, i_class",
    )


# -- EnforceSingleRow -------------------------------------------------------------


_SINGLE = values_relation(
    "t", ["k", "v"], ["int", "dec"], [[1, 1.5], [2, 2.25], [2, -3.5], [3, None]]
)


@pytest.mark.parametrize("key,expect", [(99, None), (1, 1.5), (3, None)])
def test_enforce_single_row_zero_or_one(runners, key, expect):
    from decimal import Decimal

    rows = check(
        runners,
        f"with {_SINGLE} select s_store_sk, (select v from t where k = {key}) "
        "from store order by s_store_sk",
    )
    want = None if expect is None else Decimal(f"{expect:.2f}")
    assert {r[1] for r in rows} == {want}


@pytest.mark.parametrize("where", ["jax", "local", "mesh"])
def test_enforce_single_row_two_rows_raise(runners, where):
    sql = (
        f"with {_SINGLE} select s_store_sk, (select v from t where k = 2) "
        "from store"
    )
    with pytest.raises(RuntimeError, match="Scalar sub-query has returned multiple rows"):
        runners[where].execute(sql)


def test_enforce_single_row_over_a_table(runners):
    check(
        runners,
        "select count(*) from item where i_current_price > "
        "(select i_current_price from item where i_item_sk = 3)",
    )


# -- the moment family ---------------------------------------------------------------

_MOMENTS = ("stddev_samp", "stddev_pop", "var_samp", "var_pop")


def _moment_relation() -> str:
    kinds = ["int", "dec", "dbl"]
    rows = [[0, None, None], [0, None, None]]  # no values
    rows += [[1, 12.5, -4.0]]  # one value
    rows += [[2, 1.25, 2.5], [2, 3.75, 7.5]]  # two values
    rows += [[3, 3.0, 3.0]] * 5  # constant: a zero variance
    rows += [[4] + r[1:] for r in _rng_rows(6, 50, kinds, null_share=0.1)]
    return values_relation("t", ["g", "d", "f"], kinds, rows)


def test_moments_grouped_over_values(runners):
    aggs = ", ".join(f"{m}(d), {m}(f)" for m in _MOMENTS)
    rows = check(
        runners,
        f"with {_moment_relation()} select g, {aggs}, count(d) from t group by g order by g",
    )
    by_group = {r[0]: r for r in rows}
    assert all(v is None for v in by_group[0][1:9])
    # one value: the sample forms are NULL, the population forms zero
    assert by_group[1][1] is None and by_group[1][3] == 0.0
    assert by_group[3][5] == 0.0


@pytest.mark.parametrize("pred", ["g >= 0", "g < 0"], ids=["all_rows", "no_rows"])
def test_moments_global_over_values(runners, pred):
    aggs = ", ".join(f"{m}(d), {m}(f)" for m in _MOMENTS)
    check(runners, f"with {_moment_relation()} select {aggs} from t where {pred}")


def test_moments_over_a_table(runners):
    aggs = ", ".join(
        f"{m}(ss_quantity), {m}(ss_sales_price), {m}(cast(ss_list_price as double))"
        for m in _MOMENTS
    )
    check(
        runners,
        f"select ss_store_sk, {aggs} from store_sales group by ss_store_sk "
        "order by ss_store_sk",
    )
    check(runners, f"select {aggs} from store_sales where ss_quantity > 50")


def test_moments_over_long_decimals_equal_short_decimals(runners):
    """Over a decimal(38,2) input (limb planes) the moments equal those of
    the same values as decimal(7,2).  The JAX package raises here (a shape
    error in its f64 conversion of the limbs), so this is held within the
    port, local and mesh."""
    pairs = ", ".join(
        f"{m}(cast(ss_sales_price as decimal(38,2))), {m}(ss_sales_price)"
        for m in _MOMENTS
    )
    sql = f"select ss_store_sk, {pairs} from store_sales group by 1 order by 1"
    for where in ("local", "mesh"):
        rows = runners[where].execute(sql).rows
        assert rows
        for r in rows:
            for long_v, short_v in zip(r[1::2], r[2::2]):
                assert long_v == pytest.approx(short_v, rel=1e-9)


# -- the mesh -----------------------------------------------------------------------


def test_mesh_stage_fed_by_an_empty_coordinator_fragment(runners):
    """A cross join of two filtered dimensions runs on the coordinator and
    is broadcast into the store_sales join; at tiny it produces no batch,
    which the JAX package's mesh rejects ("empty single-fragment feed")."""
    sql = (
        "select ss_ticket_number, count(*) from store_sales, "
        "household_demographics, store where ss_hdemo_sk = hd_demo_sk and "
        "ss_store_sk = s_store_sk and hd_vehicle_count > 0 and "
        "hd_dep_count = 99 and s_county = 'Bronx County' "
        "group by ss_ticket_number order by 1"
    )
    assert "Join[cross]" in runners["mesh"].explain_distributed(sql)
    assert check(runners, sql, nonempty=False) == []


#: q94's correlated EXISTS over web_sales rows that a broadcast join moved
#: onto customer_address's splits
MOVED_KEY_EXISTS = """select ws_order_number, ws_warehouse_sk from web_sales ws1, date_dim,
customer_address, web_site
where d_date between cast('2000-02-01' as date) and cast('2000-02-01' as date) + interval '60' day
and ws1.ws_ship_date_sk = d_date_sk and ws1.ws_ship_addr_sk = ca_address_sk
and ca_state = 'GA' and ws1.ws_web_site_sk = web_site_sk
and exists (select * from web_sales ws2 where ws1.ws_order_number = ws2.ws_order_number
            and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
order by 1, 2"""


def test_mesh_residual_exists_over_a_broadcast_build_key(runners):
    """The semi join's source key came in as a broadcast join's build column:
    its rows sit on the probe table's splits, not on web_sales's, so both
    sides are hash-placed on the key before the per-shard marking.  The
    JAX package's mesh marks per shard and loses order 1 (4 rows, not 5)."""
    rows = check(runners, MOVED_KEY_EXISTS)
    assert (1, 1) in rows
    assert runners["mesh"].last_stage_executor.counters.get("repartition_collective", 0) >= 2


def test_mesh_full_join_with_a_long_decimal_probe_column(runners):
    """A partitioned FULL join whose probe side carries a decimal(38,2) sum
    (TPC-DS q51's shape): the unmatched build rows' probe columns are NULL
    limb planes.  The JAX package's mesh gives them one plane and fails to
    concatenate; the port's mesh is held to the JAX local rows."""
    sql = (
        "select a.k, a.s, b.k, b.s from "
        "(select ws_item_sk k, sum(ws_sales_price) s from web_sales "
        " where ws_item_sk < 400 group by ws_item_sk) a full outer join "
        "(select ss_item_sk k, sum(ss_sales_price) s from store_sales "
        " where ss_item_sk between 200 and 600 group by ss_item_sk) b on a.k = b.k"
    )
    assert "Join[full]" in runners["mesh"].explain_distributed(sql)
    rows = check(runners, sql)
    assert any(r[0] is None for r in rows) and any(r[2] is None for r in rows)

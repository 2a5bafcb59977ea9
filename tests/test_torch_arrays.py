"""Array and map values, UNNEST and the array/map/JSON/lambda functions in the
port against the JAX package.

Module level, on batches made from a numpy seed and built in both packages:

  * `UnnestOperator`: two array columns of different widths zipped (the
    shorter padded with NULLs), WITH ORDINALITY, NULL arrays, empty arrays,
    dead rows and a replicated payload column;
  * the compiler's ARRAY form (bigint columns and a literal; varchar columns
    coded in two dictionaries) and SUBSCRIPT (an index column with NULLs,
    zero, negative and out-of-range values) over it and over an array input
    column;
  * the "2-D" sites, where [capacity, K] array data must not be read as the
    [capacity, 2] limb planes of a long decimal: the sort permutation and the
    group numbering (ops/common.py), the ordered merge (ops/merge.py) and the
    dynamic filter's range (runtime/local_planner.py `_host_minmax`).  A
    long-decimal column gives the JAX package's result there; an array
    column is carried (merge payload) or raises NotImplementedError naming
    its type.

As SQL at tpch.tiny, through the JAX package's LocalQueryRunner and the
port's LocalQueryRunner and 4-worker mesh (`DistributedQueryRunner(
n_workers=4, device="cpu")`): every statement of tests/test_arrays_unnest.py
(the JSON and distributed ones too) and of tests/test_maps.py, and the 2-D
sites the SQL reaches (the aggregation's value reads, the window's partition
keys, lag and the frame count/sum).

Tolerances: integers, decimals and strings exact (arrays and maps element by
element); doubles relative 1e-9, inside arrays too (trino_tpu_torch/
testing.py).  No statement here aggregates into an array, so element order
is the engine's and is compared as it is.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar import StringDictionary as JDict
from trino_tpu.expr import ExprCompiler as JCompiler
from trino_tpu.expr import ir as jir
from trino_tpu.ops import common as jcommon
from trino_tpu.ops.merge import merge_sorted_shards as jmerge
from trino_tpu.ops.unnest import UnnestOperator as JUnnest
from trino_tpu.runtime.local_planner import _host_minmax as j_host_minmax
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.columnar import StringDictionary as TDict
from trino_tpu_torch.expr import ExprCompiler as TCompiler
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.ops import common as tcommon
from trino_tpu_torch.ops.merge import merge_sorted_shards as tmerge
from trino_tpu_torch.ops.unnest import UnnestOperator as TUnnest
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.local_planner import _host_minmax as t_host_minmax
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)


# -- paired batches -------------------------------------------------------------


class Col:
    """One column's numpy form, built into both packages' Columns."""

    def __init__(self, data, jt, tt, valid=None, words=None, lengths=None):
        self.data, self.jt, self.tt = data, jt, tt
        self.valid, self.words, self.lengths = valid, words, lengths

    def jax(self):
        d = None if self.words is None else JDict(self.words)
        return JColumn(
            jnp.asarray(self.data), self.jt,
            None if self.valid is None else jnp.asarray(self.valid), d,
            None if self.lengths is None else jnp.asarray(self.lengths),
        )

    def port(self):
        d = None if self.words is None else TDict(self.words)
        return TColumn(
            torch.from_numpy(self.data), self.tt,
            None if self.valid is None else torch.from_numpy(self.valid), d,
            None if self.lengths is None else torch.from_numpy(self.lengths),
        )


def pair(cols, mask):
    jb = JBatch([c.jax() for c in cols], None if mask is None else jnp.asarray(mask))
    tb = TBatch([c.port() for c in cols], None if mask is None else torch.from_numpy(mask))
    return jb, tb


def array_col(rng, n, k, null_rate=0.2, empty_rate=0.15):
    """A bigint array column: [n, k] values, lengths 0..k (some empty),
    some NULL arrays; padded slots hold junk, as a filter leaves them."""
    data = rng.integers(-50, 50, (n, k)).astype(np.int64)
    lengths = rng.integers(1, k + 1, n).astype(np.int32)
    lengths[rng.random(n) < empty_rate] = 0
    valid = rng.random(n) >= null_rate
    return Col(data, JT.ArrayType(JT.BIGINT), TT.ArrayType(TT.BIGINT), valid, None, lengths)


def long_decimal_col(rng, n):
    """decimal(30,2) limb planes with magnitudes past 2**64, NULLs, ties."""
    vals = rng.integers(-3, 4, n).astype(object) * (1 << 70) + rng.integers(0, 5, n)
    hi = np.asarray([int(v) >> 64 for v in vals], dtype=np.int64)
    lo = np.asarray([((int(v) & ((1 << 64) - 1)) ^ (1 << 63)) - (1 << 63) for v in vals], dtype=np.int64)
    data = np.stack([hi, lo], axis=1)
    valid = rng.random(n) >= 0.2
    return Col(data, JT.DecimalType(30, 2), TT.DecimalType(30, 2), valid)


def rows_of(batch):
    return [list(r) for r in batch.to_pylist()]


# -- UnnestOperator -------------------------------------------------------------


@pytest.mark.parametrize("ordinality", [False, True], ids=["plain", "ordinality"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unnest_operator_matches_jax(seed, ordinality):
    rng = np.random.default_rng(seed)
    n = 48
    a = array_col(rng, n, 4)
    b = array_col(rng, n, 2)
    payload = Col(rng.integers(0, 1000, n).astype(np.int64), JT.BIGINT, TT.BIGINT,
                  rng.random(n) >= 0.1)
    mask = rng.random(n) < 0.85
    jb, tb = pair([payload, a, b], mask)
    jexprs = [jir.InputRef(1, a.jt), jir.InputRef(2, b.jt)]
    texprs = [tir.InputRef(1, a.tt), tir.InputRef(2, b.tt)]
    (jout,) = list(JUnnest(jexprs, with_ordinality=ordinality).process(iter([jb])))
    (tout,) = list(TUnnest(texprs, with_ordinality=ordinality).process(iter([tb])))
    expected = rows_of(jout)
    assert rows_of(tout) == expected
    # the zip: rows past the shorter array's length carry NULL there, and
    # NULL / empty arrays contribute no rows
    live_lens = [
        max(int(a.lengths[i]) if a.valid[i] else 0, int(b.lengths[i]) if b.valid[i] else 0)
        for i in range(n) if mask[i]
    ]
    assert len(expected) == sum(live_lens)


def test_unnest_of_an_empty_and_a_null_array():
    e = Col(np.asarray([[0, 0], [5, 6], [7, 0]], np.int64), JT.ArrayType(JT.BIGINT),
            TT.ArrayType(TT.BIGINT), np.asarray([True, False, True]), None,
            np.asarray([0, 2, 1], np.int32))
    p = Col(np.arange(3, dtype=np.int64), JT.BIGINT, TT.BIGINT)
    jb, tb = pair([p, e], None)
    (jout,) = list(JUnnest([jir.InputRef(1, e.jt)], True).process(iter([jb])))
    (tout,) = list(TUnnest([tir.InputRef(1, e.tt)], True).process(iter([tb])))
    assert rows_of(tout) == rows_of(jout) == [[2, [7], 7, 1]]


# -- the ARRAY and SUBSCRIPT forms ----------------------------------------------


def _form_batches(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    words_a, words_b = ["x", "yy", "zzz"], ["a", "q", "yy"]
    cols = [
        Col(rng.integers(-9, 9, n).astype(np.int64), JT.BIGINT, TT.BIGINT),
        Col(rng.integers(-9, 9, n).astype(np.int64), JT.BIGINT, TT.BIGINT, rng.random(n) >= 0.2),
        Col(rng.integers(-1, 5, n).astype(np.int64), JT.BIGINT, TT.BIGINT, rng.random(n) >= 0.2),
        Col(rng.integers(0, 3, n).astype(np.int32), JT.VARCHAR, TT.VARCHAR, None, words_a),
        Col(rng.integers(0, 3, n).astype(np.int32), JT.VARCHAR, TT.VARCHAR, None, words_b),
        array_col(rng, n, 4),
    ]
    return pair(cols, rng.random(n) < 0.9), cols


def _forms(ir, T):
    """(name, expr) pairs built in one package's IR."""
    F = ir.Form
    a_big = T.ArrayType(T.BIGINT)
    arr = ir.SpecialForm(
        F.ARRAY, [ir.InputRef(0, T.BIGINT), ir.InputRef(1, T.BIGINT), ir.Literal(7, T.BIGINT)], a_big
    )
    sarr = ir.SpecialForm(
        F.ARRAY, [ir.InputRef(3, T.VARCHAR), ir.InputRef(4, T.VARCHAR)], T.ArrayType(T.VARCHAR)
    )
    idx = ir.InputRef(2, T.BIGINT)
    return [
        ("array", arr),
        ("varchar_array", sarr),
        ("subscript", ir.SpecialForm(F.SUBSCRIPT, [arr, idx], T.BIGINT)),
        ("varchar_subscript", ir.SpecialForm(F.SUBSCRIPT, [sarr, idx], T.VARCHAR)),
        ("input_subscript", ir.SpecialForm(F.SUBSCRIPT, [ir.InputRef(5, a_big), idx], T.BIGINT)),
        ("literal_subscript", ir.SpecialForm(F.SUBSCRIPT, [arr, ir.Literal(3, T.BIGINT)], T.BIGINT)),
        ("is_null", ir.SpecialForm(F.IS_NULL, [ir.InputRef(5, a_big)], T.BOOLEAN)),
    ]


@pytest.mark.parametrize("form", [name for name, _ in _forms(tir, TT)])
@pytest.mark.parametrize("seed", [3, 4])
def test_array_forms_match_jax(form, seed):
    (jb, tb), _ = _form_batches(seed)
    jexpr = dict(_forms(jir, JT))[form]
    texpr = dict(_forms(tir, TT))[form]
    jcol = JCompiler(jb).column(jexpr)
    tcol = TCompiler(tb).column(texpr)
    assert tcol.to_pylist() == jcol.to_pylist()
    assert (tcol.lengths is None) == (jcol.lengths is None)


# -- the 2-D sites at module level ------------------------------------------------


def _key_batches(seed: int, n: int = 64):
    rng = np.random.default_rng(seed)
    cols = [
        long_decimal_col(rng, n),
        array_col(rng, n, 2, empty_rate=0.0),  # [n, 2]: the limb planes' shape
        Col(rng.integers(0, 4, n).astype(np.int64), JT.BIGINT, TT.BIGINT),
    ]
    return pair(cols, rng.random(n) < 0.9)


@pytest.mark.parametrize("seed", [5, 6])
def test_sort_and_group_ids_tell_arrays_from_limb_planes(seed):
    """ops/common.py: multi_key_sort_perm and group_ids_from_sorted over a
    long decimal equal the JAX package's; over an array of the same shape
    they raise by name."""
    jb, tb = _key_batches(seed)
    for asc in (True, False):
        jp = jcommon.multi_key_sort_perm(jb, [jcommon.SortKey(0, asc)])
        tp = tcommon.multi_key_sort_perm(tb, [tcommon.SortKey(0, asc)])
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        jg = jcommon.group_ids_from_sorted(jb, jp, [0])
        tg = tcommon.group_ids_from_sorted(tb, tp, [0])
        for j, t in zip(jg, tg):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(NotImplementedError, match=r"array\(bigint\)"):
        tcommon.multi_key_sort_perm(tb, [tcommon.SortKey(1)])
    perm = torch.arange(tb.capacity)
    with pytest.raises(NotImplementedError, match=r"array\(bigint\)"):
        tcommon.group_ids_from_sorted(tb, perm, [1])


@pytest.mark.parametrize("seed", [7, 8])
def test_merge_carries_arrays_and_sorts_limb_planes(seed):
    """ops/merge.py: shards sorted on a long-decimal key merge as in the JAX
    package, an array payload column with them; an array key raises."""
    rng = np.random.default_rng(seed)
    shards_j, shards_t = [], []
    for _ in range(3):
        n = int(rng.integers(1, 20))
        ld, arr = long_decimal_col(rng, n), array_col(rng, n, 2)
        jb, tb = pair([ld, arr], None)
        jp = jcommon.multi_key_sort_perm(jb, [jcommon.SortKey(0)])
        jb = jb.gather(jp)
        tb = tb.gather(torch.from_numpy(np.array(jp)))
        shards_j.append(JBatch([c for c in jb.columns], None))
        shards_t.append(TBatch([c for c in tb.columns], None))
    jout = jmerge(shards_j, [jcommon.SortKey(0)])
    tout = tmerge(shards_t, [tcommon.SortKey(0)])
    assert rows_of(tout) == rows_of(jout)
    with pytest.raises(NotImplementedError, match=r"array\(bigint\)"):
        tmerge(shards_t, [tcommon.SortKey(1)])


def test_host_minmax_skips_arrays_and_limb_planes():
    """runtime/local_planner.py `_host_minmax`: neither an array nor a long
    decimal has a scalar range; a bigint column does, as in the JAX package."""
    jb, tb = _key_batches(9)
    for ch in (0, 1, 2):
        j = j_host_minmax([jb], ch)
        t = t_host_minmax([tb], ch)
        assert (t is None) == (j is None)
        if j is not None:
            assert (int(t[0]), int(t[1])) == (int(j[0]), int(j[1]))
    assert t_host_minmax([tb], 1) is None


# -- SQL ------------------------------------------------------------------------


class SqlParity:
    """The JAX LocalQueryRunner (each statement's result computed once) and
    the port's local runner and 4-worker mesh, at tpch.tiny."""

    def __init__(self):
        self.jax = JaxRunner(catalog="tpch", schema="tiny", target_splits=2)
        self.local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
        self.mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        self._expected = {}

    def runner(self, where: str):
        return self.local if where == "local" else self.mesh

    def expected(self, sql: str):
        if sql not in self._expected:
            self._expected[sql] = self.jax.execute(sql)
        return self._expected[sql]

    def check(self, sql: str, where: str, order_free_arrays: bool = False):
        """Run `sql` through the port's `where` runner and hold it to the JAX
        rows (under the statement's ORDER BY; arrays sorted first when
        `order_free_arrays`: an array_agg without ORDER BY has no defined
        element order).  Returns the JAX rows."""
        expected = self.expected(sql)
        actual = self.runner(where).execute(sql)
        assert actual.column_names == expected.column_names
        assert [t.name for t in actual.types] == [t.name for t in expected.types]
        exp_rows, act_rows = expected.rows, actual.rows
        if order_free_arrays:
            exp_rows, act_rows = _sorted_arrays(exp_rows), _sorted_arrays(act_rows)
        order = result_order(self.local.create_plan(sql))
        assert_rows_match(act_rows, exp_rows, order, float_rtol=1e-9)
        return expected.rows

    def check_raises(self, sql: str, where: str, match: str):
        """The JAX package fails on `sql` (any error: some are shape
        errors); the port raises NotImplementedError naming the piece."""
        with pytest.raises(Exception):
            self.jax.execute(sql)
        with pytest.raises(NotImplementedError, match=match):
            self.runner(where).execute(sql)


def _sorted_arrays(rows):
    return [
        tuple(sorted(v, key=repr) if isinstance(v, list) else v for v in r) for r in rows
    ]


@pytest.fixture(scope="module")
def parity():
    return SqlParity()


#: every statement of tests/test_arrays_unnest.py and tests/test_maps.py
SQL = {
    # array constructor and subscript
    "subscript": "SELECT ARRAY[1,2,3][2]",
    "varchar_subscript": "SELECT ARRAY['a','b'][1]",
    "subscript_past_end": "SELECT ARRAY[1,2][5]",
    "subscript_zero": "SELECT ARRAY[1,2][0]",
    "array_output": "SELECT ARRAY[1,2,3]",
    "array_sort": "SELECT array_sort(ARRAY[3,1,2])",
    "cardinality_element_at_contains": (
        "SELECT cardinality(ARRAY[1,2,3]), element_at(ARRAY[10,20], 3), "
        "contains(ARRAY[1,2], 2), contains(ARRAY['x','y'], 'z')"
    ),
    "element_at_negative": (
        "SELECT element_at(ARRAY[10,20,30], -1), element_at(ARRAY[10,20,30], -3), "
        "element_at(ARRAY[10,20,30], -4)"
    ),
    "json_nonfinite": """SELECT json_extract_scalar('{"a": Infinity}', '$.a')""",
    "position_minmax_distinct": (
        "SELECT array_position(ARRAY[5,7,9], 9), array_max(ARRAY[3,1,2]), "
        "array_min(ARRAY[3,1,2]), array_distinct(ARRAY[3,1,3,2])"
    ),
    "sequence": "SELECT sequence(1,5)",
    "sequence_step": "SELECT sequence(5,1,-2)",
    "repeat": "SELECT repeat(7, 3)",
    "split": "SELECT split('a,b,c', ',')",
    "split_subscript": "SELECT split('a,b,c', ',')[2]",
    "split_no_delimiter": "SELECT split('abc', 'x')",
    "array_through_project": (
        "SELECT n_nationkey k, ARRAY[n_nationkey, n_regionkey][2] FROM nation "
        "WHERE n_nationkey < 3 ORDER BY k"
    ),
    # UNNEST
    "unnest_standalone": "SELECT * FROM UNNEST(ARRAY[1,2,3])",
    "unnest_zip_ordinality": "SELECT * FROM UNNEST(ARRAY[1,2], ARRAY[10,20,30]) WITH ORDINALITY",
    "unnest_correlated": (
        "SELECT t.x, u.e FROM (VALUES (1), (2)) t(x) "
        "CROSS JOIN UNNEST(sequence(1, 2)) u(e) ORDER BY t.x, u.e"
    ),
    "unnest_split_correlated": (
        "SELECT s, e FROM (VALUES ('a,b'), ('c')) t(s) "
        "CROSS JOIN UNNEST(split(s, ',')) u(e) ORDER BY s, e"
    ),
    "unnest_aggregation": "SELECT sum(e) FROM UNNEST(sequence(1,100)) u(e)",
    "unnest_over_table": "SELECT count(*) FROM nation CROSS JOIN UNNEST(ARRAY[1,2,3]) u(e)",
    "unnest_distributed_sum": (
        "SELECT sum(e * l_quantity) FROM lineitem "
        "CROSS JOIN UNNEST(ARRAY[1,2]) u(e) WHERE l_orderkey < 100"
    ),
    "unnest_rows_distributed": (
        "SELECT l_orderkey, e FROM lineitem "
        "CROSS JOIN UNNEST(ARRAY[1,2]) u(e) WHERE l_orderkey < 10"
    ),
    # JSON
    "json_extract_scalar_nested": """SELECT json_extract_scalar('{"a": {"b": 7}}', '$.a.b')""",
    "json_extract_scalar_index": """SELECT json_extract_scalar('{"a": [10, 20]}', '$.a[1]')""",
    "json_extract_scalar_missing": """SELECT json_extract_scalar('{"a": 1}', '$.missing')""",
    "json_extract": """SELECT json_extract('{"a": {"b": [1, 2]}}', '$.a.b')""",
    "json_array_length": "SELECT json_array_length('[1,2,3]')",
    "json_array_length_object": "SELECT json_array_length('{}')",
    "json_size": """SELECT json_size('{"a": {"x": 1, "y": 2}}', '$.a')""",
    "json_over_column": (
        """SELECT json_extract_scalar(j, '$.k') FROM """
        """(VALUES ('{"k": "v1"}'), ('{"k": "v2"}'), ('broken')) t(j)"""
    ),
    "array_is_null": (
        "select arr is null, arr is not null from "
        "(select slice(array[x, x], if(x = 1, 1), 2) arr from (values 1, 2) t(x))"
    ),
    "array_is_null_in_where": (
        "select cardinality(arr) from "
        "(select slice(array[x, x], if(x <> 2, 1), 2) arr "
        "from (values 1, 2, 3) t(x)) where arr is not null order by 1"
    ),
    # maps (tests/test_maps.py)
    "map_subscript": "select map(array['a','b'], array[1,2])['b']",
    "map_element_at_missing": "select element_at(map(array['x'], array[10]), 'y')",
    "map_keys_values_cardinality": (
        "select cardinality(m), map_keys(m), map_values(m) "
        "from (select map(array[1,2,3], array[40,50,60]) m)"
    ),
    "map_concat": (
        "select map_concat(map(array[1,2], array[10,20]), map(array[2,3], array[99,30]))"
    ),
    "map_string_values": "select map(array[1,2], array['x','y'])[2]",
    "map_mismatched_lengths": "select map(array[1,2], array[5])",
    "map_over_table_rows": (
        "select map(array[n_nationkey], array[n_regionkey])[n_nationkey] r, "
        "n_regionkey from nation order by n_nationkey limit 3"
    ),
    # the lambda, set and slice functions the JAX package answers
    "lambdas": (
        "select transform(array[1,2], x -> x * 2.5), reduce(array[1,2,3], 0, (s, x) -> s + x, s -> s), "
        "filter(array[1,2,3,4], x -> x % 2 = 0), any_match(array[1,2], x -> x > 1), "
        "all_match(array[1,2], x -> x > 1), none_match(array[1,2], x -> x > 5), "
        "zip_with(array[1,2], array[3,4], (x, y) -> x + y)"
    ),
    "lambda_captures_column": (
        "select n_nationkey, transform(array[n_nationkey, n_regionkey], x -> x + n_nationkey), "
        "filter(array[n_nationkey, n_regionkey, 3], x -> x > n_regionkey) "
        "from nation order by n_nationkey limit 6"
    ),
    "set_functions": (
        "select arrays_overlap(array[1,2], array[2,3]), array_intersect(array[1,2,2,3], array[2,3,4]), "
        "array_except(array[1,2,3], array[2]), array_union(array[1,2], array[2,3]), "
        "slice(array[1,2,3,4], 2, 2), array[1,2] || array[3]"
    ),
    "reduce_over_double_elements": (
        "select n_regionkey, reduce(array[n_nationkey * 0.5e0, 2.25e0], 0, (s, x) -> s + x, s -> s * 2) "
        "from nation order by n_nationkey limit 5"
    ),
}

#: the 2-D sites as SQL: statements over a long decimal that must give the
#: JAX package's rows
LONG_DECIMAL_SQL = {
    "window_partition_key": (
        "select o_orderkey, d, row_number() over (partition by d order by o_orderkey) "
        "from (select o_orderkey, cast(o_custkey % 3 as decimal(30,0)) d from orders) "
        "order by o_orderkey limit 20"
    ),
    "window_lag": (
        "select o_orderkey, lag(d) over (order by o_orderkey) from (select o_orderkey, "
        "cast(o_totalprice as decimal(30,2)) d from orders) order by o_orderkey limit 20"
    ),
    "window_frame_sum": (
        "select o_orderstatus, sum(d) over (partition by o_orderstatus) from (select o_orderstatus, "
        "cast(o_totalprice as decimal(30,2)) d from orders)"
    ),
    "group_key": (
        "select d, count(*) from (select cast(o_custkey % 7 as decimal(30,0)) d from orders) "
        "group by d order by d"
    ),
    "aggregate_min_max": (
        "select o_orderstatus, min(d), max(d), count(d) from (select o_orderstatus, "
        "cast(o_totalprice as decimal(30,2)) d from orders) group by 1 order by 1"
    ),
}

#: the same sites over an array column: the rows the JAX package gives ...
ARRAY_SITE_SQL = {
    "window_frame_count": (
        "select n_nationkey, count(a) over (partition by n_regionkey) from "
        "(select n_nationkey, n_regionkey, array[n_nationkey] a from nation) order by 1"
    ),
    "aggregate_count": (
        "select count(a), min(n_nationkey) from "
        "(select array[n_regionkey] a, n_nationkey from nation)"
    ),
    "sort_payload": (
        "select n_name, a from (select n_name, n_nationkey, array[n_regionkey, n_nationkey] a "
        "from nation) order by n_nationkey desc limit 3"
    ),
    "window_payload": (
        "select n_name, a, row_number() over (partition by n_regionkey order by n_nationkey) "
        "from (select n_name, n_regionkey, n_nationkey, array[n_nationkey] a from nation) "
        "order by n_name"
    ),
}

#: ... and those where the JAX package fails (a shape error, or for min/max
#: and stddev a scalar read of the padded slots): the port raises by name
ARRAY_SITE_RAISES = {
    "group_key": (
        "select a, count(*) from (select array[n_regionkey] a from nation) group by a",
        r"key of type array\(bigint\)",
    ),
    "window_order_key": (
        "select rank() over (order by a) from (select array[n_regionkey] a from nation)",
        r"key of type array\(bigint\)",
    ),
    "window_partition_key": (
        "select row_number() over (partition by a order by n_nationkey) "
        "from (select n_nationkey, array[n_regionkey] a from nation)",
        r"key of type array\(bigint\)",
    ),
    "window_lag": (
        "select lag(a) over (order by n_nationkey) "
        "from (select n_nationkey, array[n_regionkey] a from nation)",
        r"window lag over an array\(bigint\) column",
    ),
    "aggregate_any_value": (
        "select any_value(a) from (select array[n_regionkey] a from nation where n_nationkey = 3)",
        r"any_value over an array\(bigint\) column",
    ),
    "varchar_array_group_key": (
        # dictionary-coded, so the small-domain direct path would take it
        "select a, count(*) from (select split(n_name, ' ') a from nation) group by a",
        r"key of type array\(varchar\)",
    ),
    "join_key": (
        "select count(*) from (select array[n_regionkey] a from nation) x "
        "join (select array[r_regionkey] b from region) y on a = b",
        r"key of type array\(bigint\)",
    ),
    "comparison": (
        "select count(*) from (select array[n_regionkey] a from nation) where a = array[1]",
        r"comparison of array\(bigint\) values",
    ),
    "if_over_arrays": (
        "select if(n_nationkey > 2, array[1], array[2, 3]) from nation",
        r"IF/CASE over array\(integer\) values",
    ),
    # an element slot holds one int64, not two limb planes
    "long_decimal_elements": (
        "select array[cast(l_extendedprice as decimal(30,2))] from lineitem limit 1",
        r"arrays of decimal\(30,2\) elements",
    ),
    "transform_to_long_decimal": (
        "select sum(reduce(transform(array[l_quantity, l_discount, l_tax], x -> x * 2), "
        "0, (s, x) -> s + x, s -> s)) from lineitem",
        r"arrays of decimal\(22,2\) elements",
    ),
}


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(SQL))
def test_array_sql_matches_jax(parity, name, where):
    parity.check(SQL[name], where)


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(LONG_DECIMAL_SQL))
def test_long_decimal_at_2d_sites_matches_jax(parity, name, where):
    assert parity.check(LONG_DECIMAL_SQL[name], where)


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", list(ARRAY_SITE_SQL))
def test_array_at_2d_sites_matches_jax(parity, name, where):
    assert parity.check(ARRAY_SITE_SQL[name], where)


@pytest.mark.parametrize("name", list(ARRAY_SITE_RAISES))
def test_array_at_2d_sites_raises_by_name(parity, name):
    sql, match = ARRAY_SITE_RAISES[name]
    parity.check_raises(sql, "local", match)


@pytest.mark.parametrize("sql", [
    "select max(a) from (select array[n_regionkey] a from nation)",
    "select stddev(a) from (select array[n_regionkey] a from nation)",
], ids=["max", "stddev"])
def test_aggregate_over_an_array_raises_where_jax_reads_padded_slots(parity, sql):
    """The JAX package answers these with a scalar read of the padded slots
    (max gives 4, stddev 0.0): wrong rows, so the port raises by name."""
    with pytest.raises(NotImplementedError, match=r"over an array\(bigint\) column"):
        parity.local.execute(sql)


@pytest.mark.parametrize("form", ["ROW", "DEREFERENCE"])
def test_row_and_dereference_still_raise(form):
    """The JAX package has no handler for these forms; the port raises by
    name."""
    (jb, tb), _ = _form_batches(3)
    jf = jir.SpecialForm(getattr(jir.Form, form), [jir.InputRef(0, JT.BIGINT)], JT.BIGINT)
    tf = tir.SpecialForm(getattr(tir.Form, form), [tir.InputRef(0, TT.BIGINT)], TT.BIGINT)
    with pytest.raises(AttributeError):
        JCompiler(jb).column(jf)
    with pytest.raises(NotImplementedError, match=f"special form {form.lower()}"):
        TCompiler(tb).column(tf)

"""The port's window operator (trino_tpu_torch/ops/window.py) against the JAX
package's (trino_tpu/ops/window.py) on the same seeded numpy batches.

Each batch holds a BIGINT partition key and a BIGINT order key (both with
NULLs and ties), dead rows, and value columns: BIGINT, DOUBLE,
decimal(12,2), decimal(38,2) as limb planes (magnitudes past 2**64 on the
limb path), dictionary-coded VARCHAR, a BIGINT default and a VARCHAR
default coded in another dictionary.  Both operators' `process` see the
same batch (the JAX package pads it to a power of two; the port does not),
and every output column of every live row must agree:

  * the rank family (row_number, rank, dense_rank, percent_rank,
    cume_dist, ntile) under partition and order keys, order keys only,
    partition keys only and none;
  * lag and lead, with offsets, integer defaults and string defaults
    across two dictionaries, with and without IGNORE NULLS;
  * first_value, last_value and nth_value, with and without IGNORE NULLS,
    under the RANGE running frame, bounded and unbounded ROWS frames, a
    frame wholly after the row, the whole partition and no ORDER BY;
  * count, count(*), sum, avg, min and max over every frame, and min/max
    over strings;
  * sum and avg over long decimals on their three paths (the licensed
    single plane, segment_sum128 for whole frames, the four-chunk prefix
    for running frames), and min/max over them raising in both.

Integers, decimals and strings must be equal; a NULL's value slot is not
compared.  Doubles (avg over BIGINT and DOUBLE, sum over DOUBLE,
percent_rank, cume_dist) agree to 1e-9 of the batch's absolute sum: a
running frame's sum is a difference of two prefix sums over the sorted
batch, each as large as the sum of |x| before the frame's end, and the two
packages add them in their own order.

As SQL at tpch.tiny, against the JAX package's LocalQueryRunner:

  * the 32 cases of tests/test_window.py through both LocalQueryRunners
    (the memory-connector tables of the IGNORE NULLS and long-decimal cases
    become VALUES relations with the same rows: the memory connector is
    not ported); the rejected statements raise the same error class with
    the same message in both;
  * the partitioned cases and the IGNORE NULLS cases also on the port's
    4-worker mesh, held to the same JAX local result (a partitioned window
    runs per worker over rows repartitioned on its keys; a window with no
    PARTITION BY and one over VALUES run in a coordinator fragment);
  * lag and lead with a string default coded in another dictionary, local
    and mesh;
  * INTERSECT ALL and EXCEPT ALL (lowered through a row_number window over
    a tagged union) over VALUES with duplicates and NULLs and over tables,
    local and mesh.

SQL rows compare under the statement's ORDER BY, or as a multiset without
one (trino_tpu_torch.testing); integers, decimals and strings exact,
doubles relative 1e-9.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar import StringDictionary as JDict
from trino_tpu.ops.common import SortKey as JKey
from trino_tpu.ops.window import WindowOperator as JWindow, WindowSpec as JSpec
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.columnar import StringDictionary as TDict
from trino_tpu_torch.ops.aggregation import DECIMAL_FASTPATH
from trino_tpu_torch.ops.common import SortKey as TKey
from trino_tpu_torch.ops.window import WindowOperator as TWindow, WindowSpec as TSpec
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)

N = 200  # not a power of two: the JAX package pads to 256, the port does not
DOUBLE_RTOL = 1e-9

#: channels of the seeded batch
PART, ORD, INT, DBL, SDEC, LDEC, STR, DEF_INT, DEF_STR = range(9)
WORDS = ["ant", "bee", "cat", "dog", "eel", "fox"]
OTHER_WORDS = ["bee", "yak", "zebu"]  # the string default's own dictionary


def _column_types(pkg):
    return [
        pkg.BIGINT, pkg.BIGINT, pkg.BIGINT, pkg.DOUBLE, pkg.DecimalType(12, 2),
        pkg.DecimalType(38, 2), pkg.VARCHAR, pkg.BIGINT, pkg.VARCHAR,
    ]


def _numpy_columns(seed: int, big_decimals: bool):
    """(values, valid) per channel, and the live-row mask."""
    rng = np.random.default_rng(seed)
    n = N

    def nulls(share):
        return rng.random(n) >= share

    ldec = rng.integers(-(10**11), 10**11, n).astype(np.int64)
    hi = (ldec >> 63).astype(np.int64)  # sign extension: a value inside int64
    if big_decimals:
        # values past 2**64: nonzero high limbs of both signs
        hi = rng.integers(-(2**20), 2**20, n).astype(np.int64)
        ldec = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64)
    cols = [
        (rng.integers(0, 4, n).astype(np.int64), nulls(0.1)),
        (rng.integers(0, 6, n).astype(np.int64), nulls(0.1)),
        (rng.integers(-1000, 1000, n).astype(np.int64), nulls(0.25)),
        (rng.normal(0.0, 100.0, n), nulls(0.25)),
        (rng.integers(-10**8, 10**8, n).astype(np.int64), nulls(0.25)),
        (np.stack([hi, ldec], axis=-1), nulls(0.25)),
        (rng.integers(0, len(WORDS), n).astype(np.int32), nulls(0.25)),
        (rng.integers(-5, 5, n).astype(np.int64), nulls(0.3)),
        (rng.integers(0, len(OTHER_WORDS), n).astype(np.int32), nulls(0.3)),
    ]
    mask = rng.random(n) >= 0.15
    return cols, mask


def make_batches(seed: int, big_decimals: bool = False):
    """The same seeded batch as a JAX Batch and as a port Batch."""
    cols, mask = _numpy_columns(seed, big_decimals)
    jdicts = {STR: JDict(WORDS), DEF_STR: JDict(OTHER_WORDS)}
    tdicts = {STR: TDict(WORDS), DEF_STR: TDict(OTHER_WORDS)}
    jcols, tcols = [], []
    for ch, ((values, valid), jt, tt) in enumerate(
        zip(cols, _column_types(JT), _column_types(TT))
    ):
        jcols.append(JColumn(jnp.asarray(values), jt, jnp.asarray(valid), jdicts.get(ch)))
        tcols.append(
            TColumn(torch.from_numpy(values.copy()), tt, torch.from_numpy(valid.copy()), tdicts.get(ch))
        )
    return JBatch(jcols, jnp.asarray(mask)), TBatch(tcols, torch.from_numpy(mask)), cols


KEYS = {
    "part_order": ([PART], [(ORD, True, False)]),
    "order_desc_nulls_first": ([], [(ORD, False, True)]),
    "part_only": ([PART], []),
    "none": ([], []),
}

#: (name, arg, out type name, extra WindowSpec fields)
RANKS = [
    ("row_number", None, "bigint", {}),
    ("rank", None, "bigint", {}),
    ("dense_rank", None, "bigint", {}),
    ("percent_rank", None, "double", {}),
    ("cume_dist", None, "double", {}),
    ("ntile", None, "bigint", {"n_buckets": 3}),
    ("ntile", None, "bigint", {"n_buckets": 7}),
]

NAVIGATION = [
    ("lag", INT, "bigint", {}),
    ("lead", INT, "bigint", {"offset": 2}),
    ("lag", INT, "bigint", {"offset": 3, "default_channel": DEF_INT}),
    ("lead", INT, "bigint", {"default_channel": DEF_INT}),
    ("lag", DBL, "double", {}),
    ("lead", STR, "varchar", {"offset": 2}),
    ("lag", STR, "varchar", {"default_channel": DEF_STR}),
    ("lead", STR, "varchar", {"offset": 3, "default_channel": DEF_STR}),
    ("lag", LDEC, "decimal(38,2)", {}),
    ("lead", SDEC, "decimal(12,2)", {"offset": 4}),
]


def _ignoring(specs):
    return [(n, a, t, {**kw, "ignore_nulls": True}) for n, a, t, kw in specs]


def _values(frame_kw):
    out = []
    for name in ("first_value", "last_value", "nth_value"):
        for arg, t in ((INT, "bigint"), (STR, "varchar"), (DBL, "double")):
            kw = dict(frame_kw)
            if name == "nth_value":
                kw["offset"] = 2
            out.append((name, arg, t, kw))
    return out


def _aggregates(frame_kw):
    out = [("count", None, "bigint", frame_kw)]
    for name, arg, t in (
        ("count", INT, "bigint"), ("count", LDEC, "bigint"),
        ("sum", INT, "bigint"), ("avg", INT, "double"),
        ("sum", DBL, "double"), ("avg", DBL, "double"),
        ("sum", SDEC, "decimal(18,2)"), ("avg", SDEC, "decimal(12,2)"),
        ("min", INT, "bigint"), ("max", INT, "bigint"),
        ("min", DBL, "double"), ("max", DBL, "double"),
        ("min", STR, "varchar"), ("max", STR, "varchar"),
        ("min", SDEC, "decimal(12,2)"), ("max", SDEC, "decimal(12,2)"),
    ):
        out.append((name, arg, t, frame_kw))
    return out


FRAMES = {
    "range": {},
    "rows_2p_1f": {"frame": "rows", "start_off": -2, "end_off": 1},
    "rows_unb_cur": {"frame": "rows", "start_off": None, "end_off": 0},
    "rows_1p_unb": {"frame": "rows", "start_off": -1, "end_off": None},
    "rows_1f_3f": {"frame": "rows", "start_off": 1, "end_off": 3},
    "full": {"frame": "full", "start_off": None, "end_off": None},
}


def _long_decimal(frame_kw, licensed: bool):
    kw = dict(frame_kw)
    if licensed:
        kw["sum_bound"] = 10**15  # every |value| < 10**11, N rows a frame at most
    return [
        ("sum", LDEC, "decimal(38,2)", kw),
        ("avg", LDEC, "decimal(38,2)", kw),
        ("sum", LDEC, "decimal(18,2)", kw) if licensed else ("count", LDEC, "bigint", kw),
    ]


OPERATOR_CASES = {}
for _k in KEYS:
    OPERATOR_CASES[f"ranks-{_k}"] = (_k, RANKS, False)
for _k in ("part_order", "order_desc_nulls_first"):
    OPERATOR_CASES[f"navigation-{_k}"] = (_k, NAVIGATION, False)
    OPERATOR_CASES[f"navigation_ignore_nulls-{_k}"] = (_k, _ignoring(NAVIGATION), False)
for _f, _kw in FRAMES.items():
    OPERATOR_CASES[f"values-{_f}"] = ("part_order", _values(_kw), False)
    OPERATOR_CASES[f"values_ignore_nulls-{_f}"] = ("part_order", _ignoring(_values(_kw)), False)
    OPERATOR_CASES[f"aggregates-{_f}"] = ("part_order", _aggregates(_kw), False)
for _k in ("part_only", "none"):
    OPERATOR_CASES[f"values-no_order-{_k}"] = (_k, _values({}) + _ignoring(_values({})), False)
    OPERATOR_CASES[f"aggregates-no_order-{_k}"] = (_k, _aggregates({}), False)
for _f in ("range", "rows_2p_1f", "rows_unb_cur", "full"):
    OPERATOR_CASES[f"long_decimal_licensed-{_f}"] = ("part_order", _long_decimal(FRAMES[_f], True), False)
    OPERATOR_CASES[f"long_decimal_limbs-{_f}"] = ("part_order", _long_decimal(FRAMES[_f], False), True)
OPERATOR_CASES["long_decimal_limbs-no_order"] = ("part_only", _long_decimal({}, False), True)


def _type(pkg, name: str):
    if name.startswith("decimal"):
        p, s = name[len("decimal("):-1].split(",")
        return pkg.DecimalType(int(p), int(s))
    return {"bigint": pkg.BIGINT, "double": pkg.DOUBLE, "varchar": pkg.VARCHAR}[name]


def run_both(keys: str, specs, seed: int, big_decimals: bool):
    """Both operators' outputs over one seeded batch: (JAX Batch, port
    Batch, the numpy columns)."""
    jb, tb, cols = make_batches(seed, big_decimals)
    part, order = KEYS[keys]
    jop = JWindow(
        part, [JKey(c, a, nf) for c, a, nf in order],
        [JSpec(n, a, _type(JT, t), **kw) for n, a, t, kw in specs],
    )
    top = TWindow(
        part, [TKey(c, a, nf) for c, a, nf in order],
        [TSpec(n, a, _type(TT, t), **kw) for n, a, t, kw in specs],
    )
    (jout,) = list(jop.process(iter([jb])))
    (tout,) = list(top.process(iter([tb])))
    return jout, tout, cols


def _decoded(col, data, valid):
    if col.dictionary is None:
        return data
    values = np.asarray(col.dictionary.values, dtype=object)
    return np.where(valid, values[np.clip(data, 0, len(values) - 1)], None)


def assert_window_outputs_match(jout, tout, cols, specs):
    live = np.asarray(tout.mask()[:N])
    np.testing.assert_array_equal(live, np.asarray(jout.mask())[:N])
    dbl_scale = float(np.abs(np.where(cols[DBL][1], cols[DBL][0], 0.0)).sum())
    int_scale = float(np.abs(np.where(cols[INT][1], cols[INT][0], 0)).sum())
    width = len(cols)
    assert tout.width == jout.width == width + len(specs)
    for i, spec in enumerate(specs):
        jc, tc = jout.columns[width + i], tout.columns[width + i]
        assert tc.type.name == jc.type.name, spec
        tv = np.ones(N, bool) if tc.valid is None else tc.valid[:N].numpy()
        jv = np.ones(N, bool) if jc.valid is None else np.asarray(jc.valid)[:N]
        np.testing.assert_array_equal(tv[live], jv[live], err_msg=str(spec))
        both = live & tv
        td = tc.data[:N].numpy()
        jd = np.asarray(jc.data)[:N]
        assert td.dtype == jd.dtype, (spec, td.dtype, jd.dtype)
        if td.dtype.kind == "f":
            scale = dbl_scale if spec[1] == DBL else max(int_scale, 1.0)
            err = np.abs(td[both] - jd[both])
            assert (err <= DOUBLE_RTOL * max(scale, 1.0)).all(), (spec, err.max())
        else:
            np.testing.assert_array_equal(
                _decoded(tc, td, tv)[both], _decoded(jc, jd, jv)[both], err_msg=str(spec)
            )


@pytest.mark.parametrize("case", list(OPERATOR_CASES))
def test_window_functions_match_jax(case):
    keys, specs, big = OPERATOR_CASES[case]
    seed = sum(map(ord, case)) % 1000
    jout, tout, cols = run_both(keys, specs, seed, big)
    assert_window_outputs_match(jout, tout, cols, specs)


@pytest.mark.parametrize("licensed", [True, False], ids=["licensed", "limbs"])
def test_long_decimal_avg_notes_its_path(licensed):
    """The port counts each long-decimal sum/avg's path, as the JAX
    package's telemetry does (`_note_fastpath`)."""
    specs = _long_decimal(FRAMES["full"], licensed)[:2]
    before = dict(DECIMAL_FASTPATH)
    jout, tout, cols = run_both("part_order", specs, 5, not licensed)
    assert_window_outputs_match(jout, tout, cols, specs)
    path = "proven" if licensed else "limb"
    assert DECIMAL_FASTPATH.get(path, 0) - before.get(path, 0) == 2


@pytest.mark.parametrize("name", ["min", "max"])
def test_long_decimal_min_max_raise_in_both(name):
    specs = [(name, LDEC, "decimal(38,2)", {})]
    with pytest.raises(NotImplementedError, match="long-decimal input column"):
        run_both("part_order", specs, 3, False)
    jb, tb, _ = make_batches(3, False)
    with pytest.raises(NotImplementedError, match="long-decimal input column"):
        list(JWindow([PART], [JKey(ORD)], [JSpec(name, LDEC, JT.DecimalType(38, 2))]).process(iter([jb])))


def test_all_rows_dead_and_a_single_row():
    """A batch whose rows are all dead, and one live row, through both."""
    specs = RANKS[:3] + _aggregates({})[:4]
    jb, tb, cols = make_batches(11, False)
    for keep in (np.zeros(N, bool), np.arange(N) == 17):
        jb2 = JBatch(jb.columns, jnp.asarray(keep))
        tb2 = TBatch(tb.columns, torch.from_numpy(keep))
        part, order = KEYS["part_order"]
        (jout,) = list(JWindow(part, [JKey(c, a, nf) for c, a, nf in order],
                               [JSpec(n, a, _type(JT, t), **kw) for n, a, t, kw in specs]
                               ).process(iter([jb2])))
        (tout,) = list(TWindow(part, [TKey(c, a, nf) for c, a, nf in order],
                               [TSpec(n, a, _type(TT, t), **kw) for n, a, t, kw in specs]
                               ).process(iter([tb2])))
        assert_window_outputs_match(jout, tout, cols, specs)


# -- SQL ------------------------------------------------------------------------

_IGN = "(values (1, 10), (2, null), (3, null), (4, 40), (5, null)) t(i, x)"
_IGN2 = (
    "(values (1, 1, 'a'), (1, 2, null), (1, 3, 'c'), (1, 4, null), (1, 5, null), "
    "(2, 1, null), (2, 2, 'z')) t(g, i, x)"
)
_WLD = (
    "(values (1, cast(10.50 as decimal(38,2))), (1, cast(null as decimal(38,2))), "
    "(1, cast(2.25 as decimal(38,2))), (2, cast(null as decimal(38,2))), "
    "(2, cast(null as decimal(38,2)))) t(k, x)"
)
_UNION123 = "(select 1 x union all select 2 union all select 3) t"
_UNION1223 = "(select 1 x union all select 2 union all select 2 union all select 3) t"

#: name -> (SQL, also on the mesh): the statements of tests/test_window.py
SQL_CASES = {
    "row_number_rank": (
        "select n_name, n_regionkey, row_number() over "
        "(partition by n_regionkey order by n_name) rn from nation", True,
    ),
    "rank_with_ties": (
        "select x, rank() over (order by x), dense_rank() over (order by x) "
        "from (select 1 x union all select 1 union all select 2 union all select 3) t",
        False,
    ),
    "running_sum": (f"select x, sum(x) over (order by x) from {_UNION1223}", False),
    "partition_total": (
        "select distinct o_custkey, count(*) over (partition by o_custkey) from orders",
        True,
    ),
    "lag_lead": (
        "select x, lag(x) over (order by x), lead(x, 1, 99) over (order by x) "
        f"from {_UNION123}", False,
    ),
    "ntile": (f"select x, ntile(2) over (order by x) from {_UNION123}", False),
    "row_number_no_keys_filtered": (
        "select n_name, row_number() over () rn from nation where n_regionkey = 2",
        False,
    ),
    "rows_frame_running_sum_with_ties": (
        "select x, sum(x) over (order by x rows between unbounded preceding "
        f"and current row) from {_UNION1223}", False,
    ),
    "rows_frame_bounded_avg": (
        "select x, avg(x) over (order by x rows between 1 preceding and 1 following) "
        "from (select 1 x union all select 2 union all select 4 union all select 8) t",
        False,
    ),
    "rows_frame_count_star_bounded": (
        "select x, count(*) over (order by x rows between 1 preceding and current row) "
        f"from {_UNION123}", False,
    ),
    "last_value_rows_running": (
        "select x, last_value(x) over (order by x rows between unbounded "
        "preceding and current row) from "
        "(select 1 x union all select 2 union all select 2) t", False,
    ),
    "avg_over_partition": (
        "select distinct s_nationkey, avg(s_acctbal) over (partition by s_nationkey) "
        "from supplier", True,
    ),
    "bounded_rows_frame_min_max": (
        "select n_nationkey, "
        "min(n_nationkey) over (partition by n_regionkey order by n_nationkey "
        "  rows between 2 preceding and 1 following), "
        "max(n_nationkey) over (partition by n_regionkey order by n_nationkey "
        "  rows between 1 preceding and current row) "
        "from nation order by n_regionkey, n_nationkey", True,
    ),
    "named_window_clause": (
        "select n_name, rank() over w, "
        "sum(n_nationkey) over (w rows between 1 preceding and current row) "
        "from nation where n_regionkey = 1 "
        "window w as (partition by n_regionkey order by n_nationkey) "
        "order by n_nationkey", True,
    ),
    "named_window_inheritance_chain": (
        "select n_name, row_number() over w2 from nation where n_regionkey=2 "
        "window w as (partition by n_regionkey), "
        "w2 as (w order by n_name desc) order by n_name limit 2", True,
    ),
    "ignore_nulls_navigation": (
        "select i, lag(x) ignore nulls over (order by i), "
        "lead(x) ignore nulls over (order by i), "
        "first_value(x) ignore nulls over (order by i), "
        f"last_value(x) ignore nulls over (order by i) from {_IGN} order by i", True,
    ),
    "ignore_nulls_lag_offset_and_partition": (
        "select g, i, lag(x, 2) ignore nulls over (partition by g order by i) "
        f"from {_IGN2} order by g, i", True,
    ),
    "ignore_nulls_respect_default": (
        f"select i, lag(x) respect nulls over (order by i) from {_IGN} order by i", False,
    ),
    "ignore_nulls_distributed": (
        "select l_orderkey, l_linenumber, lag(l_comment) ignore nulls "
        "over (partition by l_returnflag order by l_orderkey, l_linenumber) "
        "from lineitem order by 1, 2 limit 20", True,
    ),
    "nth_value": (
        "select n_nationkey, nth_value(n_name, 2) over "
        "(partition by n_regionkey order by n_nationkey "
        "rows between unbounded preceding and unbounded following) "
        "from nation where n_regionkey = 1 order by n_nationkey", True,
    ),
    "nth_value_running": (f"select x, nth_value(x, 2) over (order by x) from {_UNION123}", False),
    "nth_value_ignore_nulls": (
        "select i, nth_value(x, 2) ignore nulls over "
        "(order by i rows between unbounded preceding and unbounded following) "
        f"from {_IGN} order by i", True,
    ),
    "window_sum_over_long_decimal": (
        "select l_returnflag, s, sum(s) over (partition by l_returnflag) "
        "from (select l_returnflag, l_linestatus, "
        "      sum(l_extendedprice) s from lineitem "
        "      group by l_returnflag, l_linestatus) t", True,
    ),
    "window_running_sum_long_decimal": (
        "select l_linestatus, sum(s) over (order by l_linestatus) "
        "from (select l_linestatus, sum(l_extendedprice) s "
        "      from lineitem group by l_linestatus) t", False,
    ),
    "window_avg_long_decimal": (
        "select l_returnflag, avg(s) over (partition by l_returnflag) "
        "from (select l_returnflag, l_linestatus, "
        "      sum(l_extendedprice) s from lineitem "
        "      group by l_returnflag, l_linestatus) t", True,
    ),
    "window_long_decimal_null_inputs": (
        f"select k, sum(x) over (partition by k), avg(x) over (partition by k) from {_WLD}",
        True,
    ),
}

#: name -> SQL: the statements tests/test_window.py expects to be rejected
REJECTED = {
    "unsupported_frame": (
        "select sum(x) over (order by x range between 1 preceding and "
        "current row) from (select 1 x) t"
    ),
    "frame_without_order": (
        "select sum(x) over (rows between unbounded preceding and "
        "current row) from (select 1 x) t"
    ),
    "named_window_undefined": "select rank() over wz from nation",
    "ignore_nulls_invalid_function": (
        "select rank() ignore nulls over (order by n_nationkey) from nation"
    ),
    "null_treatment_requires_over": "select max(n_nationkey) ignore nulls from nation",
    "duplicate_window_name": (
        "select rank() over w from nation "
        "window w as (order by n_name), w as (order by n_regionkey)"
    ),
    "nth_value_without_n": "select nth_value(n_name) over (order by n_nationkey) from nation",
    "nth_value_zero": "select nth_value(n_name, 0) over (order by n_nationkey) from nation",
}

_DICT_DEFAULT = (
    "select n_nationkey, lag(n_name, 1, 'zz-none') over (partition by n_regionkey "
    "order by n_nationkey), lead(n_name, 2, r_name) over (partition by n_regionkey "
    "order by n_name desc) from nation join region on n_regionkey = r_regionkey"
)

_DUPS_A = "(values 1, 1, 2, 3, 3, 3, null, null, 5) a(x)"
_DUPS_B = "(values 1, 3, 3, 4, null, 5, 5) b(x)"
SET_OPS = {
    "intersect_all_values": f"select x from {_DUPS_A} intersect all select x from {_DUPS_B}",
    "except_all_values": f"select x from {_DUPS_A} except all select x from {_DUPS_B}",
    "except_all_values_reversed": f"select x from {_DUPS_B} except all select x from {_DUPS_A}",
    "intersect_all_two_columns": (
        "select x, y from (values (1, 'a'), (1, 'a'), (1, null), (2, 'b'), (2, 'b')) a(x, y) "
        "intersect all "
        "select x, y from (values (1, 'a'), (1, null), (1, null), (2, 'b')) b(x, y)"
    ),
    "intersect_all_tables": (
        "select o_orderstatus, o_orderpriority from orders where o_custkey < 400 "
        "intersect all "
        "select o_orderstatus, o_orderpriority from orders where o_custkey between 300 and 700"
    ),
    "except_all_tables": (
        "select n_regionkey from nation except all select r_regionkey from region"
    ),
    "except_all_tables_counted": (
        "select o_orderstatus, count(*) from (select o_orderstatus from orders "
        "except all select o_orderstatus from orders where o_custkey < 500) t "
        "group by o_orderstatus"
    ),
}


@pytest.fixture(scope="module")
def runners():
    mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
    return {
        "jax": JaxRunner(catalog="tpch", schema="tiny", target_splits=2),
        "local": LocalQueryRunner(catalog="tpch", schema="tiny", target_splits=2, device="cpu"),
        "mesh": mesh,
    }


def check(runners, sql: str, wheres=("local",)) -> list:
    expected = runners["jax"].execute(sql)
    assert expected.rows
    order = result_order(runners["local"].create_plan(sql))
    for where in wheres:
        actual = runners[where].execute(sql)
        assert actual.column_names == expected.column_names, where
        assert [t.name for t in actual.types] == [t.name for t in expected.types], where
        assert_rows_match(actual.rows, expected.rows, order, float_rtol=1e-9)
    return expected.rows


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_window_sql_matches_jax(runners, name):
    sql, on_mesh = SQL_CASES[name]
    check(runners, sql, ("local", "mesh") if on_mesh else ("local",))


@pytest.mark.parametrize("name", list(REJECTED))
def test_rejected_window_sql_raises_as_in_jax(runners, name):
    sql = REJECTED[name]
    with pytest.raises(Exception) as jax_error:
        runners["jax"].execute(sql)
    with pytest.raises(Exception) as port_error:
        runners["local"].execute(sql)
    assert type(port_error.value).__name__ == type(jax_error.value).__name__
    assert str(port_error.value) == str(jax_error.value)


def test_mesh_window_runs_per_worker(runners):
    """A partitioned window on the mesh is a per-worker step over a
    repartition on its keys, not a gather to the coordinator."""
    text = runners["mesh"].explain_distributed(SQL_CASES["ignore_nulls_distributed"][0])
    assert "Window" in text and "repartition" in text.lower()


def test_lag_lead_string_default_in_another_dictionary(runners):
    rows = check(runners, _DICT_DEFAULT, ("local", "mesh"))
    assert any(r[1] == "zz-none" for r in rows)


@pytest.mark.parametrize("name", list(SET_OPS))
def test_intersect_except_all_match_jax(runners, name):
    check(runners, SET_OPS[name], ("local", "mesh"))

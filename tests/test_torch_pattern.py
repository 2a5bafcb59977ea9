"""TABLESAMPLE BERNOULLI and MATCH_RECOGNIZE in the port against the JAX
package.

MATCH_RECOGNIZE: the pattern parser (every quantifier, alternation and
grouping form) gives the JAX parser's tree; every case of
tests/test_match_recognize.py runs as SQL at tpch.tiny through the JAX
package's LocalQueryRunner and the port's (its memory-connector table
`stock` becomes a VALUES relation with the same ten rows: the memory
connector is not ported; the EXPLAIN case checks the plan node instead:
the port has no EXPLAIN), with the JAX test's own expected rows where it
states them; a cross-variable DEFINE is rejected in both; the V-shape over
orders (chip_smoke.py's M1) locally and on both 4-worker meshes, which run
the pattern in the coordinator's fragment over the gathered rows; each run
records its device and host seconds in `ops.pattern.PATTERN_LOG`.

TABLESAMPLE: a Bernoulli sample keeps the same rows when the same statement
runs twice (the port feeds the scans under a sample serially, whatever
`task_concurrency`), equals the JAX package's rows at target_splits=1, and
with a serial feed at the default split count too; 0% keeps no row and
100% every row; chip_smoke.py's S1 at tiny; on the mesh both packages
raise NotImplementedError naming SampleNode.

Tolerances: integers, decimals, dates and strings exact; doubles relative
1e-9.
"""

import pytest

from trino_tpu.ops import pattern as jpattern
from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.ops import pattern as tpattern
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

import chip_smoke
from test_torch_tpcds import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def runners():
    jax = JaxRunner(catalog="tpch", schema="tiny", target_splits=2)
    port = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    return jax, port


@pytest.fixture(scope="module")
def meshes():
    return (JaxMesh(catalog="tpch", schema="tiny", n_workers=4),
            DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu"))


def _same(actual, expected, port, sql):
    assert actual.column_names == expected.column_names
    assert [t.name for t in actual.types] == [t.name for t in expected.types]
    assert_rows_match(actual.rows, expected.rows, result_order(port.create_plan(sql)),
                      float_rtol=1e-9)


# -- the pattern parser ---------------------------------------------------------


def _tree(node):
    """A pattern AST as nested tuples (class name, fields...)."""
    if isinstance(node, list):
        return tuple(_tree(x) for x in node)
    if hasattr(node, "__dataclass_fields__"):
        return (type(node).__name__,) + tuple(
            _tree(getattr(node, f)) for f in node.__dataclass_fields__
        )
    return node


@pytest.mark.parametrize("text", [
    "strt down+ up+", "a b* c?", "(a | b)+ c{2}", "a{2,} b{1,3}", "(a b | c (d | e)*)",
    "A_1 b2{0,1}", "x",
])
def test_parse_pattern_matches_jax(text):
    assert _tree(tpattern.parse_pattern(text)) == _tree(jpattern.parse_pattern(text))
    assert tpattern.pattern_variables(tpattern.parse_pattern(text)) == \
        jpattern.pattern_variables(jpattern.parse_pattern(text))


@pytest.mark.parametrize("text", ["", "a (b", "a {2", "a |", "a $"])
def test_bad_patterns_raise_like_jax(text):
    with pytest.raises(ValueError):
        jpattern.parse_pattern(text)
    with pytest.raises(ValueError):
        tpattern.parse_pattern(text)


# -- MATCH_RECOGNIZE as SQL -----------------------------------------------------

#: tests/test_match_recognize.py's memory table, as a VALUES relation
STOCK = (
    "(select sym, day, cast(price as double) price from (values "
    "('A', 1, 10), ('A', 2, 8), ('A', 3, 6), ('A', 4, 9), ('A', 5, 12), "
    "('A', 6, 11), ('B', 1, 5), ('B', 2, 6), ('B', 3, 4), ('B', 4, 7)) v(sym, day, price)) stock"
)

V_QUERY = f"""
select * from {STOCK} match_recognize (
  partition by sym
  order by day
  measures first(price) as strt,
           min(down.price) as bottom,
           last(up.price) as top,
           match_number() as mno
  one row per match
  after match skip past last row
  pattern (strt down+ up+)
  define down as price < prev(price),
         up as price > prev(price)
)
"""

#: name -> (sql, the JAX test's expected rows, or None where it states none)
MATCH = {
    "v_shape_one_row_per_match": (V_QUERY + " order by sym", [
        ("A", 10.0, 6.0, 12.0, 1), ("B", 6.0, 4.0, 7.0, 1),
    ]),
    "all_rows_per_match_classifier": (f"""
        select sym, day, cls from {STOCK} match_recognize (
          partition by sym order by day
          measures classifier() as cls
          all rows per match
          pattern (strt down+ up+)
          define down as price < prev(price),
                 up as price > prev(price)
        ) where sym = 'A' order by day""", [
        ("A", 1, "strt"), ("A", 2, "down"), ("A", 3, "down"), ("A", 4, "up"), ("A", 5, "up"),
    ]),
    "skip_to_next_row": (f"""
        select cnt from {STOCK} match_recognize (
          partition by sym order by day
          measures count(*) as cnt
          one row per match
          after match skip to next row
          pattern (down down)
          define down as price < prev(price)
        )""", [(2,)]),
    "quantifier_bounds": (f"""
        select mno, cnt from {STOCK} match_recognize (
          partition by sym order by day
          measures match_number() as mno, count(*) as cnt
          pattern (down{{2}})
          define down as price < prev(price)
        )""", [(1, 2)]),
    "alternation": (f"""
        select sym, cls from {STOCK} match_recognize (
          partition by sym order by day
          measures classifier() as cls
          pattern (big | small)
          define big as price >= 10,
                 small as price <= 4
        )""", None),
    "undefined_variable_matches_any": (f"""
        select cnt from {STOCK} match_recognize (
          partition by sym order by day
          measures count(*) as cnt
          pattern (anyrow down)
          define down as price < prev(price)
        ) order by 1""", None),
    "string_measure_decodes": (f"""
        select s from {STOCK} match_recognize (
          partition by sym order by day
          measures last(sym) as s
          pattern (down+)
          define down as price < prev(price)
        ) order by 1""", [("A",), ("A",), ("B",)]),
    "next_navigation_last_row_null": (f"""
        select cnt from {STOCK} match_recognize (
          partition by sym order by day
          measures count(*) as cnt
          pattern (tail)
          define tail as next(price) is null and price > 10
        )""", [(1,)]),
    "first_offset": (f"""
        select p from {STOCK} match_recognize (
          partition by sym order by day
          measures first(price, 1) as p
          pattern (down down)
          define down as price < prev(price)
        )""", [(6.0,)]),
    "prev_two_and_aggregates": (f"""
        select sym, n, s, a, mx from {STOCK} match_recognize (
          partition by sym order by day
          measures count(up.price) as n, sum(price) as s, avg(up.price) as a,
                   max(price) as mx
          pattern (strt up+)
          define up as price > prev(price, 2) or prev(price, 2) is null
        ) order by sym, s""", None),
}


@pytest.mark.parametrize("name", list(MATCH))
def test_match_recognize_matches_jax(runners, name):
    jax, port = runners
    sql, rows = MATCH[name]
    expected = jax.execute(sql)
    _same(port.execute(sql), expected, port, sql)
    if rows is not None:
        assert expected.rows == rows
    if name == "alternation":
        assert ("A", "big") in expected.rows and ("B", "small") in expected.rows
    if name == "undefined_variable_matches_any":
        assert len(expected.rows) >= 1


def test_plan_contains_pattern_node(runners):
    """The JAX test's EXPLAIN case: the plan holds the pattern node."""
    _, port = runners
    seen = []

    def walk(node):
        seen.append(type(node).__name__)
        for c in node.children:
            walk(c)

    walk(port.create_plan(V_QUERY))
    assert "PatternRecognitionNode" in seen


def test_cross_variable_define_rejected(runners):
    sql = f"""
        select mno from {STOCK} match_recognize (
          partition by sym order by day
          measures match_number() as mno
          pattern (strt up)
          define up as up.price > strt.price
        )"""
    for r in runners:
        with pytest.raises(Exception, match="cross-variable"):
            r.execute(sql)


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_v_shape_over_orders(runners, meshes, where):
    """chip_smoke.py's M1 at tiny: locally, and on both meshes (which run
    the pattern in the coordinator fragment)."""
    sql = chip_smoke.HOLISTIC_QUERIES["M1"]
    jax, port = runners if where == "local" else meshes
    tpattern.PATTERN_LOG.clear()
    actual = port.execute(sql)
    expected = jax.execute(sql)
    _same(actual, expected, runners[1], sql)
    assert len(expected.rows) == 2841
    (entry,) = tpattern.PATTERN_LOG
    rows, partitions, matches, device_s, walk_s, output_s = entry
    assert (rows, partitions, matches) == (15000, 1000, 2841)
    assert min(device_s, walk_s, output_s) >= 0


# -- TABLESAMPLE ----------------------------------------------------------------

SAMPLE = "select l_orderkey, l_linenumber, l_quantity from lineitem tablesample bernoulli (10)"


def test_sample_is_the_same_twice_and_equals_jax():
    port = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    first = port.execute(SAMPLE).rows
    assert port.execute(SAMPLE).rows == first  # parallel readers cannot reorder it
    assert 0.08 * 59823 < len(first) < 0.12 * 59823
    jax1 = JaxRunner(catalog="tpch", schema="tiny", target_splits=1).execute(SAMPLE).rows
    port1 = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu", target_splits=1)
    assert port1.execute(SAMPLE).rows == jax1
    # the port's default split count, read in order: the JAX package's rows
    # when its readers are serial too
    serial = JaxRunner(catalog="tpch", schema="tiny")
    serial.execute("set session task_concurrency = 1")
    assert first == serial.execute(SAMPLE).rows


@pytest.mark.parametrize("percent, rows", [(0, 0), (100, 59823)])
def test_sample_edges(percent, rows):
    port = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    sql = f"select count(*) from lineitem tablesample bernoulli ({percent})"
    assert port.execute(sql).rows == [(rows,)]


def test_chip_smoke_sample_statement():
    sql = chip_smoke.HOLISTIC_QUERIES["S1"]
    jax = JaxRunner(catalog="tpch", schema="tiny", target_splits=1)
    port = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu", target_splits=1)
    _same(port.execute(sql), jax.execute(sql), port, sql)


def test_sample_on_the_mesh_raises_like_jax(meshes):
    jax_mesh, port_mesh = meshes
    sql = chip_smoke.HOLISTIC_QUERIES["S1"]
    with pytest.raises(NotImplementedError, match="SampleNode"):
        jax_mesh.execute(sql)
    with pytest.raises(NotImplementedError, match=chip_smoke.HOLISTIC_LOCAL_ONLY["S1"]):
        port_mesh.execute(sql)

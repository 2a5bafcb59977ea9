"""The rest of the 84 TPC-DS queries without a window function, marked
`slow` (tier-1 runs `-m 'not slow'`): each runs through the port's
LocalQueryRunner and its 4-worker mesh at tpcds.tiny and is held to one JAX
LocalQueryRunner result, as tests/test_torch_tpcds.py sets out.  The
queries that return no rows at tiny run again at tpcds.sf0_1, where most
of them return rows (their row counts print under `-s` without xdist).
q14's plan parity is here too (its optimizer run takes about a minute).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tpcds_slow.py -m slow \\
        -p xdist -n 4 --dist load
"""

import pytest

from test_torch_tpcds import NO_WINDOW_QIDS, QueryParity, one_torch_thread  # noqa: F401 (autouse)
from test_torch_tpcds_plans import SLOW_PLAN_QIDS, check_plans, make_planners

pytestmark = pytest.mark.slow

#: the queries of the tier-1 files (tests/test_torch_tpcds_{union,rollup,
#: setops,subquery,star}.py)
TIER1_QIDS = frozenset({2, 71, 33, 74, 77, 27, 38, 87, 23, 6, 97, 7, 19, 42, 96})
SLOW_QIDS = tuple(q for q in NO_WINDOW_QIDS if q not in TIER1_QIDS)
#: the queries that return no rows at tiny
EMPTY_AT_TINY = (
    1, 3, 4, 8, 11, 17, 21, 24, 25, 29, 34, 37, 39, 41, 45, 46, 54, 56, 58,
    60, 64, 68, 72, 73, 78, 82, 83, 84, 85, 91, 93,
)


@pytest.fixture(scope="module")
def planners():
    return make_planners()


@pytest.mark.parametrize("qid", sorted(SLOW_PLAN_QIDS))
def test_slow_plans_match_jax(planners, qid):
    check_plans(planners, qid)


@pytest.fixture(scope="module")
def tiny():
    return QueryParity("tiny")


@pytest.fixture(scope="module")
def sf0_1():
    return QueryParity("sf0_1")


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("qid", SLOW_QIDS)
def test_tpcds_query_matches_jax_at_tiny(tiny, qid, where):
    n = tiny.check(qid, where, nonempty=qid not in EMPTY_AT_TINY)
    assert (n == 0) == (qid in EMPTY_AT_TINY)


#: q72's mesh run at sf0_1 expands ~30 M catalog_sales x inventory rows per
#: run and needs tens of GB of host memory on the CPU; chip_smoke.py phase
#: 5d runs it on the card's mesh at sf0_1 against the port's CPU local run
SF0_1_CASES = [
    (q, where) for q in EMPTY_AT_TINY for where in ("local", "mesh")
    if (q, where) != (72, "mesh")
]


@pytest.mark.parametrize("qid,where", SF0_1_CASES, ids=[f"{q}-{w}" for q, w in SF0_1_CASES])
def test_empty_at_tiny_matches_jax_at_sf0_1(sf0_1, qid, where):
    n = sf0_1.check(qid, where, nonempty=False)
    print(f"q{qid} {where} at sf0_1: {n} rows")

"""TPC-DS q38, q87 at tpcds.tiny: INTERSECT (q38) and EXCEPT (q87), each lowered to a tagged union,
counts per side and a filter.

Each query runs through the port's LocalQueryRunner and its 4-worker mesh
(`pallas_probe` on, so the sorted-probe kernel's plain version must run in
the mesh joins) and is held to one JAX LocalQueryRunner result, as
tests/test_torch_tpcds.py sets out.
"""

import pytest

from test_torch_tpcds import QueryParity, one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def parity():
    return QueryParity()


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("qid", [38, 87])
def test_tpcds_setops_queries_match_jax(parity, qid, where):
    parity.check(qid, where)

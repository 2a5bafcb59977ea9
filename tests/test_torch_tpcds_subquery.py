"""TPC-DS q23, q6, q97 at tpcds.tiny: a union with a scalar subquery (q23), a non-aggregate scalar
subquery under EnforceSingleRow (q6) and a FULL OUTER JOIN (q97).

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
@pytest.mark.parametrize("qid", [23, 6, 97])
def test_tpcds_subquery_queries_match_jax(parity, qid, where):
    parity.check(qid, where)

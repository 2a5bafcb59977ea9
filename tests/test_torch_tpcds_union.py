"""TPC-DS q2, q71, q33, q74 at tpcds.tiny: UNION ALL (q2, q71), UNION (q33) and a union over a VALUES
relation (q74).

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
@pytest.mark.parametrize("qid", [2, 71, 33, 74])
def test_tpcds_union_queries_match_jax(parity, qid, where):
    parity.check(qid, where)

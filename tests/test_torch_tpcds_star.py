"""TPC-DS q7, q19, q42, q96 at tpcds.tiny: star joins that need only the connector: store_sales against
its dimensions on single BIGINT surrogate keys (q7, q19, q42, q96).

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
@pytest.mark.parametrize("qid", [7, 19, 42, 96])
def test_tpcds_star_queries_match_jax(parity, qid, where):
    parity.check(qid, where)

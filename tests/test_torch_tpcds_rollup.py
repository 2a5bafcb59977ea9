"""TPC-DS q77, q27 at tpcds.tiny: ROLLUP through a union of the three sales channels (q77, with
its long-decimal sums and a NULL-literal branch) and `grouping()` over a
ROLLUP (q27).

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
@pytest.mark.parametrize("qid", [77, 27])
def test_tpcds_rollup_queries_match_jax(parity, qid, where):
    parity.check(qid, where)

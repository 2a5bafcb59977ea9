"""TPC-DS q12, q44, q47 and q86 at tpcds.tiny: the window functions.

q12 takes a ratio of a sum to its sum over a partition (a decimal(38,2)
window sum), q44 ranks over a whole input (`rank() over (order by ...)`,
gathered to one fragment on the mesh; its rows are empty at tiny and run
again at sf0_1 in tests/test_torch_tpcds_slow.py), q47 takes avg over a
partition and lag/lead over the same partitions (the long-decimal avg), and
q86 ranks within ROLLUP groups with grouping().  Each runs through the
port's LocalQueryRunner and its 4-worker mesh (`pallas_probe` on, so the
sorted-probe kernel's plain version must run in the mesh joins) and is held
to one JAX LocalQueryRunner result, as tests/test_torch_tpcds.py sets out.

q51 raises in the JAX package (a running max over a decimal(38,2) sum:
tests/KNOWN_FAILURES.md); the port raises the same NotImplementedError,
locally and on the mesh.  The other ten windowed queries are in
tests/test_torch_tpcds_slow.py.
"""

import pytest

from trino_tpu.connectors.tpcds.queries import QUERIES

from test_torch_tpcds import QueryParity, one_torch_thread  # noqa: F401 (autouse)

#: empty at tiny (run again at sf0_1 in the slow file)
EMPTY_AT_TINY = frozenset({44})


@pytest.fixture(scope="module")
def parity():
    return QueryParity()


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("qid", [12, 44, 47, 86])
def test_tpcds_window_queries_match_jax(parity, qid, where):
    n = parity.check(qid, where, nonempty=qid not in EMPTY_AT_TINY)
    assert (n == 0) == (qid in EMPTY_AT_TINY)


@pytest.fixture(scope="module")
def q51_jax_error(parity):
    with pytest.raises(NotImplementedError) as e:
        parity.jax.execute(QUERIES[51])
    return e.value


@pytest.mark.parametrize("where", ["local", "mesh"])
def test_q51_raises_as_in_jax(parity, q51_jax_error, where):
    runner = parity.local if where == "local" else parity.mesh
    with pytest.raises(NotImplementedError) as e:
        runner.execute(QUERIES[51])
    assert str(e.value) == str(q51_jax_error)
    assert "window min/max over a long-decimal input column" in str(e.value)

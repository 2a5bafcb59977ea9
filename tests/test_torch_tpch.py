"""The ten TPC-H queries of the scalar-function and DISTINCT slice (Q2, Q7,
Q8, Q9, Q13, Q14, Q16, Q17, Q20, Q22) through the port's
LocalQueryRunner(device="cpu") against the JAX package's LocalQueryRunner
at tpch.tiny.  The mesh runs of the same queries are in
tests/test_torch_tpch_mesh*.py, which share the helpers below.

Rows in the queries' ORDER BY order (unique at tiny); integers, decimals,
dates and strings exact; doubles (Q8, Q14, Q17) relative 1e-9.
"""

import pytest

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows
from test_torch_observatory import assert_same_ledger, attach_stores

NEW_QIDS = [2, 7, 8, 9, 13, 14, 16, 17, 20, 22]

#: the mesh knob settings every new query runs under
MESH_SETTINGS = {
    "default": [],
    "pallas_probe": ["pallas_probe = true"],
    "partitioned_pallas_probe": [
        "join_distribution_type = 'PARTITIONED'", "pallas_probe = true",
    ],
}

#: K2-eligible mesh joins: the queries whose mesh plan holds a join with
#: one integer key per side (Q22's only join is the cross join with its
#: scalar subquery)
PROBE_QIDS = {2, 7, 8, 9, 13, 14, 16, 17, 20}


def check_rows(actual, expected) -> None:
    assert actual.column_names == expected.column_names
    assert [t.name for t in actual.types] == [t.name for t in expected.types]
    assert len(expected.rows) > 0
    assert_same_rows(actual.rows, expected.rows, ordered=True, float_rtol=1e-9)


def run_both(jax_runner, port_runner, sql, settings):
    """Both runners under the same session settings, reset afterwards."""
    for s in settings:
        jax_runner.execute("set session " + s)
        port_runner.execute("set session " + s)
    attach_stores(jax_runner, port_runner)
    try:
        expected, actual = jax_runner.execute(sql), port_runner.execute(sql)
        # and the decision ledgers (tests/test_torch_observatory.py)
        assert_same_ledger(jax_runner, port_runner, sql)
        return expected, actual
    finally:
        for s in ("pallas_probe = false", "join_distribution_type = 'AUTOMATIC'"):
            jax_runner.execute("set session " + s)
            port_runner.execute("set session " + s)


def check_mesh_query(meshes, qid, setting) -> None:
    """One new query on the 4-worker meshes under one knob setting; under
    `pallas_probe` the sorted-probe kernel's plain version must run (on
    the CPU the property decides), otherwise it must not."""
    from trino_tpu_torch.ops import locate_sorted as ls

    jax_mesh, port_mesh = meshes
    before = ls.locate_sorted_reference.launches
    expected, actual = run_both(jax_mesh, port_mesh, QUERIES[qid], MESH_SETTINGS[setting])
    check_rows(actual, expected)
    launched = ls.locate_sorted_reference.launches - before
    if "pallas_probe" in setting and qid in PROBE_QIDS:
        assert launched > 0
    else:
        assert launched == 0


@pytest.fixture(scope="module")
def runners():
    return (
        JaxRunner(catalog="tpch", schema="tiny"),
        LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    )


@pytest.mark.parametrize("qid", NEW_QIDS)
def test_local_tpch_queries_match_jax(runners, qid):
    jax_runner, port_runner = runners
    check_rows(port_runner.execute(QUERIES[qid]), jax_runner.execute(QUERIES[qid]))

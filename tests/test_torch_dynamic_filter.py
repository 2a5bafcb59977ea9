"""The mesh dynamic filter on a long-decimal (limb-plane) join key.

TPC-H Q15 joins `total_revenue = max(total_revenue)` on a decimal(38,4) key.
Both packages' static pass (verify/collectives.py) counts a long decimal as
a dynamic-filter type, so the recorded collective signature of that
fragment holds a `reduce/dynamic_filter` for the join.  The port's runner
issues it, as the JAX runner does, and registers no range for the key (a
min/max over both limbs is not an int128 range).  So the warm 4-worker Q15
fails `device_residency` only on `host_restack`, in both packages, with
the JAX package's collective sequence and rows.
"""

import pytest

from trino_tpu import verify as JV
from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.parallel import DistributedQueryRunner as JaxMesh
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import verify as V
from trino_tpu_torch.parallel import DistributedQueryRunner

from test_torch_e2e import assert_same_rows

HOST_RESTACK = "unexpected host transfer: counter 'host_restack' fired 1x on the warm run"


def _problems(err) -> list:
    return str(err.value).split('": ', 1)[1].split("; ")


@pytest.fixture(scope="module")
def q15_runs():
    out = {}
    for name, runner, verify in (
        ("port", DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4,
                                        device="cpu"), V),
        ("jax", JaxMesh(catalog="tpch", schema="tiny", n_workers=4), JV),
    ):
        with pytest.raises(verify.ResidencyViolation) as err:
            verify.device_residency(runner, QUERIES[15], warmups=2)
        out[name] = (runner, _problems(err))
    return out


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_warm_mesh_q15_fails_only_on_host_restack(q15_runs, pkg):
    assert q15_runs[pkg][1] == [HOST_RESTACK]


def test_q15_issues_the_jax_collective_sequence(q15_runs):
    port, jax = q15_runs["port"][0], q15_runs["jax"][0]
    seq = port.last_mesh_profile.collective_sequences()
    assert seq == jax.last_mesh_profile.collective_sequences()
    n_reduce = sum(s.count(("reduce", "dynamic_filter")) for s in seq.values())
    assert n_reduce >= 2
    # the long-decimal key registered no range; the supplier key did
    assert set(port.last_stage_executor.dynamic_filters) == {"s_suppkey"}


def test_q15_rows_equal_jax(q15_runs):
    port = q15_runs["port"][0]
    expected = JaxRunner(catalog="tpch", schema="tiny").execute(QUERIES[15]).rows
    assert_same_rows(port.execute(QUERIES[15]).rows, expected, True, 1e-9)

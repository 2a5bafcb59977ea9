"""TPC-H Q14, Q16, Q17, Q20 and Q22 on the port's 4-worker mesh against the
JAX package's mesh at tpch.tiny, under default knobs, `pallas_probe = true`
(the sorted-probe kernel's plain version must run wherever a join is
eligible) and partitioned joins with `pallas_probe`; and Q16 (its
count(distinct) repartitions the raw rows on the group keys) on a 3-worker
mesh, where the exchange hash's unsigned remainder decides the placement.
The slice's other mesh queries are in tests/test_torch_tpch_mesh.py and
tests/test_torch_tpch_mesh_joins.py.

Rows in ORDER BY order; integers, decimals, dates and strings exact;
doubles (Q14, Q17) relative 1e-9.
"""

import pytest

from trino_tpu.connectors.tpch.queries import QUERIES
from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
from trino_tpu_torch.parallel import DistributedQueryRunner

from test_torch_tpch import MESH_SETTINGS, check_mesh_query, check_rows


@pytest.fixture(scope="module")
def meshes():
    return (
        JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=4),
        DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu"),
    )


@pytest.mark.parametrize("setting", list(MESH_SETTINGS))
@pytest.mark.parametrize("qid", [14, 16, 17, 20, 22])
def test_mesh_tpch_queries_match_jax(meshes, qid, setting):
    check_mesh_query(meshes, qid, setting)


def test_mesh_q16_three_workers_matches_jax():
    jax_mesh = JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=3)
    port_mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=3, device="cpu")
    check_rows(port_mesh.execute(QUERIES[16]), jax_mesh.execute(QUERIES[16]))
    assert port_mesh.last_stage_executor.counters.get("repartition_collective", 0) >= 1

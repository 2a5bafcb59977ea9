"""TPC-H Q2 and Q8 on the port's 4-worker mesh against the JAX package's
mesh at tpch.tiny, under default knobs, `pallas_probe = true` (the
sorted-probe kernel's plain version must run) and partitioned joins with
`pallas_probe`.  The slice's other mesh queries are split across
tests/test_torch_tpch_mesh_joins.py and tests/test_torch_tpch_mesh_distinct.py,
so that `--dist loadfile` spreads them over the workers.

Rows in ORDER BY order; integers, decimals, dates and strings exact;
doubles (Q8) relative 1e-9.
"""

import pytest

from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner
from trino_tpu_torch.parallel import DistributedQueryRunner

from test_torch_tpch import MESH_SETTINGS, check_mesh_query


@pytest.fixture(scope="module")
def meshes():
    return (
        JaxMeshRunner(catalog="tpch", schema="tiny", n_workers=4),
        DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu"),
    )


@pytest.mark.parametrize("setting", list(MESH_SETTINGS))
@pytest.mark.parametrize("qid", [2, 8])
def test_mesh_tpch_queries_match_jax(meshes, qid, setting):
    check_mesh_query(meshes, qid, setting)

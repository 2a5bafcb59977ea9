"""The port's copied planner, optimizer and fragmenter against the JAX
package's at tpcds.tiny: every TPC-DS query plans to the same logical plan
(the INTERSECT and EXCEPT tags, the ROLLUP branches, grouping() and the
window nodes with their frames included) and to the same fragments,
exchanges and join distributions on the 4-worker mesh (a partitioned
window over a repartition on its keys, a whole-input window gathered).
The queries below 50 plan here, the rest in
tests/test_torch_tpcds_plans_late.py (so that `--dist loadfile` puts them
on two workers); q14, whose optimizer run takes about a minute in each
package, is in tests/test_torch_tpcds_slow.py.
"""

import pytest

from trino_tpu.connectors.tpcds.queries import QUERIES
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_tpcds import ALL_QIDS

#: planned in the slow file
SLOW_PLAN_QIDS = frozenset({14})
#: the queries this file plans; the late file takes the rest
EARLY_PLAN_QIDS = [q for q in ALL_QIDS if q < 50 and q not in SLOW_PLAN_QIDS]
LATE_PLAN_QIDS = [q for q in ALL_QIDS if q >= 50 and q not in SLOW_PLAN_QIDS]



def make_planners() -> tuple:
    from trino_tpu.parallel import DistributedQueryRunner as JaxMeshRunner

    return (
        JaxRunner(catalog="tpcds", schema="tiny"),
        LocalQueryRunner(catalog="tpcds", schema="tiny", device="cpu"),
        JaxMeshRunner(catalog="tpcds", schema="tiny", n_workers=4),
        DistributedQueryRunner(catalog="tpcds", schema="tiny", n_workers=4, device="cpu"),
    )


@pytest.fixture(scope="module")
def planners():
    return make_planners()


def check_plans(planners, qid: int) -> None:
    from trino_tpu.planner.plan import plan_text as jax_plan_text
    from trino_tpu_torch.planner.plan import plan_text

    jax_local, port_local, jax_mesh, port_mesh = planners
    sql = QUERIES[qid]
    assert plan_text(port_local.create_plan(sql)) == jax_plan_text(jax_local.create_plan(sql))
    assert port_mesh.explain_distributed(sql) == jax_mesh.explain_distributed(sql)


@pytest.mark.parametrize("qid", EARLY_PLAN_QIDS)
def test_plans_match_jax(planners, qid):
    check_plans(planners, qid)

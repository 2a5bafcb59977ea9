"""The TPC-DS queries from 50 up: their logical plans and mesh fragments
against the JAX package's, as tests/test_torch_tpcds_plans.py sets out."""

import pytest

from test_torch_tpcds_plans import LATE_PLAN_QIDS, check_plans, make_planners


@pytest.fixture(scope="module")
def planners():
    return make_planners()


@pytest.mark.parametrize("qid", LATE_PLAN_QIDS)
def test_late_plans_match_jax(planners, qid):
    check_plans(planners, qid)

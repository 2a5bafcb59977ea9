"""Queries under memory budgets through the port's LocalQueryRunner on the
CPU, against the JAX package's LocalQueryRunner under the same budgets at
tpch.tiny (the budgets of tests/test_spill.py and tests/test_memory.py):
the grouped aggregation in state waves (spill to disk with k pinned, host
RAM with k automatic), the partitioned window in waves (k automatic and
pinned) and the external ORDER BY, with the checks of
tests/test_torch_spill_e2e.py (split from it so that `--dist loadfile`
spreads them).
"""

import pytest

from test_torch_spill_e2e import (  # noqa: F401  (spill_dir is a fixture)
    AGG_SQL,
    SORT_SQL,
    WINDOW_SQL,
    check_budgeted_query,
    check_unbudgeted_query,
    spill_dir,
)

#: name -> (sql, target_splits, session properties, ORDER BY rows in order)
CASES = {
    "agg_k2_disk": (AGG_SQL, 2, dict(query_max_memory=150_000, memory_wave_partitions=2), False),
    "agg_auto_k_ram": (
        AGG_SQL, 2, dict(query_max_memory=150_000, spill_enabled=False), False,
    ),
    "window": (WINDOW_SQL, 4, dict(query_max_memory_bytes=400_000), False),
    "window_k2": (
        WINDOW_SQL, 4, dict(query_max_memory_bytes=400_000, memory_wave_partitions=2), False,
    ),
    "order_by": (SORT_SQL, 6, dict(query_max_memory_bytes=300_000), True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_budgeted_query_matches_jax(name, spill_dir):  # noqa: F811
    check_budgeted_query(CASES[name], spill_dir)


@pytest.mark.parametrize("sql", [AGG_SQL, WINDOW_SQL, SORT_SQL], ids=["agg", "window", "sort"])
def test_unbudgeted_query_records_no_pressure(sql, spill_dir):  # noqa: F811
    check_unbudgeted_query(sql, spill_dir)

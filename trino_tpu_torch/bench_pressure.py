"""Memory-pressure bench probe (the `pressure` section that
tools/compare_bench.py's `check_pressure` gates).

The degradation proof of the escalation ladder: Q18 — whose build side and
group-by state dwarf a constrained pool — must complete under a pool limit
smaller than its unconstrained peak, in k > 1 partition waves with
filesystem-SPI spill, answering exactly the unconstrained local oracle's
rows; and the unconstrained runs before it must have recorded ZERO waves,
spill, and revocations (degradation is free without pressure).

The counters are process totals: run the probe in a process whose earlier
statements ran without a budget (chip_smoke.py runs it in a child process).
"""

from __future__ import annotations

import time


def pressure_counters() -> dict:
    """Process totals of the degradation counters."""
    from trino_tpu_torch.telemetry.metrics import (
        MEMORY_WAVE_OPERATORS,
        memory_revocations_counter,
        memory_waves_counter,
        spill_bytes_counter,
    )

    waves = memory_waves_counter()
    return {
        "memory_waves_total": sum(
            int(waves.value((op,))) for op in MEMORY_WAVE_OPERATORS
        ),
        "spill_bytes_total": int(spill_bytes_counter().value()),
        "memory_revocations_total": int(
            memory_revocations_counter().value()
        ),
    }


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def run_pressure(local, dist, sql: str) -> dict:
    """Run the pressure probe; `local`/`dist` are warmed runners whose
    process has already executed the unconstrained benched queries (their
    counter totals are the zero-cost-when-idle evidence)."""
    from trino_tpu_torch.runtime.lifecycle import set_memory_pool_limit

    unconstrained = pressure_counters()
    # unconstrained oracle + its peak reservation (the pool limit derives
    # from MEASURED peak, so the probe scales with schema size)
    t0 = time.perf_counter()
    oracle = sorted(map(str, local.execute(sql).rows))
    oracle_wall = time.perf_counter() - t0
    # the statement's reserved peak, kept on its QueryContext
    peak = int(local.last_query.peak_memory)
    if peak <= 0:
        raise AssertionError(
            "the unconstrained run recorded no reserved peak: no pool "
            "limit can be derived from it"
        )
    limit = max(peak // 8, 1 << 20)
    out: dict = {
        "unconstrained": unconstrained,
        "unconstrained_peak_bytes": peak,
        "unconstrained_local_wall_s": round(oracle_wall, 4),
        "pool_limit_bytes": limit,
    }

    def constrained(runner) -> dict:
        before = pressure_counters()
        set_memory_pool_limit(limit)
        try:
            t0 = time.perf_counter()
            rows = sorted(map(str, runner.execute(sql).rows))
            wall = time.perf_counter() - t0
        finally:
            set_memory_pool_limit(0)
        d = _delta(pressure_counters(), before)
        return {
            "wall_s": round(wall, 4),
            "rows_match": rows == oracle,
            "waves": d["memory_waves_total"],
            "spill_bytes": d["spill_bytes_total"],
            "revocations": d["memory_revocations_total"],
        }

    out["local"] = constrained(local)
    if dist is not None:
        out["mesh"] = constrained(dist)
    return out

"""Static-analysis verification subsystem — the part the port's planner
and mesh fragmenter run (port of trino_tpu/verify).

  * plan sanity checkers (`check_plan` / `check_subplan`), run by the
    optimizer after analysis, after each fixpoint iteration, after pruning,
    and by the fragmenter after fragmentation;
  * partitioning checks (`partitioning.py`): every distributed join and
    aggregation is co-located on its keys;
  * collective-uniformity pass (`collectives.py`): each distributed
    fragment's collective sequence is statically enumerated and proven
    divergence-free;
  * numeric-safety licensing (`numeric.py` + `ranges.py`): range
    certificates that license exact single-plane i64 decimal sums;
  * capacity certificates (`capacity.py`): join/group cardinality proofs.

The device-residency verifier, the collective-schedule licenses
(`schedule.py`) and the lock-graph tools are not ported yet.

Enforcement of the plan checkers follows the `verify_plan` session property
(strict | warn | off; default strict under pytest, warn elsewhere).
"""

from trino_tpu_torch.verify.plan_checker import (
    LAST_WARNINGS,
    MODES,
    PlanViolation,
    check_plan,
    check_subplan,
    enforce,
    resolve_mode,
)

__all__ = [
    "LAST_WARNINGS",
    "MODES",
    "PlanViolation",
    "check_plan",
    "check_subplan",
    "enforce",
    "resolve_mode",
]

"""Static-analysis verification subsystem (port of trino_tpu/verify).

  * plan sanity checkers (`check_plan` / `check_subplan`), run by the
    optimizer after analysis, after each fixpoint iteration, after pruning,
    and by the fragmenter after fragmentation;
  * partitioning checks (`partitioning.py`): every distributed join and
    aggregation is co-located on its keys;
  * kernel/SPMD verifier (`residency.py`: `device_residency`,
    `cache_key_audit`): replays a query on the mesh and asserts its
    zero-host-round-trip and zero-warm-build contracts, and checks
    step-cache key completeness against the step closures' free variables;
  * concurrency analyzer (`concurrency.py`, `python -m
    trino_tpu_torch.verify.concurrency`): guarded-state inference, thread
    discipline and static lock order over `trino_tpu_torch/`, with a
    justified findings baseline beside it;
  * dynamic lock-order verification (`lockgraph.py`): instrumented locks
    and RLocks record the acquisition-order graph and fail on cycles;
  * collective-uniformity pass (`collectives.py`): each distributed
    fragment's collective sequence is statically enumerated and proven
    divergence-free (sweep: `python -m trino_tpu_torch.verify.collectives`);
  * numeric-safety licensing (`numeric.py` + `ranges.py`): range
    certificates that license exact single-plane i64 decimal sums (sweep:
    `python -m trino_tpu_torch.verify.numeric [--check-stale]`);
  * capacity certificates (`capacity.py`): join/group cardinality proofs
    (sweep: `python -m trino_tpu_torch.verify.capacity`);
  * collective-schedule licenses (`schedule.py`): independent, sync-free
    build-side fragments may pre-dispatch eagerly, and `device_residency`
    holds warm replays to the licensed schedule.

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
from trino_tpu_torch.verify.partitioning import check_partitioning
from trino_tpu_torch.verify.capacity import (
    CapacityCertificate,
    GroupCapacityCertificate,
    check_capacity_certificates,
    derive_group_certificate,
    derive_join_certificate,
    license_join_capacities,
    multiplicity_bound,
    seal_licenses,
)
from trino_tpu_torch.verify.schedule import ScheduleLicense, license_schedule
from trino_tpu_torch.verify.collectives import (
    check_collective_uniformity,
    collective_signature,
    signature_problems,
)
from trino_tpu_torch.verify.lockgraph import (
    InstrumentedLock,
    InstrumentedRLock,
    LockGraph,
    LockOrderViolation,
)
from trino_tpu_torch.verify.residency import (
    CacheKeyViolation,
    ResidencyViolation,
    cache_key_audit,
    closure_fingerprint,
    device_residency,
)

__all__ = [
    "LAST_WARNINGS",
    "MODES",
    "PlanViolation",
    "check_partitioning",
    "check_plan",
    "check_subplan",
    "enforce",
    "resolve_mode",
    "CacheKeyViolation",
    "ResidencyViolation",
    "cache_key_audit",
    "closure_fingerprint",
    "device_residency",
    "check_collective_uniformity",
    "collective_signature",
    "signature_problems",
    "CapacityCertificate",
    "GroupCapacityCertificate",
    "check_capacity_certificates",
    "derive_group_certificate",
    "derive_join_certificate",
    "license_join_capacities",
    "multiplicity_bound",
    "seal_licenses",
    "ScheduleLicense",
    "license_schedule",
    "InstrumentedLock",
    "InstrumentedRLock",
    "LockGraph",
    "LockOrderViolation",
]

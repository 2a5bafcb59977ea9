"""Per-query plan-decision ledger: what the planner chose, what it cost.

Port of trino_tpu/telemetry/decisions.py, copied with the package renamed.
Every consequential choice the planner or the mesh runtime makes is
recorded AT DECISION TIME with a stable `decision_id`, the inputs it saw
and the alternative it rejected:

  * join distribution (broadcast / partitioned / colocated),
  * capacity source (licensed / declined / runtime_check, with the
    certificate kind and the economy verdict),
  * dictionary-coding placement lift (versioned varchar keys co-locating
    like integers),
  * the collective-schedule license (async pre-dispatch vs lazy order),
  * wave-count spill escalation,
  * mechanical exchange placements (aggregation repartition, window
    partitioning, semi-join shape),
  * task recovery under retry_policy = TASK (retry vs fail).

After the statement, `LocalQueryRunner.execute` joins every decision with
its measured outcome (the collective bytes the choice moved, attributed
through `MeshProfile.add_collective` under a `decision_scope`, the
per-fragment walls, learned capacity widths) and stamps a `hindsight`
verdict:

  * `vindicated`  — the measured outcome was no worse than the recorded
    estimate for the rejected alternative,
  * `regret`      — the measured outcome exceeded the rejected
    alternative's estimate by `decision_regret_ratio` (and moved at least
    `decision_regret_min_bytes`, so tiny dimension broadcasts never flag),
  * `unmeasured`  — the decision never observed an outcome.

One ledger per QueryContext, resolved through the lifecycle contextvar,
so concurrent lanes never share one.  Byte attribution is host-side
integer bookkeeping on values the profile already holds: it never
synchronizes with the device.  The ledger lands in the profile artifact
(`decisions` key), feeds `system.runtime.plan_decisions` and the
`trino_tpu_plan_decisions_total{kind,outcome,hindsight}` counter.
"""

from __future__ import annotations

import contextvars
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

#: decision-kind vocabulary (the {kind} label of plan_decisions_total)
DECISION_KINDS = (
    "join_distribution",
    "join_capacity",
    "dictionary_placement",
    "schedule_license",
    "wave",
    "exchange",
    # task-recovery classification (runtime/lifecycle RECOVERY table):
    # retry (same plan, lost tasks only) vs replan (mesh signature truly
    # changed) vs fail (user/semantic — never retried), recorded with the
    # error code and mesh evidence the classifier saw
    "recovery",
)

#: hindsight vocabulary (the {hindsight} label)
HINDSIGHT = ("vindicated", "regret", "unmeasured")

#: exchange-plane collective kinds the completeness gate covers: every
#: byte of these kinds must attribute to exactly one decision (gathers
#: are host pulls, reduces are dynamic-filter summaries — neither is a
#: *placement* choice)
EXCHANGE_KINDS = ("all_to_all", "all_gather")


@dataclass
class Decision:
    """One recorded choice.  `measured` accumulates runtime observations
    (collective bytes by kind/purpose, fragments touched, learned
    widths); `hindsight` is stamped once by `finalize`."""

    decision_id: str
    kind: str
    site: str
    choice: str
    alternative: str
    inputs: dict = field(default_factory=dict)
    #: audit-log watermark at decision time: shed/kill/drain audit lines
    #: with (query_id, seq > audit_seq) happened AFTER this choice
    audit_seq: Optional[int] = None
    measured: dict = field(default_factory=dict)
    #: (kind, purpose) -> bytes attributed to this decision
    bytes_by: dict = field(default_factory=dict)
    #: fragment ids whose collectives attributed here (phase-wall join key)
    fragments: list = field(default_factory=list)
    hindsight: str = "unmeasured"
    hindsight_detail: str = ""

    @property
    def exchange_bytes(self) -> int:
        return sum(
            b for (k, _), b in self.bytes_by.items() if k in EXCHANGE_KINDS
        )

    def to_json(self) -> dict:
        return {
            "decision_id": self.decision_id,
            "kind": self.kind,
            "site": self.site,
            "choice": self.choice,
            "alternative": self.alternative,
            "inputs": dict(self.inputs),
            "audit_seq": self.audit_seq,
            "measured": dict(self.measured),
            "bytes_by": {
                f"{k}/{p}": b for (k, p), b in sorted(self.bytes_by.items())
            },
            "exchange_bytes": self.exchange_bytes,
            "fragments": sorted(set(self.fragments)),
            "hindsight": self.hindsight,
            "hindsight_detail": self.hindsight_detail,
        }


class DecisionLedger:
    """Per-query decision ledger (one per QueryContext; see module doc).
    Thread-safe: the dispatcher's engine lanes each own a ledger, but a
    statement's planner thread and any helper threads may record into the
    same one."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self._lock = threading.Lock()
        self._next = 0
        self.decisions: list[Decision] = []
        self._by_id: dict[str, Decision] = {}
        #: exchange-plane bytes observed with NO active decision scope:
        #: (kind, purpose) -> bytes.  check_decisions asserts this empty —
        #: an unattributed collective is a choice the ledger missed.
        self.unattributed: dict = {}
        self.finalized = False

    # -- decision time --------------------------------------------------------

    def record(self, kind: str, site: str, choice: str,
               alternative: str = "", inputs: Optional[dict] = None) -> str:
        """Record one choice; returns its stable decision_id.  Called at
        the moment the choice is made (planner rule or runtime branch),
        never retroactively — the inputs dict is what the decider SAW."""
        from trino_tpu_torch.telemetry.metrics import plan_decisions_counter

        with self._lock:
            did = f"d{self._next:03d}"
            self._next += 1
            d = Decision(
                decision_id=did,
                kind=kind,
                site=site,
                choice=choice,
                alternative=alternative,
                inputs=dict(inputs or {}),
                audit_seq=_audit_watermark(),
            )
            self.decisions.append(d)
            self._by_id[did] = d
        plan_decisions_counter().labels(kind, choice, "pending").inc()
        return did

    # -- outcome join ---------------------------------------------------------

    def observe(self, decision_id: Optional[str], **measured) -> None:
        """Merge runtime measurements into a decision (numeric values the
        runtime already holds host-side — never a device sync)."""
        if decision_id is None:
            return
        with self._lock:
            d = self._by_id.get(decision_id)
            if d is None:
                return
            d.measured.update(measured)

    def observe_collective(self, decision_id: Optional[str], fid: int,
                           nbytes: int, kind: str, purpose: str) -> None:
        """Attribute one collective's bytes (called by
        MeshProfile.add_collective under the ambient decision scope)."""
        with self._lock:
            d = self._by_id.get(decision_id) if decision_id else None
            if d is None:
                if kind in EXCHANGE_KINDS:
                    key = (kind, purpose)
                    self.unattributed[key] = (
                        self.unattributed.get(key, 0) + int(nbytes)
                    )
                return
            key = (kind, purpose)
            d.bytes_by[key] = d.bytes_by.get(key, 0) + int(nbytes)
            d.fragments.append(int(fid))

    # -- hindsight ------------------------------------------------------------

    def finalize(self, n_workers: int = 1, regret_ratio: float = 2.0,
                 min_bytes: int = 1 << 20, fragment_phases=None) -> None:
        """Stamp every decision's hindsight verdict from its measured
        outcome vs the recorded estimate of the rejected alternative.
        Idempotent (the runner calls it once, before archiving)."""
        from trino_tpu_torch.telemetry.metrics import plan_decisions_counter

        with self._lock:
            if self.finalized:
                return
            self.finalized = True
            decisions = list(self.decisions)
        w = max(1, int(n_workers))
        for d in decisions:
            if fragment_phases:
                wall = sum(
                    fragment_phases.get(f, 0.0) for f in set(d.fragments)
                )
                if wall:
                    d.measured["fragment_wall_s"] = round(wall, 6)
            verdict, detail = self._hindsight(d, w, regret_ratio, min_bytes)
            d.hindsight = verdict
            d.hindsight_detail = detail
            plan_decisions_counter().labels(d.kind, d.choice, verdict).inc()

    @staticmethod
    def _hindsight(d: Decision, w: int, ratio: float, floor: int):
        measured_any = bool(d.bytes_by or d.measured)
        if d.kind == "join_distribution":
            if d.choice == "broadcast":
                moved = sum(
                    b for (k, _), b in d.bytes_by.items()
                    if k == "all_gather"
                )
                if not moved:
                    return "unmeasured", "no broadcast bytes observed"
                # the rejected partitioned plan ships ONE build copy
                # (moved/W — all_gather replicated it W times) plus the
                # probe side once, unless the probe was already placed
                alt = moved // w + int(d.measured.get("probe_move_bytes", 0))
                if moved <= floor:
                    return "vindicated", f"moved {moved}B <= {floor}B floor"
                if moved > ratio * max(1, alt):
                    return (
                        "regret",
                        f"broadcast moved {moved}B; partitioned estimate "
                        f"{alt}B (> {ratio}x)",
                    )
                return "vindicated", f"moved {moved}B vs estimate {alt}B"
            moved = sum(
                b for (k, _), b in d.bytes_by.items() if k == "all_to_all"
            )
            build = int(d.measured.get("build_bytes", 0))
            if not measured_any:
                return "unmeasured", ""
            alt = w * build  # the rejected broadcast ships W build copies
            if build and moved > floor and moved > ratio * max(1, alt):
                return (
                    "regret",
                    f"partitioned moved {moved}B; broadcast estimate {alt}B",
                )
            return "vindicated", f"moved {moved}B vs broadcast {alt}B"
        if d.kind == "join_capacity":
            oc = int(d.inputs.get("licensed_cap", 0))
            if d.choice == "licensed":
                live = int(d.measured.get("live_cap", 0))
                if not live:
                    return (
                        ("vindicated", "executed at licensed width")
                        if measured_any else ("unmeasured", "")
                    )
                if oc > 1024 and oc > ratio * live:
                    return (
                        "regret",
                        f"licensed width {oc} > {ratio}x measured live "
                        f"{live}",
                    )
                return "vindicated", f"width {oc} vs live {live}"
            if d.choice == "declined":
                cap = int(d.measured.get("runtime_cap", 0))
                if not cap:
                    return "unmeasured", "runtime width not recorded"
                if oc and cap >= oc:
                    return (
                        "regret",
                        f"declined width {oc} but runtime sized {cap} "
                        "(decline bought nothing)",
                    )
                return "vindicated", f"runtime sized {cap} < licensed {oc}"
            # runtime_check: no license existed, nothing was rejected
            return (
                ("vindicated", "runtime sizing (no license rejected)")
                if measured_any else ("unmeasured", "")
            )
        # plan-only / mechanical kinds: vindicated once an outcome landed
        if measured_any:
            return "vindicated", ""
        return "unmeasured", ""

    # -- export ---------------------------------------------------------------

    def to_json(self) -> dict:
        with self._lock:
            return {
                "query_id": self.query_id,
                "decisions": [d.to_json() for d in self.decisions],
                "unattributed_bytes_by": {
                    f"{k}/{p}": b
                    for (k, p), b in sorted(self.unattributed.items())
                },
                "finalized": self.finalized,
            }


# -- ambient resolution (lane safety) -----------------------------------------

#: innermost-wins stack of active decision ids (the runtime pushes one
#: around each exchange application; nested fragment pulls push their own)
_SCOPE: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "trino_tpu_torch_decision_scope", default=()
)


def current_ledger() -> Optional[DecisionLedger]:
    """The executing statement's ledger via the lifecycle contextvar
    (None outside a statement — verify sweeps, bare helpers)."""
    from trino_tpu_torch.runtime.lifecycle import current_query

    ctx = current_query()
    if ctx is None:
        return None
    return getattr(ctx, "decisions", None)


def ensure_ledger(ctx) -> DecisionLedger:
    """The context's ledger, created on first use (execute attaches one
    eagerly; this covers bare contexts in tests)."""
    led = getattr(ctx, "decisions", None)
    if led is None:
        led = ctx.decisions = DecisionLedger(ctx.query_id)
    return led


def record_decision(kind: str, site: str, choice: str,
                    alternative: str = "",
                    inputs: Optional[dict] = None) -> Optional[str]:
    """Record into the current statement's ledger; None (and no-op) when
    no statement is executing — planner helpers stay callable bare."""
    led = current_ledger()
    if led is None:
        return None
    return led.record(kind, site, choice, alternative, inputs)


def current_decision() -> Optional[str]:
    stack = _SCOPE.get()
    return stack[-1] if stack else None


@contextmanager
def decision_scope(decision_id: Optional[str]):
    """Attribute collectives issued inside to `decision_id` (innermost
    scope wins; None is a transparent no-op so call sites need no
    branching)."""
    if decision_id is None:
        yield
        return
    token = _SCOPE.set(_SCOPE.get() + (decision_id,))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def observe_collective(fid: int, nbytes: int, kind: str,
                       purpose: str) -> None:
    """MeshProfile.add_collective hook: attribute the bytes to the
    ambient decision (or the ledger's unattributed bucket).  Host-side
    integer bookkeeping only — never a device sync."""
    led = current_ledger()
    if led is None:
        return
    led.observe_collective(current_decision(), fid, nbytes, kind, purpose)


def observe_decision(decision_id: Optional[str], **measured) -> None:
    """Merge measurements into a decision of the current ledger."""
    led = current_ledger()
    if led is not None:
        led.observe(decision_id, **measured)


def _audit_watermark() -> Optional[int]:
    """Current audit-log sequence watermark, for (query_id, seq)
    cross-referencing (telemetry/audit.py); None when no audit log is
    attached."""
    from trino_tpu_torch.telemetry import audit

    return audit.sequence_watermark()

"""Collective-uniformity pass: static SPMD divergence-freedom proofs.

An SPMD mesh program deadlocks the classic way: one worker enters a
collective (all_to_all / all_gather / psum) that the others never issue, or
issues it in a different order, and the whole mesh hangs with no error.
Nothing in the engine *could* diverge today by accident — collectives are
compiled into uniform SPMD programs from plan structure — but nothing
PROVED it either, and the speculative-join retry path is exactly where a
future patch would introduce a per-worker branch around a collective (the
retry decision must come from the already-reduced on-device overflow flag,
never from one worker's local view).

This pass makes the property checkable:

  * `fragment_collectives(fragment)` statically enumerates, in execution
    order, every collective a distributed fragment's compiled step will
    issue — mirroring the mesh executor's dispatch (build side before
    dynamic filters before probe; slot-cap sizing before the fused
    exchange).  Each entry carries a `guard`:
      - `static`  — issued unconditionally from plan structure (uniform by
        construction: every worker runs the same program);
      - `reduced` — issued inside a loop/branch whose condition is a
        globally-reduced value identical on every worker (the speculative
        expansion's overflow flag: the host decision reads the all-worker
        [W] flag, so either every worker retries or none does);
      - anything else is a declared PER-WORKER condition and is rejected.
    A plan rewrite that makes a collective conditional must declare it by
    setting `collective_condition` on the node; `"reduced"` is the only
    sound value.  Undeclared conditionality cannot arise: the executor has
    no data-dependent dispatch besides the reduced retry loop.
  * `check_collective_uniformity(subplan)` walks every fragment and
    returns PlanViolations (`collective-divergence`,
    `collective-unsupported`) — wired into `verify_plan` strict mode next
    to `check_partitioning`, so every distributed TPC-H/TPC-DS plan is
    verified divergence-free at fragmentation time.
  * `collective_signature(subplan)` is the recorded per-fragment sequence
    of mesh collectives (kinds that move bytes over ICI).  The distributed
    runner stores it as `last_collective_signature`;
    `verify.device_residency` asserts a warm replay ISSUES the recorded
    sequence — the dynamic half of the proof, closing the loop between
    what the verifier enumerated and what the profile observed.

Entries marked `elidable` may legally be absent at runtime (runtime
exchange elision when the producing side is already placed; dynamic-filter
summaries skipped for dictionary-coded keys): elision decisions are made
once on the coordinator host from plan+layout state, so they are uniform
across workers by construction — they affect the signature match, never
uniformity.
"""

from __future__ import annotations

from dataclasses import dataclass

from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import (
    FIXED_ARBITRARY,
    FIXED_HASH,
    SOURCE,
    RemoteSourceNode,
    SubPlan,
)
from trino_tpu_torch.verify.plan_checker import PlanViolation

#: partitioning kinds whose fragments execute as SPMD mesh programs
_DIST_KINDS = (SOURCE, FIXED_HASH, FIXED_ARBITRARY)

#: collective kinds that move bytes across the mesh interconnect — the
#: signature compares these (query_stats.COLLECTIVE_KINDS); "gather"
#: entries are host pulls, enumerated for the uniformity reasoning only
MESH_KINDS = ("all_to_all", "all_gather", "reduce")

GUARD_STATIC = "static"
GUARD_REDUCED = "reduced"

#: float/varchar join keys never produce a dynamic-filter summary
#: (dictionary codes are producer-local; float ranges are skipped)
_NO_DYNFILTER_TYPES = ("double", "real", "varchar", "char", "unknown")


@dataclass(frozen=True)
class Collective:
    kind: str  # all_to_all | all_gather | reduce | gather
    purpose: str  # repartition | broadcast | dynamic_filter | capacity_sizing
    origin: str  # node type that issues it
    guard: str = GUARD_STATIC
    #: may legally be skipped at runtime (uniform elision decision)
    elidable: bool = False


def _guard_for(node: P.PlanNode, default: str = GUARD_STATIC) -> str:
    """A node's declared conditionality (`collective_condition`); None means
    unconditional.  Anything but 'reduced' is a per-worker condition the
    checker rejects."""
    cond = getattr(node, "collective_condition", None)
    if cond is None:
        return default
    return str(cond)


class _Enumerator:
    """Mirror of trino_tpu_torch.parallel.runner._MeshExecutor dispatch, emitting
    Collective entries instead of launching programs."""

    def __init__(self):
        self.out: list = []
        self.violations: list = []

    def _emit(self, node, kind, purpose, guard=None, elidable=False):
        g = _guard_for(node) if guard is None else guard
        self.out.append(
            Collective(kind, purpose, type(node).__name__, g, elidable)
        )

    def walk(self, node: P.PlanNode) -> None:
        m = getattr(self, "_c_" + type(node).__name__, None)
        if m is not None:
            m(node)
            return
        # unknown node in a distributed fragment: structure-preserving
        # default (unary chains defer; no collective of their own)
        for c in node.children:
            self.walk(c)

    # -- sources ---------------------------------------------------------------

    def _c_RemoteSourceNode(self, node: RemoteSourceNode) -> None:
        if node.exchange_kind == "broadcast":
            self._emit(node, "all_gather", "broadcast")
        elif node.exchange_kind == "repartition":
            # runtime exchange elision may skip this when the child
            # fragment's output is already placed on the requested keys
            self._emit(node, "all_to_all", "repartition", elidable=True)
        else:
            self.violations.append(
                PlanViolation(
                    "collective-unsupported", node,
                    f"exchange kind {node.exchange_kind!r} cannot feed a "
                    "distributed fragment (the placer should have cut a "
                    "SINGLE fragment here)",
                )
            )

    def _c_TableScanNode(self, node) -> None:
        pass  # host-side feed; bucketize happens before the mesh

    # -- aggregation -----------------------------------------------------------

    def _c_AggregationNode(self, node: P.AggregationNode) -> None:
        if not isinstance(node.source, RemoteSourceNode):
            # exchange elided by the placer: colocated single-stage agg
            self.walk(node.source)
            return
        # fused exchange: slot-cap counts sync, then bucketize+all_to_all+
        # final/single-stage step as one program (same shape for the
        # partial/final and the distinct/holistic single-stage paths).
        # A group-count certificate (verify/capacity.py) licenses the slot
        # cap from the proven group bound — elidable for the same reason
        # as the licensed join's sizing gather: the runner's accept/
        # decline decision is host-side and uniform by construction
        self._emit(
            node, "gather", "capacity_sizing",
            elidable=getattr(node, "capacity_cert", None) is not None,
        )
        self._emit(node.source, "all_to_all", "repartition")

    # -- joins -----------------------------------------------------------------

    def _side(self, side_node) -> None:
        """A join input: a RemoteSource child fragment contributes nothing
        here (its body enumerates under its own fragment id); an inline
        subtree executes in THIS fragment."""
        if not isinstance(side_node, RemoteSourceNode):
            self.walk(side_node)

    def _dynfilter_emittable(self, criteria):
        """(emit, certain): does the inner join register a dynamic-filter
        summary?  Skipped per-criterion for dictionary-coded (varchar) and
        float keys; certain only when every key is integer-kind."""
        kinds = []
        for _, rsym in criteria:
            t = getattr(rsym, "type", None)
            name = getattr(t, "name", "unknown")
            kinds.append(name not in _NO_DYNFILTER_TYPES)
        return any(kinds), all(kinds)

    def _c_JoinNode(self, node: P.JoinNode) -> None:
        if not node.criteria:
            for c in node.children:
                self._side(c)
            return
        # execution order: build side first, then its dynamic-filter
        # summary, then the probe side, then placement, then expansion
        self._side(node.right)
        if node.kind == "inner":
            emit, certain = self._dynfilter_emittable(node.criteria)
            if emit:
                self._emit(
                    node, "reduce", "dynamic_filter", elidable=not certain
                )
        self._side(node.left)
        if node.distribution == "broadcast":
            self._emit(node, "all_gather", "broadcast")
        else:
            for side in (node.right, node.left):  # build placed first
                if (
                    isinstance(side, RemoteSourceNode)
                    and side.exchange_kind == "repartition"
                ):
                    self._emit(side, "all_to_all", "repartition")
        # speculative/sized expansion: the overflow-flag read, and the
        # retry decision it feeds, use the ALL-worker [W] flag — reduced,
        # therefore uniform (the pass's interesting customer).  A join
        # carrying a capacity certificate (verify/capacity.py) is PROOF-
        # GATED: the licensed path compiles at the certified capacity and
        # issues no sizing gather at all — elidable, because the runner
        # falls back to the sizing path when the seal doesn't match the
        # executing mesh (the decision is made once on the coordinator,
        # uniform by construction, like exchange elision)
        self._emit(
            node, "gather", "capacity_sizing",
            guard=_guard_for(node, GUARD_REDUCED),
            elidable=getattr(node, "capacity_cert", None) is not None,
        )

    def _c_SemiJoinNode(self, node: P.SemiJoinNode) -> None:
        self._side(node.source)
        if node.filter is not None:
            # residual semi join: repartition both sides on the key (either
            # may elide when already placed), then the sized expansion
            for side in (node.source, node.filtering):
                self._emit(side, "all_to_all", "repartition", elidable=True)
            self._emit(
                node, "gather", "capacity_sizing",
                guard=_guard_for(node, GUARD_REDUCED),
            )
            return
        self._emit(node, "all_gather", "broadcast")


def fragment_collectives(sub: SubPlan) -> tuple:
    """(collectives, violations) for ONE fragment's body (no recursion into
    child fragments)."""
    e = _Enumerator()
    if sub.fragment.partitioning.kind in _DIST_KINDS:
        e.walk(sub.fragment.root)
    else:
        # SINGLE/COORDINATOR_ONLY fragments run on the host over gathered
        # inputs: no mesh collectives of their own, and nothing to diverge
        pass
    return tuple(e.out), e.violations


def collective_signature(sub: SubPlan) -> dict:
    """{fragment id: ((kind, purpose, elidable), ...)} over mesh-collective
    kinds, in issue order — the statically recorded sequence
    `verify.device_residency` holds warm replays to."""
    out: dict = {}
    for s in _walk_subplans(sub):
        cols, _ = fragment_collectives(s)
        out[s.fragment.id] = tuple(
            (c.kind, c.purpose, c.elidable)
            for c in cols
            if c.kind in MESH_KINDS
        )
    return out


def _walk_subplans(sub: SubPlan):
    yield sub
    for c in sub.children:
        yield from _walk_subplans(c)


def check_collective_uniformity(sub: SubPlan) -> list:
    """Verify every fragment's collective sequence is divergence-free:
    well-defined from plan structure, identical across workers, and never
    conditional on per-worker data.  Returns PlanViolations (empty =
    proven uniform)."""
    violations: list = []

    def visit(s: SubPlan) -> None:
        cols, vs = fragment_collectives(s)
        violations.extend(vs)
        for c in cols:
            if c.guard not in (GUARD_STATIC, GUARD_REDUCED):
                violations.append(
                    PlanViolation(
                        "collective-divergence", s.fragment.root,
                        f"fragment {s.fragment.id}: {c.kind}/{c.purpose} "
                        f"from {c.origin} is conditional on per-worker "
                        f"data ({c.guard!r}) — a worker that skips it "
                        "deadlocks the mesh; gate it on a globally-"
                        "reduced value (collective_condition='reduced') "
                        "or issue it unconditionally",
                    )
                )
        for child in s.children:
            visit(child)

    visit(sub)
    return violations


# -- signature matching (the dynamic half, used by device_residency) -----------


def signature_problems(expected: dict, actual: dict) -> list:
    """Compare the static signature against an executed run's recorded
    per-fragment mesh-collective sequence ({fid: ((kind, purpose), ...)}).
    Expected entries marked elidable may be absent; everything else must
    appear, in order, with nothing unexpected.  Returns human-readable
    problem strings (empty = the replay issued the recorded sequence)."""
    def matches(exp, act, i=0, j=0) -> bool:
        # backtracking (not greedy first-fit): an ELIDED entry followed by a
        # required one with the same (kind, purpose) must not steal the
        # issued collective from the required slot.  Sequences are tiny
        # (a handful per fragment), so plain recursion is fine.
        if i == len(exp):
            return j == len(act)
        kind, purpose, elidable = exp[i]
        if (
            j < len(act)
            and act[j] == (kind, purpose)
            and matches(exp, act, i + 1, j + 1)
        ):
            return True
        return elidable and matches(exp, act, i + 1, j)

    problems = []
    for fid in sorted(set(expected) | set(actual)):
        exp = list(expected.get(fid, ()))
        act = list(actual.get(fid, ()))
        if not matches(exp, act):
            problems.append(
                f"fragment {fid}: issued collective sequence "
                f"{act} does not match the recorded signature "
                f"{[(k, p) + (('elidable',) if e else ()) for k, p, e in exp]}"
            )
    return problems

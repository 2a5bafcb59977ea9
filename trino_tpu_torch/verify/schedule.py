"""Collective-schedule licenses: proof-gated eager dispatch of independent
fragments.

Port of trino_tpu/verify/schedule.py.  The collective-uniformity pass
(`verify.collectives`) proves every distributed fragment's collective
sequence divergence-free and statically known.  That proof has a
scheduling consequence: when the per-fragment sequences are fixed by plan
structure and never conditional on per-worker data, the coordinator may
choose any interleaving of *independent* fragments and every worker still
sees the same, uniform dispatch.  So independent build-side fragments may
be dispatched eagerly, back to back, before the consumer's body runs.

A `ScheduleLicense` is emitted per query at fragmentation time and
records:

  * the per-fragment mesh-collective witness (the collective signature)
    the warm replay is held to — `verify.residency` asserts a licensed
    query's warm replays issue EXACTLY the licensed schedule;
  * `async_children`: for each consumer fragment, the child fragments the
    executor may PRE-DISPATCH before executing the consumer's body.
    Licensed children are the build-side feeds on the body's
    FIRST-EVALUATED spine — the feeds the lazy executor would run first
    anyway, before any of the body's dynamic filters register — so
    pre-dispatch preserves dynamic-filter ordering by construction.
    Probe-side feeds, and build feeds the lazy order evaluates only
    AFTER a sibling join's filters register (e.g. nested in a probe
    subtree), are deliberately NOT licensed: executing one early would
    run its scans unpruned.

Licensing preconditions (all statically checked; no license otherwise):

  * every fragment passes `check_collective_uniformity`;
  * each licensed child fragment is itself distributed and SYNC-FREE: its
    enumerated sequence contains no unconditional `gather` (host-pull)
    entries.  Capacity-certified joins (verify/capacity.py) satisfy this —
    their sizing gather is deleted.

The license is a plan-level fact and equals the JAX package's for every
plan.  On the card a sync-free fragment can still read a count to the host
(a capacity or an exchange's slot sizes), which blocks the stream; what
pre-dispatch gains there is measured, not assumed.  The executor bumps
`collective_async` per licensed pre-dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import RemoteSourceNode, SubPlan
from trino_tpu_torch.verify.collectives import (
    _DIST_KINDS,
    check_collective_uniformity,
    collective_signature,
    fragment_collectives,
)


@dataclass
class ScheduleLicense:
    """Per-query authorization for asynchronous collective dispatch."""

    #: {fragment id: ((kind, purpose, elidable), ...)} — the statically
    #: recorded mesh-collective schedule warm replays must issue
    fragments: dict = field(default_factory=dict)
    #: {consumer fragment id: (child fragment ids licensed for eager
    #: pre-dispatch, in build order)}
    async_children: dict = field(default_factory=dict)
    #: mesh width the license was issued for
    mesh_w: int = 0

    def licensed_count(self) -> int:
        return sum(len(v) for v in self.async_children.values())

    def to_json(self) -> dict:
        return {
            "fragments": {
                int(k): [list(c) for c in v]
                for k, v in self.fragments.items()
            },
            "async_children": {
                int(k): list(v) for k, v in self.async_children.items()
            },
            "mesh_w": int(self.mesh_w),
        }


def _sync_free(sub: SubPlan) -> bool:
    """A fragment whose statically enumerated sequence contains no
    unconditional host-pull: its dispatch never blocks the device queue on
    a sizing round-trip.  Elidable gathers (capacity-certified joins,
    runtime-elided sizing) are licensed absences, not syncs."""
    cols, violations = fragment_collectives(sub)
    if violations:
        return False
    return not any(c.kind == "gather" and not c.elidable for c in cols)


def _subtree_registers_filters(node) -> bool:
    """Whether lazily evaluating `node` can register dynamic filters
    (inner joins do, after their build side returns)."""
    if isinstance(node, RemoteSourceNode):
        return False
    if isinstance(node, (P.JoinNode, P.SemiJoinNode)):
        return True  # conservative: any join family counts
    return any(_subtree_registers_filters(c) for c in node.children)


def _build_side_children(sub: SubPlan) -> tuple:
    """Child fragment ids safe to PRE-DISPATCH: the feeds on the fragment
    body's first-evaluated spine, which the lazy executor would run
    before any of this fragment's dynamic filters register.

    Collection STOPS at the first join whose build feed completes — the
    executor registers that join's dynamic filters next (inner joins,
    `_register_dynamic_filters`), so a feed the lazy order evaluates
    later (e.g. a build feed nested in the probe subtree) must stay lazy:
    pre-dispatching it would run its scans before the filters that prune
    them.  Semi-joins evaluate their SOURCE side first, so the filtering
    feed is licensed only when the source subtree provably registers no
    filters ahead of it."""
    order: list = []

    def first(node) -> None:
        if isinstance(node, P.JoinNode):
            # executor evaluates the build (right) side first; filters
            # register before the probe side is ever pulled
            if isinstance(node.right, RemoteSourceNode):
                order.append(node.right.fragment_id)
            else:
                first(node.right)
            return
        if isinstance(node, P.SemiJoinNode):
            if isinstance(
                node.filtering, RemoteSourceNode
            ) and not _subtree_registers_filters(node.source):
                order.append(node.filtering.fragment_id)
            return
        # single-input operators preserve evaluation order; multi-input
        # nodes (unions) have no statically safe prefix — stop there
        if len(node.children) == 1 and not isinstance(
            node.children[0], RemoteSourceNode
        ):
            first(node.children[0])

    first(sub.fragment.root)
    # preserve first-reference order, drop duplicates
    seen: set = set()
    out = []
    for fid in order:
        if fid not in seen:
            seen.add(fid)
            out.append(fid)
    return tuple(out)


def license_schedule(sub: SubPlan, n_workers: int):
    """-> ScheduleLicense, or None when the divergence-freedom
    precondition fails (a fragment with an unproven collective sequence
    must keep strictly lazy, order-conservative dispatch)."""
    if check_collective_uniformity(sub):
        return None
    by_fid: dict = {}

    def index(s: SubPlan) -> None:
        by_fid[s.fragment.id] = s
        for c in s.children:
            index(c)

    index(sub)
    async_children: dict = {}
    for fid, s in by_fid.items():
        if s.fragment.partitioning.kind not in _DIST_KINDS:
            continue
        licensed = tuple(
            cfid
            for cfid in _build_side_children(s)
            if cfid in by_fid
            and by_fid[cfid].fragment.partitioning.kind in _DIST_KINDS
            and _sync_free(by_fid[cfid])
        )
        if licensed:
            async_children[fid] = licensed
    return ScheduleLicense(
        fragments=collective_signature(sub),
        async_children=async_children,
        mesh_w=int(n_workers),
    )

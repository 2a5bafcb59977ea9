"""Exchange placement + plan fragmentation.

Reference: sql/planner/optimizations/AddExchanges.java:139 (distribution
choice), sql/planner/PlanFragmenter.java:116 (createSubPlans — cut the plan
at remote-exchange boundaries), SystemPartitioningHandle.java:41-57 (the
partitioning vocabulary), plan/RemoteSourceNode.java.

`add_exchanges` rewrites an optimized logical plan into a distributed form
with explicit ExchangeNodes; `create_subplans` cuts it into a SubPlan tree of
PlanFragments, each with a partitioning handle.  The distributed runner
executes fragments bottom-up: fragment bodies are SPMD programs over the
worker mesh, exchanges lower to ICI collectives (all_to_all / all_gather) or
a gather to the coordinator — never a silent fallback: every
coordinator-side fragment is explicit in the plan (EXPLAIN shows it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.functions import HOLISTIC_AGGS, PARTITIONABLE_HOLISTIC
from trino_tpu_torch.telemetry.decisions import record_decision

# -- partitioning handles (SystemPartitioningHandle.java:41-57) ---------------

SOURCE = "SOURCE"  # leaf: split-parallel scans
FIXED_HASH = "FIXED_HASH"  # rows hash-distributed on keys
FIXED_ARBITRARY = "FIXED_ARBITRARY"  # distributed, no key guarantee
SINGLE = "SINGLE"  # one task (the coordinator here)
COORDINATOR_ONLY = "COORDINATOR_ONLY"  # must run on the coordinator


@dataclass(frozen=True)
class PartitioningHandle:
    kind: str
    keys: tuple = ()  # Symbol names for FIXED_HASH

    def __str__(self):
        if self.keys:
            return f"{self.kind}[{', '.join(self.keys)}]"
        return self.kind


@dataclass
class RemoteSourceNode(P.PlanNode):
    """Consumer-side stand-in for a child fragment's output
    (reference: sql/planner/plan/RemoteSourceNode.java)."""

    fragment_id: int
    symbols: list  # output symbols (child fragment's root outputs)
    exchange_kind: str  # repartition | broadcast | gather | merge
    partition_symbols: list = field(default_factory=list)
    orderings: list = field(default_factory=list)  # merge exchanges
    #: plan-decision id carried from the cut ExchangeNode: the runtime
    #: applies this exchange under a matching decision_scope, so the
    #: collective's measured bytes join the placer's recorded choice
    decision_id: Optional[str] = None

    @property
    def outputs(self):
        return list(self.symbols)

    @property
    def children(self):
        return []

    def with_children(self, children):
        return self


@dataclass
class PlanFragment:
    """reference: sql/planner/plan/PlanFragment.java."""

    id: int
    root: P.PlanNode
    partitioning: PartitioningHandle


@dataclass
class SubPlan:
    """reference: sql/planner/SubPlan.java — fragment tree."""

    fragment: PlanFragment
    children: list

    def all_fragments(self):
        yield self.fragment
        for c in self.children:
            yield from c.all_fragments()


# -- AddExchanges -------------------------------------------------------------


class _Distribution:
    """Bottom-up distribution property of a subtree (PropertyDerivations
    analog): 'distributed' (rows spread over workers) or 'single'."""

    DISTRIBUTED = "distributed"
    SINGLE = "single"


class ExchangePlacer:
    """Insert ExchangeNodes so every operator's distribution requirement is
    met, choosing broadcast vs partitioned joins by stats (AddExchanges)."""

    def __init__(self, catalogs, properties=None, n_workers: int = 8,
                 colocate=None):
        from trino_tpu_torch.partitioning import LayoutResolver
        from trino_tpu_torch.runtime.session import SessionProperties

        self.catalogs = catalogs
        self.properties = properties or SessionProperties()
        self.n_workers = n_workers
        self.resolver = LayoutResolver(catalogs, self.properties)
        if colocate is not None:
            # executors whose data plane cannot honor hash placements
            # (the HTTP split_mod scheduler) force elision off regardless
            # of the session property
            self.colocate = bool(colocate)
        else:
            try:
                self.colocate = bool(self.properties.get("colocated_join"))
            except KeyError:  # pragma: no cover - older property sets
                self.colocate = True

    def _placements(self, node: P.PlanNode) -> tuple:
        from trino_tpu_torch.partitioning import derive_partitioning

        if not self.colocate:
            return ()
        return derive_partitioning(node, self.resolver, self.n_workers)

    def place(self, node: P.PlanNode):
        self._register_scan_dictionaries(node)
        out, dist = self._visit(node)
        return out

    def _register_scan_dictionaries(self, node: P.PlanNode) -> None:
        """Eagerly register global dictionaries for every scanned string
        column (runtime/dictionary_service), not just join keys: the
        exchange serde then ships (key, version) refs instead of
        dictionary values for ANY distributed varchar column, and the
        prewarm manifest snapshots the assignment the workload actually
        ran under.  Connector dictionaries are cached, so this is one
        cheap fingerprint lookup per (table, column) per plan."""
        from trino_tpu_torch.partitioning.properties import (
            derive_dictionary_coding,
        )

        for n in P.walk(node):
            if isinstance(n, P.TableScanNode):
                derive_dictionary_coding(n, self.resolver)

    # returns (node, distribution)
    def _visit(self, node: P.PlanNode):
        m = getattr(self, "_p_" + type(node).__name__, None)
        if m is not None:
            return m(node)
        # unknown node: run on the coordinator over gathered children
        return self._coordinator_only(node)

    def _coordinator_only(self, node: P.PlanNode):
        kids = []
        for c in node.children:
            child, dist = self._visit(c)
            kids.append(self._gathered(child, dist))
        return node.with_children(kids) if kids else node, _Distribution.SINGLE

    def _gathered(self, node: P.PlanNode, dist: str) -> P.PlanNode:
        if dist == _Distribution.SINGLE:
            return node
        return P.ExchangeNode(node, "gather")

    # -- leaves --

    def _p_TableScanNode(self, node):
        return node, _Distribution.DISTRIBUTED

    def _p_ValuesNode(self, node):
        return node, _Distribution.SINGLE

    # -- distribution-preserving unaries --

    def _inherit(self, node):
        child, dist = self._visit(node.children[0])
        return node.with_children([child]), dist

    _p_FilterNode = _inherit
    _p_ProjectNode = _inherit
    _p_SampleNode = _inherit  # Bernoulli sampling is row-local
    _p_UnnestNode = _inherit  # elementwise expansion: stays in its fragment

    def _p_OutputNode(self, node):
        child, dist = self._visit(node.source)
        return node.with_children([self._gathered(child, dist)]), _Distribution.SINGLE

    def _p_EnforceSingleRowNode(self, node):
        child, dist = self._visit(node.source)
        return node.with_children([self._gathered(child, dist)]), _Distribution.SINGLE

    # -- aggregation: partial below exchange, final above --

    def _p_AggregationNode(self, node: P.AggregationNode):
        child, dist = self._visit(node.source)
        if dist == _Distribution.SINGLE:
            return node.with_children([child]), _Distribution.SINGLE
        from trino_tpu_torch.runtime.local_planner import supports_uniform_distinct

        has_distinct = any(a.distinct for _, a in node.aggregations)
        # uniform DISTINCT keeps its distributed shape: repartition on group
        # keys, per-worker dedupe + single-stage agg (the shared predicate
        # IS the _distinct_preagg support envelope)
        uniform_distinct = (
            has_distinct
            and bool(node.group_symbols)
            and supports_uniform_distinct(node)
        )
        needs_gather = (has_distinct and not uniform_distinct) or any(
            a.function in HOLISTIC_AGGS
            and a.function not in PARTITIONABLE_HOLISTIC
            for _, a in node.aggregations
        ) or (
            not node.group_symbols
            and any(
                a.function in HOLISTIC_AGGS for _, a in node.aggregations
            )
        )
        if needs_gather:
            # DISTINCT / collect aggregates (and global holistic aggs) need
            # the whole group on one node; the local engine handles them
            # after a gather
            return (
                node.with_children([self._gathered(child, dist)]),
                _Distribution.SINGLE,
            )
        # NOTE: grouped percentile does NOT gather — a hash repartition on
        # the group keys co-locates each whole group, so the executor runs
        # the single-stage sort-based percentile per worker (the reference's
        # single-step aggregation over hash distribution)
        if node.group_symbols:
            # exchange elision: when the child is already placed on a
            # subset of the grouping keys (a bucketed scan or an upstream
            # repartition), every group is whole on one worker — run the
            # aggregation single-stage with NO exchange (the reference's
            # partitioning-matching in AddExchanges)
            if not has_distinct and not any(
                a.function in HOLISTIC_AGGS for _, a in node.aggregations
            ):
                gnames = {s.name for s in node.group_symbols}
                if any(
                    t and set(t) <= gnames for t in self._placements(child)
                ):
                    record_decision(
                        "exchange", "planner.agg_placement", "elide",
                        "repartition", {"group_keys": sorted(gnames)},
                    )
                    return (
                        node.with_children([child]),
                        _Distribution.DISTRIBUTED,
                    )
            # the executor pushes the PARTIAL step to the producing side of
            # the exchange and runs FINAL above it (the
            # PushPartialAggregationThroughExchange effect)
            did = record_decision(
                "exchange", "planner.agg_placement", "repartition", "gather",
                {"group_keys": [s.name for s in node.group_symbols]},
            )
            ex = P.ExchangeNode(
                child, "repartition", list(node.group_symbols),
                decision_id=did,
            )
            return node.with_children([ex]), _Distribution.DISTRIBUTED
        # global aggregation: partial states per worker, gathered + merged
        ex = P.ExchangeNode(child, "gather")
        return node.with_children([ex]), _Distribution.SINGLE

    # -- joins --

    def _p_JoinNode(self, node: P.JoinNode):
        from trino_tpu_torch.planner.stats import estimate_rows

        if node.kind == "right":
            # distribute as the flipped LEFT join (the local engine performs
            # the same flip; symbol resolution is by name, so output order
            # does not matter at this level)
            node = P.JoinNode(
                "left",
                node.right,
                node.left,
                [(r, l) for l, r in node.criteria],
                node.filter,
                node.distribution,
            )
            # the ORIGINAL certificate described the pre-flip build side,
            # so it cannot be carried verbatim — but the flipped node is a
            # plain left join whose own proof (the old LEFT side's
            # uniqueness/multiplicity) is derivable right here.  Without
            # this, every mirrored plan shape the optimizer emits loses
            # its license and pays the runtime sizing path.
            from trino_tpu_torch.verify.capacity import derive_join_certificate

            node.capacity_cert = derive_join_certificate(node, self.catalogs)
        left, ldist = self._visit(node.left)
        right, rdist = self._visit(node.right)
        supported = node.kind in ("inner", "left", "full") and node.criteria
        if not supported or ldist == _Distribution.SINGLE:
            return (
                node.with_children(
                    [self._gathered(left, ldist), self._gathered(right, rdist)]
                ),
                _Distribution.SINGLE,
            )
        pref = self.properties.get("join_distribution_type").upper()
        limit = self.properties.get("broadcast_join_rows")
        est = estimate_rows(node.right, self.catalogs)
        broadcast = pref == "BROADCAST" or (
            pref == "AUTOMATIC" and est is not None and est <= limit
        )
        if node.kind == "full":
            # a broadcast FULL join would emit the unmatched build tail once
            # PER WORKER; repartitioning keeps every build row on exactly
            # one worker (reference: AddExchanges forces partitioned for
            # full/right joins)
            broadcast = False
        # decision-ledger inputs: exactly what this rule saw when it chose
        # (telemetry/decisions) — the hindsight join compares the measured
        # collective bytes against the rejected alternative's estimate
        inputs = {
            "join_kind": node.kind,
            "estimated_build_rows": est,
            "broadcast_join_rows": limit,
            "join_distribution_type": pref,
        }
        if broadcast and self.colocate:
            # partitioning matching beats the stats heuristic: when the
            # PROBE side is already placed on its keys (bucketed layout or
            # upstream exchange), a partitioned join moves at most the
            # build side once — strictly less than W broadcast copies; a
            # fully co-located join moves nothing at all
            lex, rex, dist = self._partitioned_join_sides(
                left, right, node.criteria
            )
            if dist == "colocated" or lex is left:
                did = record_decision(
                    "join_distribution", "planner.add_exchanges", dist,
                    "broadcast", inputs,
                )
                self._stamp(lex, did)
                self._stamp(rex, did)
                return (
                    P.JoinNode(
                        node.kind, lex, rex, node.criteria, node.filter,
                        dist, node.capacity_cert, did,
                    ),
                    _Distribution.DISTRIBUTED,
                )
        if broadcast:
            did = record_decision(
                "join_distribution", "planner.add_exchanges", "broadcast",
                "partitioned", inputs,
            )
            ex = P.ExchangeNode(right, "broadcast", decision_id=did)
            out = P.JoinNode(
                node.kind, left, ex, node.criteria, node.filter,
                "broadcast", node.capacity_cert, did,
            )
        else:
            lex, rex, dist = self._partitioned_join_sides(
                left, right, node.criteria
            )
            did = record_decision(
                "join_distribution", "planner.add_exchanges", dist,
                "broadcast", inputs,
            )
            self._stamp(lex, did)
            self._stamp(rex, did)
            out = P.JoinNode(
                node.kind, lex, rex, node.criteria, node.filter, dist,
                node.capacity_cert, did,
            )
        return out, _Distribution.DISTRIBUTED

    @staticmethod
    def _stamp(node, decision_id) -> None:
        """Attribute an exchange the placer just inserted to a decision
        (never overwrites: an exchange belongs to exactly one choice)."""
        if (
            isinstance(node, P.ExchangeNode)
            and node.decision_id is None
        ):
            node.decision_id = decision_id

    def _partitioned_join_sides(self, left, right, criteria):
        """Exchange placement for a partitioned join, with partitioning
        matching: a side already placed on (a subset of) its join keys
        keeps its placement and skips the repartition; when BOTH sides
        share an aligned placement the join is fully co-located.  The
        repartitioned side hashes the keys ALIGNED with the placed side's
        tuple, so equal-key rows of the two sides land on one worker.

        String keys participate ONLY when both sides carry the same
        versioned global dictionary assignment (`derive_dictionary_coding`)
        — the version gate that makes varchar keys co-locate like integer
        keys without ever trusting producer-local codes."""
        from trino_tpu_torch.partitioning import (
            align_through_criteria,
            derive_dictionary_coding,
            hash_aligned_criteria,
        )

        lprops = self._placements(left)
        rprops = self._placements(right)
        coding = dict(derive_dictionary_coding(left, self.resolver))
        coding.update(derive_dictionary_coding(right, self.resolver))
        aligned = hash_aligned_criteria(criteria, coding)
        # dictionary-coding placement lift: versioned varchar keys that
        # participate in hash alignment like integers — a choice worth a
        # ledger entry, because the rejected alternative (dropping the
        # string keys from the alignment) forces a wider repartition
        from trino_tpu_torch import types as T

        coded = [
            f"{l.name}={r.name}"
            for l, r in aligned
            if T.is_string_kind(l.type)
        ]
        if coded:
            record_decision(
                "dictionary_placement", "planner.partitioned_join_sides",
                "coded_colocate", "exclude_varchar_keys",
                {"keys": coded},
            )
        l2r = {l.name: r for l, r in aligned}
        for tl in lprops:
            if tl and all(n in l2r for n in tl):
                tr = tuple(l2r[n].name for n in tl)
                if tr in rprops:
                    return left, right, "colocated"
        lal = align_through_criteria(lprops, criteria, True, coding)
        if lal is not None:
            _, other = lal
            return left, P.ExchangeNode(right, "repartition", list(other)), "partitioned"
        ral = align_through_criteria(rprops, criteria, False, coding)
        if ral is not None:
            _, other = ral
            return P.ExchangeNode(left, "repartition", list(other)), right, "partitioned"
        return (
            P.ExchangeNode(left, "repartition", [l for l, _ in criteria]),
            P.ExchangeNode(right, "repartition", [r for _, r in criteria]),
            "partitioned",
        )

    def _p_SemiJoinNode(self, node: P.SemiJoinNode):
        src, sdist = self._visit(node.source)
        filt, fdist = self._visit(node.filtering)
        if sdist == _Distribution.SINGLE:
            return (
                node.with_children(
                    [self._gathered(src, sdist), self._gathered(filt, fdist)]
                ),
                _Distribution.SINGLE,
            )
        if node.filter is not None:
            # residual-filtered semi join: repartition BOTH sides on the key
            # so every key-matching candidate pair is co-located; the
            # residual evaluates per shard (reference: AddExchanges semi join
            # partitioned distribution)
            did = record_decision(
                "join_distribution", "planner.semijoin", "partitioned",
                "broadcast",
                {"residual": True, "key": node.source_key.name},
            )
            sex = P.ExchangeNode(
                src, "repartition", [node.source_key], decision_id=did
            )
            fex = P.ExchangeNode(
                filt, "repartition", [node.filtering_key], decision_id=did
            )
            out = node.with_children([sex, fex])
            out.decision_id = did
            return out, _Distribution.DISTRIBUTED
        did = record_decision(
            "join_distribution", "planner.semijoin", "broadcast",
            "partitioned",
            {"residual": False, "key": node.source_key.name},
        )
        ex = P.ExchangeNode(filt, "broadcast", decision_id=did)
        out = node.with_children([src, ex])
        out.decision_id = did
        return out, _Distribution.DISTRIBUTED

    # -- sorting / limiting: partial per worker + merge/gather + final --

    def _p_SortNode(self, node: P.SortNode):
        child, dist = self._visit(node.source)
        if dist == _Distribution.SINGLE:
            return node.with_children([child]), _Distribution.SINGLE
        partial = P.SortNode(child, node.orderings)
        ex = P.ExchangeNode(partial, "merge", [], list(node.orderings))
        return ex, _Distribution.SINGLE

    def _p_TopNNode(self, node: P.TopNNode):
        child, dist = self._visit(node.source)
        if dist == _Distribution.SINGLE:
            return node.with_children([child]), _Distribution.SINGLE
        partial = P.TopNNode(child, node.orderings, node.count)
        ex = P.ExchangeNode(partial, "merge", [], list(node.orderings))
        return P.TopNNode(ex, node.orderings, node.count), _Distribution.SINGLE

    def _p_LimitNode(self, node: P.LimitNode):
        child, dist = self._visit(node.source)
        if dist == _Distribution.SINGLE:
            return node.with_children([child]), _Distribution.SINGLE
        if node.count is None:  # OFFSET-only: no partial-limit benefit
            return (
                P.LimitNode(self._gathered(child, dist), None, node.offset),
                _Distribution.SINGLE,
            )
        # per-worker partial limit keeps offset+count rows; final applies both
        partial = P.LimitNode(child, node.count + node.offset)
        ex = P.ExchangeNode(partial, "gather")
        return P.LimitNode(ex, node.count, node.offset), _Distribution.SINGLE

    # -- window: repartition on partition keys --

    def _p_WindowNode(self, node: P.WindowNode):
        child, dist = self._visit(node.source)
        if dist == _Distribution.SINGLE:
            return node.with_children([child]), _Distribution.SINGLE
        if not node.partition_by:
            # whole-input window: single partition must see every row
            return (
                node.with_children([self._gathered(child, dist)]),
                _Distribution.SINGLE,
            )
        did = record_decision(
            "exchange", "planner.window", "repartition", "gather",
            {"partition_by": [s.name for s in node.partition_by]},
        )
        ex = P.ExchangeNode(
            child, "repartition", list(node.partition_by), decision_id=did
        )
        return node.with_children([ex]), _Distribution.DISTRIBUTED

    def _p_MarkDistinctNode(self, node):
        child, dist = self._visit(node.source)
        if dist == _Distribution.SINGLE:
            return node.with_children([child]), _Distribution.SINGLE
        # repartition on the full key set: every distinct combination lands
        # wholly on one worker, so first-occurrence marks are globally unique
        did = record_decision(
            "exchange", "planner.mark_distinct", "repartition", "gather",
            {"keys": [s.name for s in node.key_symbols]},
        )
        ex = P.ExchangeNode(
            child, "repartition", list(node.key_symbols), decision_id=did
        )
        return node.with_children([ex]), _Distribution.DISTRIBUTED

    # -- set operations --

    def _p_UnionNode(self, node: P.UnionNode):
        kids = []
        dists = []
        for c in node.children:
            k, d = self._visit(c)
            kids.append(k)
            dists.append(d)
        if all(d == _Distribution.SINGLE for d in dists):
            return node.with_children(kids), _Distribution.SINGLE
        # mixed: gather everything (UNION semantics are arbitrary-ordered, a
        # distributed union would also be fine; coordinator concat is exact)
        kids = [self._gathered(k, d) for k, d in zip(kids, dists)]
        return node.with_children(kids), _Distribution.SINGLE

    def _p_ExchangeNode(self, node: P.ExchangeNode):
        return self._inherit(node)


def _verify_mode(properties) -> str:
    from trino_tpu_torch import verify as V

    mode = None
    if properties is not None:
        try:
            mode = properties.get("verify_plan")
        except KeyError:  # pragma: no cover - older property sets
            mode = None
    return V.resolve_mode(mode)


def add_exchanges(plan: P.OutputNode, catalogs, properties=None,
                  n_workers: int = 8, colocate=None):
    from trino_tpu_torch import verify as V

    placer = ExchangePlacer(catalogs, properties, n_workers, colocate=colocate)
    out = placer.place(plan)
    assert isinstance(out, P.OutputNode)
    # distributed invariants: every ExchangeNode's partition symbols exist
    # with hashable dtypes, no placement broke dependencies, and every
    # elided exchange is backed by a producing layout or exchange
    mode = _verify_mode(properties)
    if mode != "off":
        from trino_tpu_torch.verify.partitioning import check_partitioning

        V.enforce(V.check_plan(out), mode)
        V.enforce(
            check_partitioning(out, placer.resolver, n_workers), mode
        )
    return out


# -- PlanFragmenter -----------------------------------------------------------


class _Fragmenter:
    def __init__(self, resolver=None, n_workers: int = 8):
        self.next_id = 0
        self.resolver = resolver
        self.n_workers = n_workers

    def fragment(self, root: P.PlanNode) -> SubPlan:
        """Cut at every ExchangeNode; the subtree below each exchange becomes
        a child fragment, replaced by a RemoteSourceNode in the parent."""
        children: list[SubPlan] = []

        def cut(node: P.PlanNode) -> P.PlanNode:
            if isinstance(node, P.ExchangeNode):
                child_sub = self.fragment(node.source)
                children.append(child_sub)
                return RemoteSourceNode(
                    child_sub.fragment.id,
                    list(node.source.outputs),
                    node.kind,
                    list(node.partition_symbols),
                    list(node.orderings),
                    node.decision_id,
                )
            kids = node.children
            if not kids:
                return node
            return node.with_children([cut(c) for c in kids])

        body = cut(root)
        fid = self.next_id
        self.next_id += 1
        part = _fragment_partitioning(body, self.resolver, self.n_workers)
        sub = SubPlan(PlanFragment(fid, body, part), children)
        return sub


def _fragment_partitioning(
    body: P.PlanNode, resolver=None, n_workers: int = 8
) -> PartitioningHandle:
    """Derive the fragment's partitioning handle from its body.  SOURCE
    fragments report their layout-derived partition symbols (when the
    resolver finds a usable bucketed layout), so EXPLAIN (TYPE DISTRIBUTED)
    makes layout decisions auditable without reading planner internals."""
    has_scan = any(isinstance(n, P.TableScanNode) for n in P.walk(body))
    remotes = [n for n in P.walk(body) if isinstance(n, RemoteSourceNode)]
    if has_scan:
        keys: tuple = ()
        if resolver is not None:
            from trino_tpu_torch.partitioning import derive_partitioning

            props = derive_partitioning(body, resolver, n_workers)
            if props:
                keys = props[0]
        return PartitioningHandle(SOURCE, keys)
    for r in remotes:
        if r.exchange_kind == "repartition":
            return PartitioningHandle(
                FIXED_HASH, tuple(s.name for s in r.partition_symbols)
            )
    for r in remotes:
        if r.exchange_kind in ("gather", "merge"):
            return PartitioningHandle(SINGLE)
        if r.exchange_kind == "broadcast":
            return PartitioningHandle(FIXED_ARBITRARY)
    return PartitioningHandle(COORDINATOR_ONLY)


def create_subplans(
    distributed_plan: P.PlanNode,
    properties=None,
    catalogs=None,
    n_workers: int = 8,
) -> SubPlan:
    from trino_tpu_torch import verify as V
    from trino_tpu_torch.partitioning import LayoutResolver

    resolver = LayoutResolver(catalogs, properties)
    sub = _Fragmenter(resolver, n_workers).fragment(distributed_plan)
    # fragment invariants: unique fragment ids, every RemoteSourceNode names
    # an existing fragment whose root outputs match symbol-for-symbol —
    # plus the collective-uniformity pass: every distributed fragment's
    # statically enumerated collective sequence is divergence-free (never
    # conditional on per-worker data), so an SPMD program can't hang the
    # mesh on a collective one worker skips
    mode = _verify_mode(properties)
    if mode != "off":
        from trino_tpu_torch.verify.collectives import check_collective_uniformity

        V.enforce(V.check_subplan(sub), mode)
        V.enforce(check_collective_uniformity(sub), mode)
    return sub


def fragment_text(sub: SubPlan) -> str:
    """EXPLAIN (TYPE DISTRIBUTED) rendering (planprinter role)."""
    lines = []

    def render(s: SubPlan):
        lines.append(f"Fragment {s.fragment.id} [{s.fragment.partitioning}]")
        body = P.plan_text(s.fragment.root, indent=1)
        lines.append(body.rstrip("\n"))
        for c in s.children:
            render(c)

    render(sub)
    return "\n".join(lines) + "\n"

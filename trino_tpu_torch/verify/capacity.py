"""Capacity certificates: sound join-cardinality proofs that delete the
runtime sizing round-trip from the mesh join hot path.

The speculative join (partitioning/speculative.py + parallel/runner.py
`_sized_expansion`) sizes its expand program's static output capacity with a
runtime protocol: either a blocking match-count sync (cold) or a fused
launch guarded by an on-device overflow flag whose post-hoc [W] read is a
`gather/capacity_sizing` collective plus a `join_overflow_check` per run —
the drift observatory measured warm mesh-8 Q3 carrying two of them on
every execution.  The runtime check exists because the emitted-row count is
data-dependent: each probe row may match any number of build rows.

This pass removes the data dependence with a PROOF instead of a guess (the
decimal-sum licensing pattern: a sound static certificate deletes a
runtime check).  The
key fact is build-side key uniqueness: when every non-NULL value of the
build-side join key provably occurs at most once, every probe row matches
at most one build row, so a worker's emitted total is bounded by its live
probe rows — which is bounded by the probe batch's STATIC trailing
capacity.  The expand program then compiles at that certified fixed
capacity with no sizing gather, no overflow flag, and no speculative retry.

Admissible proof sources (never estimates):

  * connector generator statistics — exact by construction for the builtin
    tpch/tpcds catalogs: `distinct_count == row_count` with zero null
    fraction proves a scanned column unique;
  * plan structure — aggregation group keys are unique by definition;
    `EnforceSingleRow` / `LIMIT 1` bound a subtree to one row; VALUES with
    distinct literals is unique by inspection;
  * uniqueness PRESERVATION — filters/sorts/limits keep row subsets;
    projections rename; a join multiplies a side by at most 1 when the
    OTHER side's key is unique, so uniqueness survives chains of
    key-unique joins (Q3: o_orderkey stays unique through orders x
    customer because c_custkey is unique);
  * exact filter selectivity — `key = literal` on a unique column admits at
    most 1 row; `key IN (k literals)` at most k; integer range predicates
    on a unique column admit at most the range width (a key-RANGE proof:
    each integer value occurs at most once).  Selectivity FRACTIONS (CBO
    estimates) are never admitted.

Artifacts:

  * `CapacityCertificate` — the machine-checkable proof record attached to
    a `JoinNode` (`capacity_cert`) by `license_join_capacities` at the end
    of plan optimization.  It carries the proven per-probe-row fanout
    bound, sound build/probe row bounds, and — after `seal_licenses` — the
    mesh width it was sealed for.  The runner consults `valid_for(W)`
    before compiling the licensed program: a certificate sealed for W is
    INVALID on any other mesh (a mid-query shrink to W-1 re-plans; a stage
    replaying an old subplan against a shrunk mesh must fall back to the
    runtime sizing path).
  * `check_capacity_certificates` — the verifier rule: re-derives every
    attached certificate from admissible sources and rejects any claim
    TIGHTER than provable (`capacity-unsound` PlanViolation).  A sound
    bound may only ever be looser than the best proof, never tighter.
  * `python -m trino_tpu_torch.verify.capacity` — the CI sweep: plans every
    TPC-H + TPC-DS query, licenses, and verifies every certificate;
    unproven joins are reported (they fall back to the runtime sizing
    path — the escape hatch), unsound certificates fail.

`rows_bound` here supersedes `verify.numeric.row_upper_bound` for join
nodes: with a proven build-key uniqueness fact, a join's output is bounded
by its probe side instead of the |L|x|R| structural product — which is what
lets range certificates (verify.numeric) license decimal sums ABOVE joins (Q3's
revenue sum compiles the single-plane i64 kernel).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from trino_tpu_torch.expr.ir import Call, Form, Literal, SpecialForm, SymbolRef
from trino_tpu_torch.verify.plan_checker import PlanViolation

#: catalogs whose table_statistics are EXACT generator parameters (the same
#: admissibility rule as verify.numeric._EXACT_STATS_CATALOGS)
_EXACT_STATS_CATALOGS = ("tpch", "tpcds")

#: integer-kind device types admissible for key-range width proofs
_RANGE_KINDS = ("tinyint", "smallint", "integer", "bigint")


@dataclass
class CapacityCertificate:
    """Proof that a join's per-worker emitted-row total is statically
    bounded, licensing a fixed-capacity expand program with no runtime
    sizing.

    Contract: every probe row matches at most `fanout_bound` build rows
    (NULL keys match nothing), so a worker holding `p` live probe rows
    emits at most `fanout_bound * p` rows (left/full joins emit
    max(matches, 1) <= max(fanout_bound, 1) per row).  With the probe
    batch's static per-worker capacity `cap_p`, the licensed expand
    capacity `licensed_out_cap(cap_p)` can therefore never overflow —
    the overflow flag and its [W] host read are deleted, not skipped.

    `mesh_w` is stamped by `seal_licenses` when the plan is fragmented for
    a concrete mesh; `valid_for(W)` fails on any other width so a stage
    executing against a shrunk/grown mesh falls back to the runtime
    sizing path instead of trusting a certificate sealed elsewhere."""

    #: proven max build matches per probe row (1 = build key unique)
    fanout_bound: int
    #: sound bound on TOTAL build-side rows (None = unproven)
    build_rows_bound: Optional[int] = None
    #: sound bound on TOTAL probe-side rows (None = unproven)
    probe_rows_bound: Optional[int] = None
    #: INNER joins only: proven max probe rows per distinct join-key value
    #: (a generator multiplicity fact, e.g. lineitem holds <= 7 rows per
    #: l_orderkey).  Grouping a worker's probe rows by key value bounds
    #: its emitted total by multiplicity x live build rows:
    #: sum_k probe_w(k) * build_w(k) <= m * sum_k build_w(k) <= m * B.
    #: Outer kinds additionally emit unmatched rows, so the fact is only
    #: derived (and only applied) for kind == inner.
    probe_multiplicity_bound: Optional[int] = None
    #: build-side key symbol names the uniqueness proof covers
    key: tuple = ()
    #: audit trail: where each fact came from (stats:/structure:/filter:)
    provenance: tuple = field(default_factory=tuple)
    #: mesh width the license was sealed for (None = not yet sealed)
    mesh_w: Optional[int] = None

    def licensed_out_cap(self, cap_p: int) -> int:
        """Sound per-worker expand capacity for a probe batch of static
        per-worker capacity `cap_p`."""
        b = int(cap_p)
        if self.probe_rows_bound is not None:
            b = min(b, int(self.probe_rows_bound))
        cap = int(self.fanout_bound) * b
        if (
            self.probe_multiplicity_bound is not None
            and self.build_rows_bound is not None
        ):
            # inner-join alternative bound (see field comment): often far
            # tighter than fanout x cap_p when the build side is filtered
            cap = min(
                cap,
                int(self.probe_multiplicity_bound)
                * int(self.build_rows_bound),
            )
        return max(1, cap)

    def valid_for(self, n_workers: int) -> bool:
        return self.mesh_w is not None and int(self.mesh_w) == int(n_workers)

    def to_json(self) -> dict:
        return {
            "fanout_bound": int(self.fanout_bound),
            "build_rows_bound": (
                None if self.build_rows_bound is None
                else int(self.build_rows_bound)
            ),
            "probe_rows_bound": (
                None if self.probe_rows_bound is None
                else int(self.probe_rows_bound)
            ),
            "probe_multiplicity_bound": (
                None if self.probe_multiplicity_bound is None
                else int(self.probe_multiplicity_bound)
            ),
            "key": list(self.key),
            "provenance": list(self.provenance),
            "mesh_w": self.mesh_w,
        }


@dataclass
class GroupCapacityCertificate:
    """Proof that a grouped aggregation produces at most `group_bound`
    distinct groups, licensing the fused exchange's per-destination slot
    capacity without the [W, W] counts gather.

    Contract: the partial aggregation emits at most one state row per
    group per worker, so any worker sends at most `group_bound` rows to
    any destination — `min(group_bound, cap_states)` is a sound slot
    capacity.  `group_bound` counts NULL group-key combinations (GROUP BY
    treats NULL as a value), so it is `prod(ndv_i + nullable_i)` over the
    group keys, intersected with the source's proven row bound."""

    #: proven max distinct group-key combinations (NULL counted as a value)
    group_bound: int
    #: group-key symbol names the proof covers
    key: tuple = ()
    #: audit trail: where each fact came from (stats:/rows:)
    provenance: tuple = field(default_factory=tuple)
    #: mesh width the license was sealed for (None = not yet sealed)
    mesh_w: Optional[int] = None

    def valid_for(self, n_workers: int) -> bool:
        return self.mesh_w is not None and int(self.mesh_w) == int(n_workers)

    def to_json(self) -> dict:
        return {
            "group_bound": int(self.group_bound),
            "key": list(self.key),
            "provenance": list(self.provenance),
            "mesh_w": self.mesh_w,
        }


# -- plan walking --------------------------------------------------------------


class _Ctx:
    """One analysis context per plan: the uniqueness / row-bound / stats
    derivations are mutually recursive (a join's row bound consults the
    other side's uniqueness, which consults row bounds), so they MUST
    share memo tables — per-call memos made deep TPC-DS join trees
    exponential."""

    def __init__(self, catalogs):
        self.catalogs = catalogs
        self.uniq: dict = {}
        self.rows: dict = {}
        self.stats: dict = {}
        self.mult: dict = {}


def _ctx_for(catalogs, ctx) -> "_Ctx":
    return ctx if isinstance(ctx, _Ctx) else _Ctx(catalogs)



def _walk(node, _seen=None):
    if _seen is None:
        _seen = set()
    if id(node) in _seen:
        return
    _seen.add(id(node))
    yield node
    for c in node.children:
        yield from _walk(c, _seen)


def _table_stats(node, catalogs):
    """(TableStatistics, exact) for a scan, or (None, False)."""
    try:
        if catalogs is None or node.handle.catalog not in _EXACT_STATS_CATALOGS:
            return None, False
        conn = catalogs.get(node.handle.catalog)
        ts = conn.metadata().table_statistics(
            node.handle.schema, node.handle.table
        )
        return ts, True
    except Exception:
        return None, False


# -- column statistics resolution (value-range facts for filter proofs) --------


def stats_env(node, catalogs=None, _ctx=None) -> dict:
    """{symbol name -> ColumnStatistics} resolved through rename/subset
    chains down to exact-catalog scans.  Low/high claims stay sound through
    every admitted node: filters/sorts/limits take row subsets, projections
    rename, joins/unions merge disjoint symbol namespaces, aggregations
    keep group-key VALUES drawn from their input."""
    from trino_tpu_torch.planner import plan as P

    ctx = _ctx_for(catalogs, _ctx)
    _memo = ctx.stats
    hit = _memo.get(id(node))
    if hit is not None:
        return hit
    _memo[id(node)] = {}  # cycle guard
    out: dict = {}
    if isinstance(node, P.TableScanNode):
        ts, exact = _table_stats(node, catalogs)
        if exact and ts is not None:
            for sym, col in node.assignments:
                cs = (ts.columns or {}).get(col)
                if cs is not None:
                    out[sym.name] = cs
    elif isinstance(node, P.ProjectNode):
        src = stats_env(node.source, catalogs, ctx)
        for sym, e in node.assignments:
            if isinstance(e, SymbolRef) and e.name in src:
                out[sym.name] = src[e.name]
    elif isinstance(node, P.AggregationNode):
        src = stats_env(node.source, catalogs, ctx)
        for g in node.group_symbols:
            if g.name in src:
                out[g.name] = src[g.name]
    elif isinstance(
        node,
        (
            P.FilterNode, P.SortNode, P.TopNNode, P.LimitNode, P.SampleNode,
            P.MarkDistinctNode, P.ExchangeNode, P.EnforceSingleRowNode,
            P.OutputNode, P.WindowNode, P.SemiJoinNode, P.JoinNode,
        ),
    ):
        for c in node.children:
            out.update(stats_env(c, catalogs, ctx))
    _memo[id(node)] = out
    return out


# -- uniqueness derivation -----------------------------------------------------


def _covers(unique_sets_of_node, cols: frozenset) -> bool:
    """Is the column set proven unique?  Any proven subset suffices: if
    (a) holds each non-null value at most once, so does (a, b)."""
    return any(u <= cols for u in unique_sets_of_node)


def _dictionary_unique_scan(handle, column: str, t, catalogs, rows) -> bool:
    """A `unique` global dictionary entry whose size equals the table's
    exact row count is a NULL-FREE BIJECTION (code space == row space):
    a STRUCTURAL exact-distinct witness, which is how capacity
    certificates reach varchar dimension keys (the business keys the
    benchmark generators mint densely, e.g. TPC-DS `*_id`)."""
    from trino_tpu_torch import types as T

    if not T.is_string_kind(t):
        return False
    from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE

    ent = DICTIONARY_SERVICE.lookup(handle, column, catalogs)
    return (
        ent is not None
        and ent.unique
        and len(ent.dictionary.values) == int(rows)
    )


def unique_sets(node, catalogs=None, _ctx=None) -> frozenset:
    """Minimal symbol-name sets proven NON-NULL-UNIQUE on the node's
    output: every non-NULL value combination of the set occurs in at most
    one row.  (NULLs are excluded deliberately: an equi-join key never
    matches NULL, so non-null uniqueness is exactly the fanout fact.)
    `frozenset()` as a member means the node provably emits at most one
    row (every column set is then unique)."""
    from trino_tpu_torch.planner import plan as P

    ctx = _ctx_for(catalogs, _ctx)
    _memo = ctx.uniq
    hit = _memo.get(id(node))
    if hit is not None:
        return hit
    _memo[id(node)] = frozenset()  # cycle guard
    out: set = set()
    if isinstance(node, P.TableScanNode):
        ts, exact = _table_stats(node, catalogs)
        rows = ts.row_count if (exact and ts is not None) else None
        if rows is not None and rows <= 1:
            out.add(frozenset())
        elif rows is not None:
            for sym, col in node.assignments:
                cs = (ts.columns or {}).get(col)
                if (
                    cs is not None
                    and cs.distinct_count is not None
                    and int(cs.distinct_count) >= int(rows)
                    and not cs.null_fraction
                    # estimates and probabilistic bounds never prove
                    # uniqueness: a random FK on a 2-row table claims
                    # ndv == rows and can still collide.  Only counts the
                    # connector marks STRUCTURALLY exact (dense surrogate
                    # keys) are admissible fanout witnesses.
                    and getattr(cs, "exact_distinct", False)
                ):
                    out.add(frozenset({sym.name}))
                    continue
                if _dictionary_unique_scan(
                    node.handle, col, sym.type, catalogs, rows
                ):
                    out.add(frozenset({sym.name}))
    elif isinstance(node, P.ValuesNode):
        if len(node.rows) <= 1:
            out.add(frozenset())
        else:
            for i, sym in enumerate(node.outputs):
                vals = [r[i] if i < len(r) else None for r in node.rows]
                try:
                    distinct = (
                        all(v is not None for v in vals)
                        and len(set(vals)) == len(vals)
                    )
                except TypeError:  # unhashable literals: no claim
                    distinct = False
                if distinct:
                    out.add(frozenset({sym.name}))
    elif isinstance(node, P.EnforceSingleRowNode):
        out.add(frozenset())
    elif isinstance(node, (P.LimitNode, P.TopNNode)):
        out |= unique_sets(node.source, catalogs, ctx)
        if node.count is not None and int(node.count) <= 1:
            out.add(frozenset())
    elif isinstance(node, P.AggregationNode):
        out.add(frozenset(g.name for g in node.group_symbols))
    elif isinstance(node, P.WindowNode):
        out |= unique_sets(node.source, catalogs, ctx)
        if not node.partition_by:
            for sym, fn in node.functions:
                if fn.name == "row_number":
                    out.add(frozenset({sym.name}))
    elif isinstance(node, P.ProjectNode):
        src = unique_sets(node.source, catalogs, ctx)
        rename: dict = {}
        for sym, e in node.assignments:
            if isinstance(e, SymbolRef) and e.name not in rename:
                rename[e.name] = sym.name
        for u in src:
            if all(n in rename for n in u):
                out.add(frozenset(rename[n] for n in u))
    elif isinstance(node, P.JoinNode):
        l_u = unique_sets(node.left, catalogs, ctx)
        r_u = unique_sets(node.right, catalogs, ctx)
        # a side's uniqueness survives iff the join multiplies each of its
        # rows by at most one: the OTHER side's key is unique, or the
        # other side provably holds at most one row (covers cross joins).
        # Outer kinds only ADD null-extended rows, which never carry
        # non-null values of the preserved side's columns beyond their one
        # match — non-null uniqueness is unaffected.
        lkeys = frozenset(l.name for l, _ in node.criteria)
        rkeys = frozenset(r.name for _, r in node.criteria)
        r_bound = rows_bound(node.right, catalogs, ctx)
        l_bound = rows_bound(node.left, catalogs, ctx)
        if (node.criteria and _covers(r_u, rkeys)) or (
            r_bound is not None and r_bound <= 1
        ):
            out |= l_u
        if (node.criteria and _covers(l_u, lkeys)) or (
            l_bound is not None and l_bound <= 1
        ):
            out |= r_u
    elif isinstance(node, P.SemiJoinNode):
        out |= unique_sets(node.source, catalogs, ctx)
    elif isinstance(
        node,
        (
            P.FilterNode, P.SortNode, P.SampleNode, P.MarkDistinctNode,
            P.ExchangeNode, P.OutputNode,
        ),
    ):
        for c in node.children:
            out |= unique_sets(c, catalogs, ctx)
    # Union/Unnest/PatternRecognition/RemoteSource/default: no claim
    res = frozenset(out)
    _memo[id(node)] = res
    return res


# -- multiplicity derivation ---------------------------------------------------

#: (catalog, table, column) -> max rows holding any one distinct value of
#: the column — STRUCTURAL facts of the benchmark generators (the same
#: admissibility rule as exact_distinct: these are spec-mandated
#: parameters of the data, never estimates).  TPC-H 3.0 spec: each order
#: generates 1..7 lineitems (clause 4.2.5); each part gets exactly 4
#: partsupp suppliers (clause 4.2.3).
_GENERATOR_MULTIPLICITY = {
    ("tpch", "lineitem", "l_orderkey"): 7,
    ("tpch", "partsupp", "ps_partkey"): 4,
    ("tpch", "partsupp", "ps_suppkey"): 80,  # P/S = 200000/10000 per SF
}


def multiplicity_bound(node, cols: frozenset, catalogs=None, _ctx=None) -> Optional[int]:
    """Sound upper bound on how many output rows of `node` can hold any
    ONE non-NULL distinct value combination of the symbol-name set
    `cols`, or None when no admissible proof exists.  A proven-unique set
    has multiplicity 1; generator facts bound scan columns; row-subset
    nodes can only shrink a value's row count; a superset of a bounded
    column set is at least as selective, so any single-column fact in
    `cols` bounds the whole set."""
    from trino_tpu_torch.planner import plan as P

    ctx = _ctx_for(catalogs, _ctx)
    memo_key = (id(node), cols)
    if memo_key in ctx.mult:
        return ctx.mult[memo_key]
    ctx.mult[memo_key] = None  # cycle guard
    candidates = []
    if _covers(unique_sets(node, catalogs, ctx), cols):
        candidates.append(1)
    rb = rows_bound(node, catalogs, ctx)
    if rb is not None:
        candidates.append(int(rb))
    if isinstance(node, P.TableScanNode):
        _, exact = _table_stats(node, catalogs)
        if exact:
            h = node.handle
            for sym, col in node.assignments:
                if sym.name not in cols:
                    continue
                m = _GENERATOR_MULTIPLICITY.get((h.catalog, h.table, col))
                if m is not None:
                    candidates.append(int(m))
    elif isinstance(node, P.ProjectNode):
        # reverse every col through its rename; a non-rename assignment
        # for a member admits no claim through this path
        back = {
            sym.name: e.name
            for sym, e in node.assignments
            if isinstance(e, SymbolRef)
        }
        if all(n in back for n in cols):
            m = multiplicity_bound(
                node.source, frozenset(back[n] for n in cols), catalogs, ctx
            )
            if m is not None:
                candidates.append(m)
    elif isinstance(node, P.JoinNode):
        # a side's multiplicity survives when the join multiplies each of
        # its rows by at most one (same condition as unique_sets): the
        # other side's key is unique, or it holds at most one row.  Outer
        # null-extensions carry NULL key values, which non-NULL
        # multiplicity excludes by definition.
        lkeys = frozenset(l.name for l, _ in node.criteria)
        rkeys = frozenset(r.name for _, r in node.criteria)
        r_one = (
            bool(node.criteria)
            and _covers(unique_sets(node.right, catalogs, ctx), rkeys)
        ) or (
            (b := rows_bound(node.right, catalogs, ctx)) is not None and b <= 1
        )
        l_one = (
            bool(node.criteria)
            and _covers(unique_sets(node.left, catalogs, ctx), lkeys)
        ) or (
            (b := rows_bound(node.left, catalogs, ctx)) is not None and b <= 1
        )
        if r_one:
            m = multiplicity_bound(node.left, cols, catalogs, ctx)
            if m is not None:
                candidates.append(m)
        if l_one:
            m = multiplicity_bound(node.right, cols, catalogs, ctx)
            if m is not None:
                candidates.append(m)
    elif isinstance(node, P.SemiJoinNode):
        m = multiplicity_bound(node.source, cols, catalogs, ctx)
        if m is not None:
            candidates.append(m)
    elif isinstance(
        node,
        (
            P.FilterNode, P.SortNode, P.TopNNode, P.LimitNode, P.SampleNode,
            P.MarkDistinctNode, P.ExchangeNode, P.EnforceSingleRowNode,
            P.OutputNode, P.WindowNode,
        ),
    ) and len(node.children) == 1:
        # row-subset / row-preserving: no value combination gains rows
        m = multiplicity_bound(node.children[0], cols, catalogs, ctx)
        if m is not None:
            candidates.append(m)
    out = min(candidates) if candidates else None
    ctx.mult[memo_key] = out
    return out


# -- sound row bounds with exact-filter refinement -----------------------------


def conjuncts(expr):
    """Flatten an AND tree into its conjuncts (any non-AND node is one
    conjunct).  Shared with `verify.numeric.refine_env`: both admissible
    proof-source passes must agree on what counts as a conjunct."""
    if isinstance(expr, SpecialForm) and expr.form == Form.AND:
        for a in expr.args:
            yield from conjuncts(a)
    else:
        yield expr


#: operand swap for sym/literal comparisons: `lit OP sym == sym
#: FLIPPED_CMP[OP] lit` — shared with verify.numeric so both passes flip
#: identically
FLIPPED_CMP = {
    "$eq": "$eq", "$lt": "$gt", "$le": "$ge", "$gt": "$lt", "$ge": "$le"
}


def _lit_value(e):
    """The python value of a non-null Literal, else None."""
    if isinstance(e, Literal) and e.value is not None:
        return e.value
    return None


def _int_lit(e):
    v = _lit_value(e)
    if isinstance(v, bool) or not isinstance(v, int):
        return None
    return int(v)


def _range_kind(sym: SymbolRef) -> bool:
    t = getattr(sym, "type", None)
    name = getattr(t, "name", "")
    return name in _RANGE_KINDS or name == "date"


def _conjunct_rows(c, uniq, stats) -> Optional[int]:
    """Sound row bound admitted by ONE filter conjunct, or None.  Only
    exact proofs: equality/IN/range on a proven-unique column (each
    admitted value occurs at most once, so the bound is the count of
    admitted integer values)."""

    def unique_sym(e) -> Optional[SymbolRef]:
        if isinstance(e, SymbolRef) and _covers(uniq, frozenset({e.name})):
            return e
        return None

    if isinstance(c, Call) and c.name == "$eq" and len(c.args) == 2:
        a, b = c.args
        for s, lit in ((a, b), (b, a)):
            if unique_sym(s) is not None and _lit_value(lit) is not None:
                return 1
    if isinstance(c, SpecialForm) and c.form == Form.IN and len(c.args) >= 2:
        s = unique_sym(c.args[0])
        if s is not None and all(
            _lit_value(x) is not None for x in c.args[1:]
        ):
            return len(c.args) - 1
    if (
        isinstance(c, SpecialForm)
        and c.form == Form.BETWEEN
        and len(c.args) == 3
    ):
        s = unique_sym(c.args[0])
        lo, hi = _int_lit(c.args[1]), _int_lit(c.args[2])
        if s is not None and _range_kind(s) and lo is not None and hi is not None:
            return max(0, hi - lo + 1)
    if isinstance(c, Call) and c.name in ("$lt", "$le", "$gt", "$ge") and len(c.args) == 2:
        a, b = c.args
        sym, lit, op = None, None, c.name
        if isinstance(a, SymbolRef) and _int_lit(b) is not None:
            sym, lit = a, _int_lit(b)
        elif isinstance(b, SymbolRef) and _int_lit(a) is not None:
            sym, lit = b, _int_lit(a)
            op = FLIPPED_CMP[op]
        if sym is None or unique_sym(sym) is None or not _range_kind(sym):
            return None
        cs = stats.get(sym.name)
        if cs is None or cs.low is None or cs.high is None:
            return None
        try:
            low, high = int(cs.low), int(cs.high)
        except (TypeError, ValueError):
            return None
        # admitted integer range under the predicate, intersected with the
        # column's exact [low, high]; each value occurs at most once
        if op == "$lt":
            return max(0, min(high, lit - 1) - low + 1)
        if op == "$le":
            return max(0, min(high, lit) - low + 1)
        if op == "$gt":
            return max(0, high - max(low, lit + 1) + 1)
        return max(0, high - max(low, lit) + 1)
    return None


def _predicate_rows(pred, source, catalogs, ctx) -> Optional[int]:
    uniq = unique_sets(source, catalogs, ctx)
    if not uniq:
        return None
    stats = stats_env(source, catalogs, ctx)
    best: Optional[int] = None
    for c in conjuncts(pred):
        b = _conjunct_rows(c, uniq, stats)
        if b is not None:
            best = b if best is None else min(best, b)
    return best


def rows_bound(node, catalogs=None, _ctx=None) -> Optional[int]:
    """A SOUND upper bound on the rows `node` can produce, or None.
    Extends `verify.numeric.row_upper_bound` with the two facts this
    module proves: exact filter selectivity on unique columns, and
    fanout-aware join bounds (a join whose build key is unique emits at
    most its probe side, not the |L|x|R| structural product)."""
    from trino_tpu_torch.planner import plan as P

    ctx = _ctx_for(catalogs, _ctx)
    _memo = ctx.rows
    key = id(node)
    if key in _memo:
        return _memo[key]
    _memo[key] = None  # cycle guard
    out: Optional[int] = None
    if isinstance(node, P.TableScanNode):
        ts, exact = _table_stats(node, catalogs)
        if exact and ts is not None and ts.row_count is not None:
            out = int(ts.row_count)
        if node.pushed_predicate is not None:
            pb = _predicate_rows(node.pushed_predicate, node, catalogs, ctx)
            if pb is not None:
                out = pb if out is None else min(out, pb)
    elif isinstance(node, P.FilterNode):
        out = rows_bound(node.source, catalogs, ctx)
        pb = _predicate_rows(node.predicate, node.source, catalogs, ctx)
        if pb is not None:
            out = pb if out is None else min(out, pb)
    elif isinstance(node, P.ValuesNode):
        out = len(node.rows)
    elif isinstance(node, (P.LimitNode, P.TopNNode)):
        child = rows_bound(node.source, catalogs, ctx)
        n = None if node.count is None else int(node.count)
        if n is not None:
            out = n if child is None else min(n, child)
        else:
            out = child
    elif isinstance(node, P.EnforceSingleRowNode):
        out = 1
    elif isinstance(node, P.JoinNode):
        out = _join_rows_bound(node, catalogs, ctx)
    elif isinstance(node, P.UnionNode):
        kids = [rows_bound(c, catalogs, ctx) for c in node.children]
        if all(k is not None for k in kids):
            out = sum(kids)
    elif isinstance(node, (P.UnnestNode, P.PatternRecognitionNode)):
        out = None  # row-expanding
    elif len(node.children) == 1:
        # structure-preserving / row-subset nodes (filter handled above):
        # project, aggregation, sort, window, sample, output, exchange,
        # mark-distinct — none emits more rows than its input
        out = rows_bound(node.children[0], catalogs, ctx)
    elif isinstance(node, P.SemiJoinNode):
        out = rows_bound(node.source, catalogs, ctx)
    _memo[key] = out
    return out


def _join_rows_bound(node, catalogs, ctx) -> Optional[int]:
    from trino_tpu_torch.planner import plan as P

    assert isinstance(node, P.JoinNode)
    l = rows_bound(node.left, catalogs, ctx)
    r = rows_bound(node.right, catalogs, ctx)
    lkeys = frozenset(x.name for x, _ in node.criteria)
    rkeys = frozenset(x.name for _, x in node.criteria)
    r_unique = bool(node.criteria) and _covers(
        unique_sets(node.right, catalogs, ctx), rkeys
    )
    l_unique = bool(node.criteria) and _covers(
        unique_sets(node.left, catalogs, ctx), lkeys
    )
    candidates = []
    if l is not None and r is not None:
        candidates.append(l * r + l + r)  # structural, outer rows included
    # fanout-aware: with a unique key on one side, each OTHER-side row
    # emits at most max(1, matches) = 1 row.  A join kind that PRESERVES
    # the unique side additionally emits its unmatched rows, so that
    # side's own bound must be KNOWN and added — an unknown (None)
    # preserved side admits no claim (never treat unknown as zero).
    if r_unique and l is not None:
        if node.kind in ("inner", "left"):
            candidates.append(l)  # left joins emit match-or-null per row
        elif r is not None:  # right/full also preserve the right side
            candidates.append(l + r)
    if l_unique and r is not None:
        if node.kind in ("inner", "right"):
            candidates.append(r)
        elif l is not None:  # left/full also preserve the left side
            candidates.append(r + l)
    if not candidates:
        return None
    return min(candidates)


# -- the license ---------------------------------------------------------------


def derive_join_certificate(node, catalogs=None, _ctx=None) -> Optional[CapacityCertificate]:
    """Re-derivable proof for one JoinNode, or None when no admissible
    proof exists.  The licensed fanout is 1 when the build key is proven
    unique, else the build side's proven key multiplicity (a generator
    fact like lineitem's <= 7 rows per l_orderkey) — both exactly the
    cases whose runtime sizing the runner deletes.  Inner joins
    additionally carry the PROBE side's key multiplicity, which bounds
    the emitted total by `multiplicity x build_rows_bound` (see the
    `probe_multiplicity_bound` field contract)."""
    from trino_tpu_torch.planner import plan as P

    if not isinstance(node, P.JoinNode) or not node.criteria:
        return None
    if node.kind not in ("inner", "left", "full"):
        # 'right' flips sides at exchange placement; licensing it here
        # would describe the wrong build side
        return None
    ctx = _ctx_for(catalogs, _ctx)
    rkeys = frozenset(r.name for _, r in node.criteria)
    r_u = unique_sets(node.right, catalogs, ctx)
    prov = []
    if _covers(r_u, rkeys):
        fanout = 1
        witness = min(
            (u for u in r_u if u <= rkeys), key=lambda u: (len(u), sorted(u))
        )
        prov.append(
            "unique:build[%s]" % ",".join(sorted(witness) or ("<single-row>",))
        )
    else:
        fanout = multiplicity_bound(node.right, rkeys, catalogs, ctx)
        if fanout is None:
            return None
        prov.append(f"multiplicity:build<={fanout}/key")
    build_rows = rows_bound(node.right, catalogs, ctx)
    probe_rows = rows_bound(node.left, catalogs, ctx)
    probe_mult = None
    if node.kind == "inner" and build_rows is not None:
        lkeys = frozenset(l.name for l, _ in node.criteria)
        probe_mult = multiplicity_bound(node.left, lkeys, catalogs, ctx)
        if probe_mult is not None:
            prov.append(f"multiplicity:probe<={probe_mult}/key")
    if build_rows is not None:
        prov.append(f"rows:build<={build_rows}")
    if probe_rows is not None:
        prov.append(f"rows:probe<={probe_rows}")
    return CapacityCertificate(
        fanout_bound=fanout,
        build_rows_bound=build_rows,
        probe_rows_bound=probe_rows,
        probe_multiplicity_bound=probe_mult,
        key=tuple(sorted(rkeys)),
        provenance=tuple(prov),
    )


def derive_group_certificate(node, catalogs=None, _ctx=None) -> Optional["GroupCapacityCertificate"]:
    """Re-derivable group-count proof for one grouped AggregationNode, or
    None.  Admissible sources: the product of exact distinct counts over
    the group keys (each key's NULL adds one value — GROUP BY groups
    NULLs), and the source's proven row bound."""
    from trino_tpu_torch.planner import plan as P

    if not isinstance(node, P.AggregationNode) or not node.group_symbols:
        return None
    ctx = _ctx_for(catalogs, _ctx)
    stats = stats_env(node.source, catalogs, ctx)
    prov = []
    candidates = []
    prod = 1
    for g in node.group_symbols:
        cs = stats.get(g.name)
        if (
            cs is None
            or cs.distinct_count is None
            or not getattr(cs, "exact_distinct", False)
        ):
            prod = None
            break
        dc = int(cs.distinct_count) + (1 if cs.null_fraction else 0)
        prod *= max(1, dc)
    if prod is not None:
        candidates.append(prod)
        prov.append(f"stats:distinct<={prod}")
    rb = rows_bound(node.source, catalogs, ctx)
    if rb is not None:
        candidates.append(max(1, int(rb)))
        prov.append(f"rows:source<={rb}")
    if not candidates:
        return None
    return GroupCapacityCertificate(
        group_bound=min(candidates),
        key=tuple(sorted(g.name for g in node.group_symbols)),
        provenance=tuple(prov),
    )


def license_join_capacities(plan, catalogs=None) -> int:
    """The planner-facing licensing pass: attach a `capacity_cert` to every
    join with an admissible fanout proof and to every grouped aggregation
    with an admissible group-count proof.  Runs at the end of
    `optimize()` — before exchange placement and fragmentation, which both
    carry the field through reconstruction.  Proof-only: never changes
    plan shape or results.  Returns the number licensed."""
    from trino_tpu_torch.planner import plan as P

    n = 0
    ctx = _Ctx(catalogs)
    for node in _walk(plan):
        if isinstance(node, P.JoinNode):
            cert = derive_join_certificate(node, catalogs, ctx)
        elif isinstance(node, P.AggregationNode):
            cert = derive_group_certificate(node, catalogs, ctx)
        else:
            continue
        if cert is not None:
            node.capacity_cert = cert
            n += 1
    return n


def seal_licenses(root, n_workers: int) -> int:
    """Stamp every attached certificate with the mesh width the plan was
    fragmented for.  The runner's `valid_for(W)` check then rejects a
    certificate on any OTHER mesh (e.g. a mid-query shrink to W-1 running
    an old subplan) and falls back to the runtime sizing path.  Returns
    the number sealed."""
    n = 0
    for node in _walk(root):
        cert = getattr(node, "capacity_cert", None)
        if cert is not None:
            cert.mesh_w = int(n_workers)
            n += 1
    return n


# -- the verifier rule ---------------------------------------------------------


def check_capacity_certificates(plan, catalogs=None) -> list:
    """Re-derive every attached certificate and reject unsound claims.
    Soundness is one-directional: a certificate may claim LOOSER bounds
    than provable (a weaker true statement), never tighter — a fanout or
    row bound below what admissible sources support licenses an expand
    capacity the data can overflow, which is silent corruption on the
    checked path.  Returns PlanViolations (`capacity-unsound`)."""
    from trino_tpu_torch.planner import plan as P

    violations = []
    ctx = _Ctx(catalogs)

    def bad(node, msg):
        violations.append(PlanViolation("capacity-unsound", node, msg))

    for node in _walk(plan):
        cert = getattr(node, "capacity_cert", None)
        if cert is None:
            continue
        if isinstance(node, P.AggregationNode):
            if not isinstance(cert, GroupCapacityCertificate):
                bad(node, "aggregation carries a non-group certificate")
                continue
            if int(cert.group_bound) < 1:
                bad(node, f"group_bound {cert.group_bound} < 1 is vacuous")
                continue
            gd = derive_group_certificate(node, catalogs, ctx)
            if gd is None:
                bad(
                    node,
                    "no admissible group-count proof exists for group keys "
                    f"{cert.key} — the certificate asserts <= "
                    f"{cert.group_bound} groups without a witness",
                )
            elif int(cert.group_bound) < int(gd.group_bound):
                bad(
                    node,
                    f"group_bound {cert.group_bound} is tighter than the "
                    f"provable bound {gd.group_bound}",
                )
            continue
        if not isinstance(node, P.JoinNode):
            bad(node, "capacity_cert attached to a non-join node")
            continue
        if isinstance(cert, GroupCapacityCertificate):
            bad(node, "join carries a group certificate")
            continue
        if int(cert.fanout_bound) < 1:
            bad(node, f"fanout_bound {cert.fanout_bound} < 1 is vacuous")
            continue
        derived = derive_join_certificate(node, catalogs, ctx)
        if derived is None:
            bad(
                node,
                "no admissible proof exists for this join's build key "
                f"{cert.key} — the certificate asserts fanout <= "
                f"{cert.fanout_bound} without a uniqueness witness",
            )
            continue
        if int(cert.fanout_bound) < int(derived.fanout_bound):
            bad(
                node,
                f"fanout_bound {cert.fanout_bound} is tighter than the "
                f"provable bound {derived.fanout_bound}",
            )
        for name in (
            "build_rows_bound", "probe_rows_bound", "probe_multiplicity_bound",
        ):
            claimed = getattr(cert, name, None)
            provable = getattr(derived, name)
            if claimed is None:
                continue
            if provable is None or int(claimed) < int(provable):
                bad(
                    node,
                    f"{name} {claimed} is tighter than admissible sources "
                    f"prove ({provable})",
                )
    return violations


# -- CLI: sweep every TPC-H + TPC-DS plan --------------------------------------


def verify_benchmarks(verbose: bool = False) -> dict:
    """Plan every TPC-H + TPC-DS query, run the licensing pass (it already
    ran inside optimize(); this re-derives), and verify every attached
    certificate.  Returns {queries, joins, licensed, agg_licensed,
    varchar_licensed, violations}; unsound certificates raise.  The
    planning runs on the CPU; nothing is executed."""
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.verify.collectives import benchmark_suites

    totals = new_totals()
    for catalog, schema, queries in benchmark_suites():
        r = LocalQueryRunner(catalog=catalog, schema=schema, device="cpu")
        for q in sorted(queries):
            sweep_capacity_plan(
                r.create_plan(queries[q]), r.catalogs, totals,
                f"{catalog} {q}", verbose,
            )
    # varchar-key probes: dictionary-backed `unique` business keys
    # (null-free bijections) must license joins the same way dense
    # integer surrogates do — the global dictionary service's capacity
    # reach
    for catalog, schema, q, sql in VARCHAR_PROBES:
        r = LocalQueryRunner(catalog=catalog, schema=schema, device="cpu")
        sweep_capacity_plan(r.create_plan(sql), r.catalogs, totals,
                            f"{catalog} {q}", verbose)
    return totals


#: the sweep's two varchar-keyed self joins over TPC-DS business keys
VARCHAR_PROBES = (
    ("tpcds", "tiny", "varchar:c_customer_id",
     "SELECT count(*) FROM customer c1 JOIN customer c2 "
     "ON c1.c_customer_id = c2.c_customer_id"),
    ("tpcds", "tiny", "varchar:d_date_id",
     "SELECT count(*) FROM date_dim d1 JOIN date_dim d2 "
     "ON d1.d_date_id = d2.d_date_id"),
)


def new_totals() -> dict:
    return {
        "queries": 0, "joins": 0, "licensed": 0, "agg_licensed": 0,
        "varchar_licensed": 0, "violations": 0,
    }


def sweep_capacity_plan(plan, catalogs, totals: dict, where: str = "",
                        verbose: bool = False) -> None:
    """Count one plan's joins, licensed joins and licensed aggregations
    into `totals` and verify its certificates (the first violation
    raises)."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.planner import plan as P

    def _varchar_keyed(n) -> bool:
        return any(
            T.is_string_kind(l.type) or T.is_string_kind(r.type)
            for l, r in n.criteria
        )

    totals["queries"] += 1
    joins = [n for n in _walk(plan) if isinstance(n, P.JoinNode)]
    licensed = [n for n in joins if getattr(n, "capacity_cert", None) is not None]
    totals["joins"] += len(joins)
    totals["licensed"] += len(licensed)
    totals["varchar_licensed"] += sum(1 for n in licensed if _varchar_keyed(n))
    totals["agg_licensed"] += sum(
        1
        for n in _walk(plan)
        if isinstance(n, P.AggregationNode)
        and getattr(n, "capacity_cert", None) is not None
    )
    violations = check_capacity_certificates(plan, catalogs)
    totals["violations"] += len(violations)
    if violations:
        raise violations[0]
    if verbose:
        for n in licensed:
            print(
                f"{where}: licensed join on {n.capacity_cert.key} "
                f"({', '.join(n.capacity_cert.provenance)})"
            )


def summary_line(t: dict) -> str:
    """The totals line the CLI prints (the JAX package's wording)."""
    return (
        f"capacity: {t['queries']} plans, {t['joins']} joins — "
        f"{t['licensed']} LICENSED (runtime sizing deleted), "
        f"{t['joins'] - t['licensed']} runtime-check fallback, "
        f"{t['varchar_licensed']} varchar-keyed licensed "
        "(dictionary-backed uniqueness), "
        f"{t['agg_licensed']} group-count licensed aggregation(s), "
        f"{t['violations']} VIOLATION(s)"
    )


def main() -> int:  # pragma: no cover - CLI entry
    import argparse

    ap = argparse.ArgumentParser(
        description="capacity-certificate sweep over all TPC-H + TPC-DS "
        "plans: license joins with sound cardinality proofs and verify "
        "every attached certificate against re-derivation"
    )
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    t = verify_benchmarks(args.verbose)
    print(summary_line(t))
    if not t["varchar_licensed"]:
        print(
            "capacity: FAIL — no varchar-keyed join licensed; the global "
            "dictionary service's exact_distinct reach is broken"
        )
        return 1
    return 1 if t["violations"] else 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    # `python -m` loads this file as `__main__`, a SECOND copy of the
    # module — its certificate classes would then differ from the ones
    # optimize() attached and every isinstance re-derivation check would
    # miscompare.  Delegate to the canonical import instead.
    from trino_tpu_torch.verify import capacity as _canonical

    sys.exit(_canonical.main())

"""Plan sanity checkers (reference: sql/planner/sanity/PlanSanityChecker.java
— the validator battery Trino runs after analysis and between optimizer
passes: ValidateDependenciesChecker, NoDuplicatePlanNodeIdsChecker,
TypeValidator, ValidateScaledWritersUsage...).

A bad rewrite should fail loudly at plan time, not produce wrong rows at run
time.  Three layers:

  * structural — every node id is unique and no node instance appears twice
    in the tree (a shared subtree silently breaks `with_children` rewrites);
  * dependencies — every symbol a node consumes is produced by a child, with
    a dtype consistent with the producer's declaration;
  * typing — a per-node-type rule table (NODE_TYPING_RULES) checks
    output-symbol dtypes across Filter/Project/Aggregation/Join/Window/
    Union/Exchange nodes, plus distributed invariants on exchange
    boundaries (partition symbols exist; join keys hash-compatibly).

Violations are structured `PlanViolation`s naming the failing node id and
rule; enforcement is controlled by the `verify_plan` session property
(strict | warn | off — default strict under pytest, warn elsewhere).
"""

from __future__ import annotations

import sys
import warnings
from typing import Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import Expr, SymbolRef
from trino_tpu_torch.planner import plan as P


class PlanViolation(Exception):
    """One failed sanity rule, naming the node and the rule."""

    def __init__(self, rule: str, node, message: str):
        self.rule = rule
        self.node_id = getattr(node, "id", 0)
        self.node_type = type(node).__name__
        super().__init__(
            f"[{rule}] {self.node_type}#{self.node_id}: {message}"
        )


MODES = ("strict", "warn", "off")

#: violations surfaced (not raised) by warn-mode enforcement, newest last —
#: kept so benches/tests can inspect what a non-strict run flagged
LAST_WARNINGS: list = []


def resolve_mode(mode: Optional[str] = None) -> str:
    """strict | warn | off; anything else resolves to the ambient default
    (strict when running under pytest, warn otherwise — a bench run should
    report, not die, while tests must fail loudly)."""
    if mode in MODES:
        return mode
    return "strict" if "pytest" in sys.modules else "warn"


def enforce(violations: list, mode: Optional[str] = None) -> None:
    mode = resolve_mode(mode)
    if mode == "off" or not violations:
        return
    if mode == "strict":
        raise violations[0]
    LAST_WARNINGS.extend(violations)
    del LAST_WARNINGS[:-200]  # bounded
    for v in violations:
        warnings.warn(f"plan verifier: {v}", RuntimeWarning, stacklevel=3)


# -- type compatibility -------------------------------------------------------


def _compat(a: T.Type, b: T.Type) -> bool:
    """Declared-vs-produced symbol dtype consistency: exact name match,
    UNKNOWN (NULL literal) wildcard, or string-family equivalence (varchar
    lengths are metadata; the device value is a dictionary code either way)."""
    if a is b or a.name == b.name:
        return True
    if a is T.UNKNOWN or b is T.UNKNOWN:
        return True
    if T.is_string_kind(a) and T.is_string_kind(b):
        return True
    return False


def _coercible(a: T.Type, b: T.Type) -> bool:
    """Union-branch compatibility: the branch type must coerce to the output
    type through the engine's coercion lattice."""
    if _compat(a, b):
        return True
    try:
        T.common_super_type(a, b)
        return True
    except TypeError:
        return False


#: integer-valued device representations that hash identically after the
#: exchange's .astype(int64) canonicalization (exchange._hash_rows)
_HASH_INT_NAMES = (
    "tinyint", "smallint", "integer", "bigint", "boolean",
    "date", "timestamp", "timestamp with time zone", "time",
    "interval day to second", "interval year to month",
)


def _hash_compat(a: T.Type, b: T.Type) -> bool:
    """Two key dtypes may meet at a hash-partitioned boundary only if equal
    logical values produce equal row hashes on both sides."""
    if _compat(a, b):
        return True
    if isinstance(a, T.DecimalType) and isinstance(b, T.DecimalType):
        # scaled-integer representation: same scale -> same device value
        return a.scale == b.scale and a.is_long == b.is_long
    if a.name in _HASH_INT_NAMES and b.name in _HASH_INT_NAMES:
        return True
    return False


# -- expression symbol collection ---------------------------------------------


def collect_symbol_refs(e: Expr, acc: Optional[list] = None, _seen=None) -> list:
    """All SymbolRef leaves of an expression DAG (each shared node once)."""
    if acc is None:
        acc = []
    if _seen is None:
        _seen = set()
    if id(e) in _seen:
        return acc
    _seen.add(id(e))
    if isinstance(e, SymbolRef):
        acc.append(e)
    for c in e.children():
        collect_symbol_refs(c, acc, _seen)
    return acc


# -- the checker --------------------------------------------------------------


class _Ctx:
    """One check run: accumulates violations instead of raising so a single
    pass reports every problem (the caller decides strict vs warn)."""

    def __init__(self):
        self.violations: list[PlanViolation] = []

    def fail(self, rule: str, node, message: str) -> None:
        self.violations.append(PlanViolation(rule, node, message))


def _available(node: P.PlanNode) -> dict:
    """name -> Symbol over all children's outputs (the dependency universe
    of a node's expressions)."""
    out: dict = {}
    for c in node.children:
        for s in c.outputs:
            out.setdefault(s.name, s)
    return out


def _check_refs(ctx: _Ctx, node, exprs, available: dict, what: str = "") -> None:
    """Dependency validator (reference: ValidateDependenciesChecker): every
    symbol an expression consumes must be produced by a child, with a
    consistent declared dtype."""
    for e in exprs:
        if not isinstance(e, Expr):
            continue
        for ref in collect_symbol_refs(e):
            prod = available.get(ref.name)
            if prod is None:
                ctx.fail(
                    "dangling-symbol", node,
                    f"{what}consumes symbol '{ref.name}' produced by no child",
                )
            elif not _compat(ref.type, prod.type):
                ctx.fail(
                    "symbol-type-mismatch", node,
                    f"{what}reads '{ref.name}' as {ref.type.name} but the "
                    f"child produces {prod.type.name}",
                )


def _check_symbols(ctx: _Ctx, node, symbols, available: dict, what: str) -> None:
    """Same dependency check for Symbol lists (group keys, orderings...)."""
    for s in symbols:
        prod = available.get(s.name)
        if prod is None:
            ctx.fail(
                "dangling-symbol", node,
                f"{what} symbol '{s.name}' produced by no child",
            )
        elif not _compat(s.type, prod.type):
            ctx.fail(
                "symbol-type-mismatch", node,
                f"{what} symbol '{s.name}' declared {s.type.name} but the "
                f"child produces {prod.type.name}",
            )


# -- per-node-type typing rules (the TypeValidator rule table) ----------------


def _t_TableScanNode(ctx: _Ctx, node: P.TableScanNode) -> None:
    own = {s.name: s for s, _ in node.assignments}
    if node.pushed_predicate is not None:
        _check_refs(
            ctx, node, [node.pushed_predicate], own, "pushed predicate "
        )
        if not _compat(node.pushed_predicate.type, T.BOOLEAN):
            ctx.fail(
                "predicate-not-boolean", node,
                f"pushed predicate has type {node.pushed_predicate.type.name}",
            )
    cols = {
        c.name: c.type for c in getattr(node.table_meta, "columns", ()) or ()
    }
    for s, cname in node.assignments:
        ct = cols.get(cname)
        if ct is not None and not _compat(s.type, ct):
            ctx.fail(
                "scan-column-type-mismatch", node,
                f"symbol '{s.name}' declared {s.type.name} but table column "
                f"'{cname}' is {ct.name}",
            )


def _t_FilterNode(ctx: _Ctx, node: P.FilterNode, avail: dict) -> None:
    _check_refs(ctx, node, [node.predicate], avail, "predicate ")
    if not _compat(node.predicate.type, T.BOOLEAN):
        ctx.fail(
            "predicate-not-boolean", node,
            f"filter predicate has type {node.predicate.type.name}",
        )


def _t_ProjectNode(ctx: _Ctx, node: P.ProjectNode, avail: dict) -> None:
    _check_refs(ctx, node, [e for _, e in node.assignments], avail)
    for s, e in node.assignments:
        if not _compat(s.type, e.type):
            ctx.fail(
                "project-type-mismatch", node,
                f"assignment '{s.name}' declared {s.type.name} but the "
                f"expression produces {e.type.name}",
            )


#: aggregate output dtypes the checker pins down (only rules that hold for
#: every input type land here; value-dependent ones stay unchecked)
_AGG_BIGINT_OUT = ("count", "count_star", "approx_distinct")
_AGG_ARG_TYPED_OUT = ("min", "max", "any_value", "arbitrary")
_AGG_BOOLEAN_OUT = ("bool_and", "bool_or", "every")


def _t_AggregationNode(ctx: _Ctx, node: P.AggregationNode, avail: dict) -> None:
    if node.step not in ("single", "partial", "final"):
        ctx.fail("bad-agg-step", node, f"unknown step '{node.step}'")
    _check_symbols(ctx, node, node.group_symbols, avail, "group")
    for out_sym, agg in node.aggregations:
        _check_refs(
            ctx, node, list(agg.args), avail, f"aggregate '{out_sym.name}' "
        )
        if agg.filter is not None:
            _check_refs(
                ctx, node, [agg.filter], avail,
                f"aggregate '{out_sym.name}' FILTER ",
            )
            if not _compat(agg.filter.type, T.BOOLEAN):
                ctx.fail(
                    "predicate-not-boolean", node,
                    f"aggregate '{out_sym.name}' FILTER has type "
                    f"{agg.filter.type.name}",
                )
        if agg.function in _AGG_BIGINT_OUT and not _compat(
            out_sym.type, T.BIGINT
        ):
            ctx.fail(
                "agg-type-mismatch", node,
                f"{agg.function} output '{out_sym.name}' declared "
                f"{out_sym.type.name}, expected bigint",
            )
        if agg.function in _AGG_BOOLEAN_OUT and not _compat(
            out_sym.type, T.BOOLEAN
        ):
            ctx.fail(
                "agg-type-mismatch", node,
                f"{agg.function} output '{out_sym.name}' declared "
                f"{out_sym.type.name}, expected boolean",
            )
        if (
            agg.function in _AGG_ARG_TYPED_OUT
            and agg.args
            and not _compat(out_sym.type, agg.args[0].type)
        ):
            ctx.fail(
                "agg-type-mismatch", node,
                f"{agg.function} output '{out_sym.name}' declared "
                f"{out_sym.type.name} but the argument is "
                f"{agg.args[0].type.name}",
            )


_JOIN_KINDS = ("inner", "left", "right", "full", "cross")


def _t_JoinNode(ctx: _Ctx, node: P.JoinNode, avail: dict) -> None:
    if node.kind not in _JOIN_KINDS:
        ctx.fail("bad-join-kind", node, f"unknown join kind '{node.kind}'")
    left = {s.name: s for s in node.left.outputs}
    right = {s.name: s for s in node.right.outputs}
    for l, r in node.criteria:
        _check_symbols(ctx, node, [l], left, "left join-key")
        _check_symbols(ctx, node, [r], right, "right join-key")
        if not _hash_compat(l.type, r.type):
            ctx.fail(
                "join-key-type-mismatch", node,
                f"criteria {l.name} = {r.name} compares {l.type.name} with "
                f"{r.type.name}, which do not hash compatibly",
            )
    if node.filter is not None:
        _check_refs(ctx, node, [node.filter], avail, "join filter ")
        if not _compat(node.filter.type, T.BOOLEAN):
            ctx.fail(
                "predicate-not-boolean", node,
                f"join filter has type {node.filter.type.name}",
            )


def _t_SemiJoinNode(ctx: _Ctx, node: P.SemiJoinNode, avail: dict) -> None:
    src = {s.name: s for s in node.source.outputs}
    filt = {s.name: s for s in node.filtering.outputs}
    _check_symbols(ctx, node, [node.source_key], src, "semi-join source")
    _check_symbols(ctx, node, [node.filtering_key], filt, "semi-join filtering")
    if not _hash_compat(node.source_key.type, node.filtering_key.type):
        ctx.fail(
            "join-key-type-mismatch", node,
            f"{node.source_key.name} in {node.filtering_key.name} compares "
            f"{node.source_key.type.name} with "
            f"{node.filtering_key.type.name}",
        )
    if not _compat(node.mark.type, T.BOOLEAN):
        ctx.fail(
            "mark-not-boolean", node,
            f"semi-join mark '{node.mark.name}' is {node.mark.type.name}",
        )
    if node.filter is not None:
        _check_refs(ctx, node, [node.filter], avail, "semi-join filter ")


#: window functions with an input-independent output dtype
_WINDOW_BIGINT_OUT = ("rank", "dense_rank", "row_number", "ntile", "count",
                      "count_star")
_WINDOW_DOUBLE_OUT = ("percent_rank", "cume_dist")
_WINDOW_ARG_TYPED_OUT = ("lag", "lead", "first_value", "last_value")


def _t_WindowNode(ctx: _Ctx, node: P.WindowNode, avail: dict) -> None:
    _check_symbols(ctx, node, node.partition_by, avail, "partition")
    _check_symbols(ctx, node, [s for s, _, _ in node.order_by], avail, "order")
    for out_sym, fn in node.functions:
        _check_refs(
            ctx, node, list(fn.args), avail, f"window '{out_sym.name}' "
        )
        if fn.name in _WINDOW_BIGINT_OUT and not _compat(
            out_sym.type, T.BIGINT
        ):
            ctx.fail(
                "window-type-mismatch", node,
                f"{fn.name} output '{out_sym.name}' declared "
                f"{out_sym.type.name}, expected bigint",
            )
        if fn.name in _WINDOW_DOUBLE_OUT and not _compat(
            out_sym.type, T.DOUBLE
        ):
            ctx.fail(
                "window-type-mismatch", node,
                f"{fn.name} output '{out_sym.name}' declared "
                f"{out_sym.type.name}, expected double",
            )
        if (
            fn.name in _WINDOW_ARG_TYPED_OUT
            and fn.args
            and not _compat(out_sym.type, fn.args[0].type)
        ):
            ctx.fail(
                "window-type-mismatch", node,
                f"{fn.name} output '{out_sym.name}' declared "
                f"{out_sym.type.name} but the argument is "
                f"{fn.args[0].type.name}",
            )


def _t_SortNode(ctx: _Ctx, node, avail: dict) -> None:
    _check_symbols(
        ctx, node, [s for s, _, _ in node.orderings], avail, "ordering"
    )


def _t_TopNNode(ctx: _Ctx, node: P.TopNNode, avail: dict) -> None:
    _t_SortNode(ctx, node, avail)
    if not isinstance(node.count, int) or node.count < 0:
        ctx.fail("bad-limit", node, f"TopN count {node.count!r}")


def _t_LimitNode(ctx: _Ctx, node: P.LimitNode, avail: dict) -> None:
    if node.count is not None and (
        not isinstance(node.count, int) or node.count < 0
    ):
        ctx.fail("bad-limit", node, f"limit count {node.count!r}")
    if not isinstance(node.offset, int) or node.offset < 0:
        ctx.fail("bad-limit", node, f"limit offset {node.offset!r}")


def _t_ValuesNode(ctx: _Ctx, node: P.ValuesNode, avail: dict) -> None:
    for i, row in enumerate(node.rows):
        if len(row) != len(node.symbols):
            ctx.fail(
                "values-arity", node,
                f"row {i} has {len(row)} values for {len(node.symbols)} "
                "symbols",
            )


def _t_UnionNode(ctx: _Ctx, node: P.UnionNode, avail: dict) -> None:
    if not node.source_symbols:
        return
    if len(node.source_symbols) != len(node.sources):
        ctx.fail(
            "union-arity", node,
            f"{len(node.source_symbols)} symbol mappings for "
            f"{len(node.sources)} sources",
        )
        return
    for i, (src, mapping) in enumerate(zip(node.sources, node.source_symbols)):
        if len(mapping) != len(node.symbols):
            ctx.fail(
                "union-arity", node,
                f"source {i} maps {len(mapping)} symbols for "
                f"{len(node.symbols)} outputs",
            )
            continue
        produced = {s.name: s for s in src.outputs}
        for out, branch in zip(node.symbols, mapping):
            _check_symbols(ctx, node, [branch], produced, f"source {i}")
            if not _coercible(branch.type, out.type):
                ctx.fail(
                    "union-type-mismatch", node,
                    f"source {i} column '{branch.name}' "
                    f"({branch.type.name}) does not coerce to output "
                    f"'{out.name}' ({out.type.name})",
                )


def _t_MarkDistinctNode(ctx: _Ctx, node: P.MarkDistinctNode, avail: dict) -> None:
    _check_symbols(ctx, node, node.key_symbols, avail, "distinct-key")
    if not _compat(node.mark.type, T.BOOLEAN):
        ctx.fail(
            "mark-not-boolean", node,
            f"mark '{node.mark.name}' is {node.mark.type.name}",
        )


def _t_UnnestNode(ctx: _Ctx, node: P.UnnestNode, avail: dict) -> None:
    _check_refs(ctx, node, [e for _, e in node.unnest], avail, "unnest ")


def _t_SampleNode(ctx: _Ctx, node: P.SampleNode, avail: dict) -> None:
    if not (0.0 <= float(node.ratio) <= 1.0):
        ctx.fail("bad-sample-ratio", node, f"ratio {node.ratio!r}")


def _t_OutputNode(ctx: _Ctx, node: P.OutputNode, avail: dict) -> None:
    _check_symbols(ctx, node, node.symbols, avail, "output")
    if len(node.column_names) != len(node.symbols):
        ctx.fail(
            "output-arity", node,
            f"{len(node.column_names)} names for {len(node.symbols)} symbols",
        )


_EXCHANGE_KINDS = ("repartition", "broadcast", "gather", "merge")


def _t_ExchangeNode(ctx: _Ctx, node: P.ExchangeNode, avail: dict) -> None:
    """Distributed invariants on a fragment boundary: the partitioning
    symbols must exist on the producing side with hashable declared dtypes
    (the consumer-side key compatibility is checked at the Join/Aggregation
    that required the repartition)."""
    if node.kind not in _EXCHANGE_KINDS:
        ctx.fail("bad-exchange-kind", node, f"unknown kind '{node.kind}'")
    _check_symbols(ctx, node, node.partition_symbols, avail, "partition")
    for s in node.partition_symbols:
        if isinstance(s.type, (T.ArrayType, T.MapType, T.RowType)):
            # packed composite layouts are not canonical per value (slot
            # order / tail padding): equal values can row-hash differently,
            # scattering one key group across workers
            ctx.fail(
                "exchange-key-not-hashable", node,
                f"partition symbol '{s.name}' has composite type "
                f"{s.type.name}, whose device layout does not hash "
                "canonically",
            )
    _check_symbols(
        ctx, node, [s for s, _, _ in node.orderings], avail, "merge-ordering"
    )


def _t_PatternRecognitionNode(ctx, node: P.PatternRecognitionNode, avail) -> None:
    _check_symbols(ctx, node, node.partition_by, avail, "partition")
    _check_symbols(ctx, node, [s for s, _, _ in node.order_by], avail, "order")
    for _, spec in node.measures:
        if spec.source is not None:
            _check_symbols(ctx, node, [spec.source], avail, "measure")


#: node type -> typing rule (reference: sanity/TypeValidator's visitor).
#: Nodes absent from the table get only the structural + generic checks.
NODE_TYPING_RULES = {
    P.FilterNode: _t_FilterNode,
    P.ProjectNode: _t_ProjectNode,
    P.AggregationNode: _t_AggregationNode,
    P.JoinNode: _t_JoinNode,
    P.SemiJoinNode: _t_SemiJoinNode,
    P.WindowNode: _t_WindowNode,
    P.SortNode: _t_SortNode,
    P.TopNNode: _t_TopNNode,
    P.LimitNode: _t_LimitNode,
    P.ValuesNode: _t_ValuesNode,
    P.UnionNode: _t_UnionNode,
    P.MarkDistinctNode: _t_MarkDistinctNode,
    P.UnnestNode: _t_UnnestNode,
    P.SampleNode: _t_SampleNode,
    P.OutputNode: _t_OutputNode,
    P.ExchangeNode: _t_ExchangeNode,
    P.PatternRecognitionNode: _t_PatternRecognitionNode,
}


def check_plan(root: P.PlanNode) -> list:
    """Run every sanity checker over a plan tree; returns violations
    (empty = clean).  Raising is the caller's decision via `enforce`."""
    ctx = _Ctx()
    seen_instances: set = set()
    seen_ids: dict = {}
    for node in P.walk(root):
        if id(node) in seen_instances:
            ctx.fail(
                "duplicate-node", node,
                "the same node instance appears twice in the tree "
                "(shared subtree breaks rewrites)",
            )
            continue
        seen_instances.add(id(node))
        nid = getattr(node, "id", 0)
        other = seen_ids.get(nid)
        if other is not None:
            ctx.fail(
                "duplicate-node-id", node,
                f"node id {nid} already used by {other}",
            )
        else:
            seen_ids[nid] = type(node).__name__
        if isinstance(node, P.TableScanNode):
            _t_TableScanNode(ctx, node)
            continue
        avail = _available(node)
        rule = NODE_TYPING_RULES.get(type(node))
        if rule is not None:
            rule(ctx, node, avail)
    return ctx.violations


def check_subplan(sub) -> list:
    """Fragment-level invariants after PlanFragmenter (reference:
    sanity-checking createSubPlans output): unique fragment ids, every
    RemoteSourceNode names an existing child fragment, and the declared
    remote symbols match the child fragment root's outputs name-for-name
    with consistent dtypes."""
    from trino_tpu_torch.planner.fragmenter import RemoteSourceNode, SubPlan

    ctx = _Ctx()
    frags: dict = {}

    def register(s: SubPlan):
        if s.fragment.id in frags:
            ctx.fail(
                "duplicate-fragment-id", s.fragment.root,
                f"fragment id {s.fragment.id} appears twice",
            )
        else:
            frags[s.fragment.id] = s.fragment
        for c in s.children:
            register(c)

    register(sub)
    for fragment in frags.values():
        ctx.violations.extend(check_plan(fragment.root))
        for node in P.walk(fragment.root):
            if not isinstance(node, RemoteSourceNode):
                continue
            child = frags.get(node.fragment_id)
            if child is None:
                ctx.fail(
                    "dangling-remote-source", node,
                    f"references unknown fragment {node.fragment_id}",
                )
                continue
            child_out = child.root.outputs
            if [s.name for s in node.symbols] != [s.name for s in child_out]:
                ctx.fail(
                    "remote-symbol-mismatch", node,
                    f"declares {[s.name for s in node.symbols]} but fragment "
                    f"{node.fragment_id} outputs "
                    f"{[s.name for s in child_out]}",
                )
            else:
                for mine, theirs in zip(node.symbols, child_out):
                    if not _compat(mine.type, theirs.type):
                        ctx.fail(
                            "remote-symbol-mismatch", node,
                            f"'{mine.name}' declared {mine.type.name} but "
                            f"fragment {node.fragment_id} produces "
                            f"{theirs.type.name}",
                        )
            declared = {s.name for s in node.symbols}
            for s in node.partition_symbols:
                if s.name not in declared:
                    ctx.fail(
                        "exchange-key-missing", node,
                        f"partition symbol '{s.name}' not in the remote "
                        "source's outputs",
                    )
    return ctx.violations

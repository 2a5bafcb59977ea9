"""Local execution planner: logical PlanNode tree -> operator pipelines.

Port of trino_tpu/runtime/local_planner.py (reference role:
sql/planner/LocalExecutionPlanner.java:516,600).  Each plan node becomes a
(batch-stream, symbol-layout) pair; symbol references inside expressions
are rewritten to positional InputRef channels.  Every operator runs on the
planner's device.

Ported nodes: TableScan (with the dynamic filters join builds register),
Values, Filter, Project, Aggregation (with the filter/projection fused into
the aggregation's per-batch step, FILTER clauses folded into the
aggregate inputs, DISTINCT aggregates through a dedupe pre-aggregation),
MarkDistinct, Join (inner, left, right as a flipped left, full, and cross
as a nested loop), SemiJoin (IN and EXISTS marks, with a residual over
source ++ filtering symbols), Union (INTERSECT, EXCEPT and ROLLUP plan
through it), EnforceSingleRow, Exchange (a pass-through; a merge
re-sorts), Sort, TopN, Limit and Output.  Any other
node raises NotImplementedError naming it (window and unnest among them).
Memory budgets and their partition-wave machinery are not ported yet.
"""

from __future__ import annotations

from typing import Iterable

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.expr import ExprCompiler
from trino_tpu_torch.expr.ir import (
    Expr,
    Form,
    InputRef,
    Literal,
    SpecialForm,
    SymbolRef,
    visit,
)
from trino_tpu_torch.ops.aggregation import (
    AggregationOperator,
    AggSpec,
    MarkDistinctOperator,
)
from trino_tpu_torch.ops.common import SortKey, next_pow2
from trino_tpu_torch.ops.filter_project import FilterProjectOperator
from trino_tpu_torch.ops.join import (
    HashJoinOperator,
    NestedLoopJoinOperator,
    SemiJoinOperator,
)
from trino_tpu_torch.ops.scan import ScanOperator
from trino_tpu_torch.ops.sort import LimitOperator, OrderByOperator, TopNOperator
from trino_tpu_torch.ops.values import ValuesOperator
from trino_tpu_torch.planner import plan as P


class PhysicalPlan:
    """A batch stream plus the symbol layout of its channels."""

    def __init__(self, stream: Iterable[Batch], symbols: list):
        self.stream = stream
        self.symbols = list(symbols)

    def channel(self, name: str) -> int:
        for i, s in enumerate(self.symbols):
            if s.name == name:
                return i
        raise KeyError(f"symbol {name} not in layout {[s.name for s in self.symbols]}")

    def rewrite(self, expr: Expr) -> Expr:
        """SymbolRef -> InputRef against this layout."""

        def fn(e: Expr) -> Expr:
            if isinstance(e, SymbolRef):
                return InputRef(self.channel(e.name), e.type)
            return e

        return visit(expr, fn)

    def identity_projections(self) -> list:
        return [InputRef(i, s.type) for i, s in enumerate(self.symbols)]

    def types(self) -> list:
        return [s.type for s in self.symbols]


def session_budget(properties) -> int:
    """Per-query session budget in bytes: the smallest nonzero of
    ``query_max_memory`` and the legacy ``query_max_memory_bytes``."""
    vals = [
        int(properties.get(knob))
        for knob in ("query_max_memory", "query_max_memory_bytes")
    ]
    vals = [v for v in vals if v > 0]
    return min(vals) if vals else 0


class LocalExecutionPlanner:
    def __init__(
        self,
        catalogs: CatalogManager,
        device: torch.device,
        target_splits: int = 4,
        properties=None,
    ):
        from trino_tpu_torch.runtime.session import SessionProperties

        self.catalogs = catalogs
        self.device = device
        self.target_splits = target_splits
        self.properties = properties or SessionProperties()
        #: build-side key ranges registered by inner-join builds, keyed by
        #: the probe symbol they prune (DynamicFilterService role)
        self.dynamic_filters: dict = {}
        if session_budget(self.properties):
            raise NotImplementedError(
                "query memory budgets (partition waves and spill): not ported yet"
            )

    def plan(self, node: P.PlanNode) -> PhysicalPlan:
        method = getattr(self, "_visit_" + type(node).__name__, None)
        if method is None:
            raise NotImplementedError(
                f"plan node {type(node).__name__}: not ported yet"
            )
        return method(node)

    # -- leaves ---------------------------------------------------------------

    def _visit_TableScanNode(self, node: P.TableScanNode) -> PhysicalPlan:
        from trino_tpu_torch.connectors.api import scan_predicate_triples

        connector = self.catalogs.get(node.handle.catalog)
        names = [c for _, c in node.assignments]
        types = [s.type for s, _ in node.assignments]
        splits = list(
            connector.splits(
                node.handle,
                target_splits=self.target_splits,
                predicate=scan_predicate_triples(node),
            )
        )
        page_rows = self.properties.get("page_rows")
        use_cache = self.properties.get("scan_cache")
        prefetch_depth = self.properties.get("scan_prefetch_depth")
        concurrency = self.properties.get("task_concurrency")

        def split_feed(split):
            def make():
                op = ScanOperator(
                    connector, split, names, types, self.device,
                    page_rows=page_rows, use_cache=use_cache,
                )
                return op.batches()

            return make

        if concurrency > 1 and len(splits) > 1:
            # intra-task parallelism: split readers (host decode + copy to
            # the device) drain through a local exchange
            from trino_tpu_torch.runtime.local_exchange import parallel_feed

            feed = parallel_feed(
                [split_feed(s) for s in splits], workers=concurrency
            )
        else:

            def stream():
                for split in splits:
                    yield from split_feed(split)()

            feed = stream()
            if prefetch_depth > 0:
                from trino_tpu_torch.runtime.prefetch import prefetch_iter

                feed = prefetch_iter(feed, depth=prefetch_depth)
        plan = PhysicalPlan(feed, [s for s, _ in node.assignments])
        pred_expr = node.pushed_predicate
        # dynamic filters registered by upstream join builds (ranges over
        # this scan's output symbols) fuse into the scan's filter step
        dyn = []
        for s, _ in node.assignments:
            rng = self.dynamic_filters.get(s.name)
            if rng is not None:
                dyn.append(_range_expr(s, *rng))
        if dyn:
            from trino_tpu_torch.expr.ir import and_

            pred_expr = and_(*(([pred_expr] if pred_expr is not None else []) + dyn))
        if pred_expr is not None:
            fp = FilterProjectOperator(
                plan.rewrite(pred_expr), plan.identity_projections()
            )
            plan = PhysicalPlan(fp.process(plan.stream), plan.symbols)
        if dyn:
            # dynamic filters are usually very selective; compact so the
            # smaller live set shrinks every downstream shape
            plan = PhysicalPlan(_compact_stream(plan.stream), plan.symbols)
        return plan

    def _visit_ValuesNode(self, node: P.ValuesNode) -> PhysicalPlan:
        op = ValuesOperator([s.type for s in node.symbols], node.rows, self.device)
        return PhysicalPlan(op.batches(), node.symbols)

    # -- row transforms -------------------------------------------------------

    def _visit_FilterNode(self, node: P.FilterNode) -> PhysicalPlan:
        src = self.plan(node.source)
        op = FilterProjectOperator(
            src.rewrite(node.predicate), src.identity_projections()
        )
        return PhysicalPlan(op.process(src.stream), src.symbols)

    def _visit_ProjectNode(self, node: P.ProjectNode) -> PhysicalPlan:
        src = self.plan(node.source)
        if node.is_identity():
            return PhysicalPlan(src.stream, [s for s, _ in node.assignments])
        exprs = [src.rewrite(e) for _, e in node.assignments]
        op = FilterProjectOperator(None, exprs)
        return PhysicalPlan(op.process(src.stream), [s for s, _ in node.assignments])

    # -- aggregation ----------------------------------------------------------

    def _collapse_agg_source(self, node: P.AggregationNode):
        """Fold a Project*/Filter? chain over a scan under an aggregation
        into the aggregation's own input projection, so filter + compute +
        partial reduce run as one per-batch step with no intermediate
        column materialization between operators.  Returns (source
        PhysicalPlan proxy, predicate Expr or None), or None when the shape
        doesn't match."""
        from trino_tpu_torch.expr.ir import substitute_symbols

        maps = []
        inner = node.source
        while isinstance(inner, P.ProjectNode):
            maps.append({s.name: e for s, e in inner.assignments})
            inner = inner.source
        pred = None
        if isinstance(inner, P.FilterNode):
            pred = inner.predicate
            inner = inner.source
        if not maps and pred is None:
            return None
        if not isinstance(inner, P.TableScanNode):
            return None
        base = self.plan(inner)

        class _Sub:
            stream = base.stream
            symbols = base.symbols

            @staticmethod
            def rewrite(e):
                for m in maps:
                    e = substitute_symbols(e, m)
                return base.rewrite(e)

            @staticmethod
            def channel(name):
                return base.channel(name)

        pred_ir = base.rewrite(pred) if pred is not None else None
        return _Sub, pred_ir

    def _visit_AggregationNode(self, node: P.AggregationNode) -> PhysicalPlan:
        distinct = any(agg.distinct for _, agg in node.aggregations)
        # the dedupe pre-aggregation reads the source's own layout, so the
        # source chain is not folded into the aggregation under DISTINCT
        collapsed = None if distinct else self._collapse_agg_source(node)
        if collapsed is not None:
            src, fused_pred = collapsed
        else:
            src = self.plan(node.source)
            fused_pred = None
        if distinct:
            src = self._distinct_preagg(node, src)
        ngroups = len(node.group_symbols)
        proj, specs, input_types = build_agg_inputs(node, src)
        pre = FilterProjectOperator(fused_pred, proj)
        # group keys must be identity InputRefs for the fused step, so the
        # key dictionaries survive the projection
        fuse = all(isinstance(proj[i], InputRef) for i in range(ngroups))
        op = AggregationOperator(
            list(range(ngroups)),
            specs,
            input_types,
            self.device,
            mode=node.step,
            fold_every=self.properties.get("agg_fold_batches"),
            use_pallas=self.properties.get("pallas_agg"),
            pre_step=pre.fusable_step() if fuse else None,
        )
        feed = src.stream if fuse else pre.process(src.stream)
        return PhysicalPlan(op.process(feed), node.outputs)

    def _distinct_preagg(self, node: P.AggregationNode, src: PhysicalPlan) -> PhysicalPlan:
        """DISTINCT aggregates through a dedupe pre-aggregation: group by
        the group keys and the distinct arguments, then aggregate the
        deduplicated rows (reference role: the pre-aggregation rewrites of
        the optimizer).  Every distinct aggregate must share one argument
        list, with no plain aggregates beside them: the optimizer rewrites
        the other shapes to MarkDistinct plus FILTERed aggregates."""
        if not supports_uniform_distinct(node):
            raise NotImplementedError("mixed DISTINCT aggregate shapes")
        proj, symbols = build_distinct_dedupe(node, src)
        dedupe = AggregationOperator(
            list(range(len(proj))), [], [e.type for e in proj], self.device,
            mode="single",
        )
        pre = FilterProjectOperator(None, proj)
        return PhysicalPlan(dedupe.process(pre.process(src.stream)), symbols)

    def _visit_MarkDistinctNode(self, node: P.MarkDistinctNode) -> PhysicalPlan:
        src = self.plan(node.source)
        op = MarkDistinctOperator([src.channel(s.name) for s in node.key_symbols])
        return PhysicalPlan(op.process(src.stream), node.outputs)

    # -- joins ----------------------------------------------------------------

    def _visit_JoinNode(self, node: P.JoinNode) -> PhysicalPlan:
        if node.kind == "cross":
            left = self.plan(node.left)
            right = self.plan(node.right)
            op = NestedLoopJoinOperator(right.types())
            op.set_build(list(right.stream), self.device)
            return PhysicalPlan(op.process(left.stream), left.symbols + right.symbols)
        if node.kind == "right":
            flipped = P.JoinNode(
                "left", node.right, node.left,
                [(r, l) for l, r in node.criteria], node.filter, node.distribution,
            )
            out = self._visit_JoinNode(flipped)
            # restore left ++ right symbol order
            order = [out.channel(s.name) for s in node.outputs]
            proj = FilterProjectOperator(
                None, [InputRef(c, out.symbols[c].type) for c in order]
            )
            return PhysicalPlan(proj.process(out.stream), node.outputs)

        build = self.plan(node.right)
        build_batches = list(build.stream)
        if node.kind == "inner":
            # dynamic filtering: build-side key ranges prune the probe scan
            # (registered before the probe subtree is planned)
            for lsym, rsym in node.criteria:
                rng = _host_minmax(build_batches, build.channel(rsym.name))
                if rng is not None:
                    self.dynamic_filters[lsym.name] = rng
        probe = self.plan(node.left)
        # the probe feed starts decoding now, overlapping the build side's
        # indexing; planned AFTER the build drain so dynamic filters apply
        from trino_tpu_torch.runtime.prefetch import eager_prefetch

        probe = PhysicalPlan(eager_prefetch(probe.stream, depth=2), probe.symbols)
        out_symbols = probe.symbols + build.symbols
        probe_keys = [probe.channel(l.name) for l, _ in node.criteria]
        build_keys = [build.channel(r.name) for _, r in node.criteria]
        residual = None
        if node.filter is not None:
            res_expr = PhysicalPlan(iter(()), out_symbols).rewrite(node.filter)

            def residual(batch: Batch, _e=res_expr):
                return ExprCompiler(batch).filter_mask(_e)

        op = HashJoinOperator(
            node.kind,
            probe_keys,
            build_keys,
            build.types(),
            probe_types=probe.types(),
            residual=residual,
        )
        op.set_build(build_batches, self.device)
        return PhysicalPlan(op.process(probe.stream), out_symbols)

    def _visit_SemiJoinNode(self, node: P.SemiJoinNode) -> PhysicalPlan:
        src = self.plan(node.source)
        filt = self.plan(node.filtering)
        residual = None
        if node.filter is not None:
            # correlated EXISTS conjuncts over source ++ filtering symbols
            combined = PhysicalPlan(iter(()), src.symbols + filt.symbols)
            res_expr = combined.rewrite(node.filter)

            def residual(batch: Batch, _e=res_expr):
                return ExprCompiler(batch).filter_mask(_e)

        op = SemiJoinOperator(
            src.channel(node.source_key.name),
            filt.channel(node.filtering_key.name),
            filt.types(),
            null_aware=node.null_aware,
            residual=residual,
        )
        op.set_build(list(filt.stream), self.device)
        return PhysicalPlan(op.process(src.stream), src.symbols + [node.mark])

    # -- ordering -------------------------------------------------------------

    def _sort_keys(self, plan: PhysicalPlan, orderings) -> list:
        return [
            SortKey(plan.channel(sym.name), ascending, nulls_first)
            for sym, ascending, nulls_first in orderings
        ]

    def _visit_SortNode(self, node: P.SortNode) -> PhysicalPlan:
        src = self.plan(node.source)
        op = OrderByOperator(self._sort_keys(src, node.orderings))
        return PhysicalPlan(op.process(src.stream), src.symbols)

    def _visit_TopNNode(self, node: P.TopNNode) -> PhysicalPlan:
        src = self.plan(node.source)
        op = TopNOperator(self._sort_keys(src, node.orderings), node.count)
        return PhysicalPlan(op.process(src.stream), src.symbols)

    def _visit_LimitNode(self, node: P.LimitNode) -> PhysicalPlan:
        src = self.plan(node.source)
        op = LimitOperator(node.count, getattr(node, "offset", 0))
        return PhysicalPlan(op.process(src.stream), src.symbols)

    # -- shape nodes ----------------------------------------------------------

    def _visit_UnionNode(self, node: P.UnionNode) -> PhysicalPlan:
        def stream():
            for child, mapping in zip(node.sources, node.source_symbols):
                sub = self.plan(child)
                exprs = []
                for m, out in zip(mapping, node.symbols):
                    if m.type.name == "unknown":
                        # a NULL-literal branch column: no castable values
                        exprs.append(Literal(None, out.type))
                        continue
                    e: Expr = InputRef(sub.channel(m.name), m.type)
                    if m.type.name != out.type.name:
                        # branch type narrower than the union's unified type
                        # (e.g. decimal cents unioned with double): a real
                        # CAST, not a relabel — decimals must descale
                        e = SpecialForm(Form.CAST, [e], out.type)
                    exprs.append(e)
                proj = FilterProjectOperator(None, exprs)
                yield from proj.process(sub.stream)

        return PhysicalPlan(stream(), node.symbols)

    def _visit_EnforceSingleRowNode(self, node: P.EnforceSingleRowNode) -> PhysicalPlan:
        src = self.plan(node.source)
        device = self.device

        def stream():
            total = 0
            emitted = False
            for b in src.stream:
                n = b.num_rows_host()
                total += n
                if total > 1:
                    raise RuntimeError("Scalar sub-query has returned multiple rows")
                if n:
                    emitted = True
                    yield b
            if not emitted:
                # no rows: one all-NULL row, built on the planner's device
                yield Batch(
                    [null_column(s.type, 1, device) for s in src.symbols],
                    torch.ones(1, dtype=torch.bool, device=device),
                )

        return PhysicalPlan(stream(), src.symbols)

    def _visit_ExchangeNode(self, node: P.ExchangeNode) -> PhysicalPlan:
        # single-process execution: exchanges are pass-through; merge
        # exchanges re-sort to restore global order
        src = self.plan(node.source)
        if node.kind == "merge" and node.orderings:
            op = OrderByOperator(self._sort_keys(src, node.orderings))
            return PhysicalPlan(op.process(src.stream), src.symbols)
        return PhysicalPlan(src.stream, src.symbols)

    def _visit_OutputNode(self, node: P.OutputNode) -> PhysicalPlan:
        src = self.plan(node.source)
        if [s.name for s in src.symbols] != [s.name for s in node.symbols]:
            proj = FilterProjectOperator(
                None,
                [InputRef(src.channel(s.name), s.type) for s in node.symbols],
            )
            return PhysicalPlan(proj.process(src.stream), node.symbols)
        return PhysicalPlan(src.stream, node.symbols)


def build_agg_inputs(node: "P.AggregationNode", src) -> tuple:
    """(projection exprs, AggSpecs, input types) for an AggregationNode: the
    one place the aggregate input layout is decided (group keys first, then
    one computed arg per aggregate, a FILTER folded as IF(filter, arg,
    NULL), a two-input aggregate taking two channels).  Shared by the local
    planner and the mesh's aggregation paths, so their layouts agree."""
    ngroups = len(node.group_symbols)
    proj: list = [src.rewrite(s.ref()) for s in node.group_symbols]
    specs: list = []
    input_types = [s.type for s in node.group_symbols]
    for out_sym, agg in node.aggregations:
        name = agg.function
        arg = src.rewrite(agg.args[0]) if agg.args else None
        if agg.filter is not None:
            f = src.rewrite(agg.filter)
            if name == "count_star":
                name = "count"
                arg = SpecialForm(
                    Form.IF,
                    [f, Literal(1, T.BIGINT), Literal(None, T.BIGINT)],
                    T.BIGINT,
                )
            else:
                arg = SpecialForm(Form.IF, [f, arg, Literal(None, arg.type)], arg.type)
        if arg is None:
            specs.append(AggSpec(name, None, out_sym.type))
            continue
        ch = len(proj)
        proj.append(arg)
        input_types.append(arg.type)
        arg2_ch = None
        if len(agg.args) > 1:
            # two-input aggregates (covar/corr y and x, map_agg key and value)
            arg2 = src.rewrite(agg.args[1])
            if agg.filter is not None:
                arg2 = SpecialForm(
                    Form.IF,
                    [src.rewrite(agg.filter), arg2, Literal(None, arg2.type)],
                    arg2.type,
                )
            arg2_ch = len(proj)
            proj.append(arg2)
            input_types.append(arg2.type)
        specs.append(
            AggSpec(
                name,
                ch,
                out_sym.type,
                # planner range-certificate license (verify.numeric
                # license_decimal_sums): rides the plan node so the partial
                # and merge steps read the same proof
                sum_bound=getattr(agg, "sum_bound", None),
                arg2=arg2_ch,
            )
        )
    return proj, specs, input_types


def supports_uniform_distinct(node: "P.AggregationNode") -> bool:
    """The DISTINCT shape the dedupe pre-aggregation and the mesh's
    single-stage path can express: every aggregate DISTINCT over one shared
    argument list, no FILTER clauses (the fragmenter and both executors
    consult this one predicate, so the plan and the run agree)."""
    distincts = [a for _, a in node.aggregations if a.distinct]
    return bool(distincts) and (
        len(distincts) == len(node.aggregations)
        and len({tuple(x.key() for x in a.args) for a in distincts}) == 1
        and all(a.filter is None for a in distincts)
    )


def build_distinct_dedupe(node: "P.AggregationNode", src) -> tuple:
    """(projection exprs, output symbols) of the DISTINCT dedupe
    pre-aggregation: the group keys, then the (uniform) distinct argument
    columns.  Used by the local planner and the mesh's single-stage path."""
    args0 = next(a for _, a in node.aggregations if a.distinct).args
    proj = [src.rewrite(s.ref()) for s in node.group_symbols]
    proj += [src.rewrite(a) for a in args0]
    symbols = list(node.group_symbols) + [P.Symbol(a.name, a.type) for a in args0]
    return proj, symbols


def null_column(t: T.Type, n: int, device: torch.device) -> Column:
    """`n` NULLs of type `t` on `device` (a long decimal as [n, 2] limbs;
    a string kind with an empty dictionary)."""
    from trino_tpu_torch.columnar.column import torch_dtype
    from trino_tpu_torch.columnar.dictionary import StringDictionary

    shape = (n, 2) if isinstance(t, T.DecimalType) and t.is_long else (n,)
    data = torch.zeros(shape, dtype=torch_dtype(t.np_dtype), device=device)
    valid = torch.zeros(n, dtype=torch.bool, device=device)
    d = StringDictionary([]) if T.is_string_kind(t) else None
    return Column(data, t, valid, d)


def _host_minmax(batches, channel: int):
    """(lo, hi) of a materialized column's live+valid values, or None when
    the domain is empty or unfilterable (dictionary codes are not portable
    across scans; long-decimal limb planes and booleans have no useful
    scalar range).  The reduction runs on the device and three scalars come
    back per batch in one transfer."""
    lo = hi = None
    for b in batches:
        c = b.columns[channel]
        if c.dictionary is not None or c.data.ndim > 1 or c.data.dtype == torch.bool:
            return None
        data = c.data
        if data.is_floating_point():
            big, small = float("inf"), float("-inf")
        else:
            info = torch.iinfo(data.dtype)
            big, small = info.max, info.min
        live = b.mask()
        if c.valid is not None:
            live = torch.logical_and(live, c.valid)
        # an any-live flag, not a count: a count in a narrow key dtype wraps
        packed = torch.stack(
            [
                torch.where(live, data, big).min(),
                torch.where(live, data, small).max(),
                live.any().to(data.dtype),
            ]
        ).cpu().numpy()
        if packed[2] == 0:
            continue
        blo, bhi = packed[0], packed[1]
        lo = blo if lo is None else min(lo, blo)
        hi = bhi if hi is None else max(hi, bhi)
    if lo is None:
        return None
    return (lo, hi)


def _range_expr(sym, lo, hi) -> Expr:
    from decimal import Decimal

    from trino_tpu_torch.expr.ir import and_, comparison

    t = sym.type
    if isinstance(t, T.DecimalType):
        lo_v = Decimal(int(lo)) / t.scale_factor
        hi_v = Decimal(int(hi)) / t.scale_factor
    elif t.np_dtype.kind == "f":
        lo_v, hi_v = float(lo), float(hi)
    else:
        lo_v, hi_v = int(lo), int(hi)
    return and_(
        comparison(">=", sym.ref(), Literal(lo_v, t)),
        comparison("<=", sym.ref(), Literal(hi_v, t)),
    )


def _compact_stream(stream):
    for b in stream:
        n = b.num_rows_host()
        cap = next_pow2(max(n, 1), floor=1024)
        if cap >= b.capacity:
            yield b
            continue
        yield b.compact_device(out_capacity=cap)

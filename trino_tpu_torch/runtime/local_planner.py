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
re-sorts), Window, Unnest, Sample (its scans fed serially),
PatternRecognition, Sort, TopN, Limit and Output: every node the JAX
package's planner has.  Any other node raises NotImplementedError naming
it.

Memory budgets (`query_max_memory`, `query_max_memory_bytes`, and the
shared pool's limit): the planner holds a per-query reservation tree
(runtime/memory.py, on the shared pool while a statement runs), and the
blocking operators reserve before they materialize.  Over budget, a join
build, a grouped aggregation and a partitioned window run in hash-partition
waves and ORDER BY becomes an external sort, with the partitions that are
not resident spilled through the filesystem (`spill_enabled`) or held in
host RAM (runtime/spill.py); a join's build is also revocable, so pressure
from the shared pool can spill it mid-probe and the probe finishes in
waves.  `memory_wave_partitions` pins the wave count.
"""

from __future__ import annotations

import dataclasses
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


class LocalExecutionPlanner:
    def __init__(
        self,
        catalogs: CatalogManager,
        device: torch.device,
        target_splits: int = 4,
        stats=None,
        properties=None,
    ):
        from trino_tpu_torch.runtime.lifecycle import query_memory_context
        from trino_tpu_torch.runtime.session import SessionProperties
        from trino_tpu_torch.runtime.spill import session_budget

        self.catalogs = catalogs
        self.device = device
        self.target_splits = target_splits
        self.stats = stats  # Optional[StatsCollector] for EXPLAIN ANALYZE
        self.properties = properties or SessionProperties()
        #: per-query budget tree (reference: AggregatedMemoryContext +
        #: MemoryPool); blocking operators reserve through its children.
        #: While a statement runs it lives on the shared process pool, where
        #: the revoke tier and the low-memory killer see it
        self.memory = query_memory_context(session_budget(self.properties))
        if stats is not None:
            stats.memory = self.memory
        #: plan-tree depth of the node being planned (EXPLAIN ANALYZE's indent)
        self._depth = 0
        #: build-side key ranges registered by inner-join builds, keyed by
        #: the probe symbol they prune (DynamicFilterService role)
        self.dynamic_filters: dict = {}
        #: > 0 while planning below a SampleNode: its scans feed serially,
        #: since the kept rows follow the batches' arrival order
        self._serial_scans = 0
        #: plan-position counter that seeds each SampleNode's salt
        self._sample_seq = 0

    def _budget(self) -> int:
        """The device budget blocking operators plan against: the session
        budget and any shared pool limit, whichever is tighter (0 =
        unconstrained: no wave machinery runs)."""
        from trino_tpu_torch.runtime.spill import effective_budget

        return effective_budget(self.properties, self.memory)

    def _observer(self):
        """Wave/spill event sink: the metrics registry plus EXPLAIN
        ANALYZE's StatsCollector counters when one is attached."""
        from trino_tpu_torch.runtime.spill import PressureObserver

        return PressureObserver(sink=self.stats)

    def _make_spiller(self):
        """A filesystem spill store for one wave operation, or None when
        `spill_enabled` is off (partitions stay in host RAM).  Called
        lazily, at the first spill, so an unconstrained query never touches
        the filesystem."""
        from trino_tpu_torch.runtime.spill import SpillManager, spill_to_disk

        if not spill_to_disk(self.properties):
            return None
        return SpillManager(observer=self._observer())

    def plan(self, node: P.PlanNode) -> PhysicalPlan:
        method = getattr(self, "_visit_" + type(node).__name__, None)
        if method is None:
            raise NotImplementedError(
                f"plan node {type(node).__name__}: not ported yet"
            )
        self._depth += 1
        try:
            out = method(node)
        finally:
            self._depth -= 1
        if self.stats is not None:
            st = self.stats.register(
                type(node).__name__.replace("Node", ""), depth=self._depth
            )
            out = PhysicalPlan(self.stats.instrument(st, out.stream), out.symbols)
        return out

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
                from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR

                FAILURE_INJECTOR.maybe_fail(
                    f"scan:{node.handle.schema}.{node.handle.table}:{split.seq}"
                )
                op = ScanOperator(
                    connector, split, names, types, self.device,
                    page_rows=page_rows, use_cache=use_cache,
                )
                return op.batches()

            return make

        if concurrency > 1 and len(splits) > 1 and not self._serial_scans:
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

    def _visit_UnnestNode(self, node: P.UnnestNode) -> PhysicalPlan:
        from trino_tpu_torch.ops.unnest import UnnestOperator

        src = self.plan(node.source)
        exprs = [src.rewrite(e) for _, e in node.unnest]
        op = UnnestOperator(exprs, with_ordinality=node.ordinality is not None)
        return PhysicalPlan(op.process(src.stream), node.outputs)

    def _visit_SampleNode(self, node: P.SampleNode) -> PhysicalPlan:
        from trino_tpu_torch.ops.sample import SampleOperator

        # the kept rows follow each batch's arrival position, so the scans
        # below feed their splits in order: the same statement samples the
        # same rows run after run, on every device (the JAX package's
        # parallel split readers may reorder them)
        self._serial_scans += 1
        try:
            src = self.plan(node.source)
        finally:
            self._serial_scans -= 1
        # deterministic per plan position: re-planning the same query
        # samples the same rows
        self._sample_seq += 1
        op = SampleOperator(node.ratio, seed=self._sample_seq)
        return PhysicalPlan(op.process(src.stream), src.symbols)

    def _visit_PatternRecognitionNode(self, node: P.PatternRecognitionNode) -> PhysicalPlan:
        from trino_tpu_torch.ops.pattern import PatternRecognitionOperator

        src = self.plan(node.source)
        # the DEFINEs rewritten to channel space over the source layout
        rewritten = dataclasses.replace(
            node, defines=[(v, src.rewrite(e)) for v, e in node.defines]
        )
        op = PatternRecognitionOperator(rewritten, src.symbols, self.device)
        return PhysicalPlan(op.process(src.stream), node.outputs)

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
        budget = self._budget()
        # group keys must be identity InputRefs for the fused step, so the
        # key dictionaries survive the projection; the wave stream reduces
        # projected batches itself
        fuse = not (budget and ngroups) and all(
            isinstance(proj[i], InputRef) for i in range(ngroups)
        )

        def make_op():
            return AggregationOperator(
                list(range(ngroups)),
                specs,
                input_types,
                self.device,
                mode=node.step,
                fold_every=self.properties.get("agg_fold_batches"),
                use_pallas=self.properties.get("pallas_agg"),
                pre_step=pre.fusable_step() if fuse else None,
                memory_ctx=self.memory.child("aggregation"),
            )

        feed = src.stream if fuse else pre.process(src.stream)
        if budget and ngroups:
            stream = _agg_wave_stream(
                make_op, feed, list(range(ngroups)), int(budget), self.device,
                observer=self._observer(), spill_factory=self._make_spiller,
                properties=self.properties,
            )
        else:
            stream = make_op().process(feed)
        return PhysicalPlan(stream, node.outputs)

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

        def make_op():
            return HashJoinOperator(
                node.kind,
                probe_keys,
                build_keys,
                build.types(),
                probe_types=probe.types(),
                residual=residual,
            )

        return PhysicalPlan(
            self._budgeted_join(make_op, build_batches, probe, build_keys, probe_keys,
                                node.kind == "full"),
            out_symbols,
        )

    def _budgeted_join(self, make_op, build_batches, probe, build_keys, probe_keys,
                       full: bool):
        """The join's output stream under the memory budget.  The dense
        build's footprint is reserved BEFORE it materializes; over budget
        the join runs in hash-partition waves with spill (the analog of
        HashBuilderOperator.startMemoryRevoke + GenericPartitioningSpiller
        + SpillingJoinProcessor).  Within budget the build registers as
        revocable: pressure from the shared pool spills it mid-probe, and
        the probe's remainder finishes in waves."""
        from trino_tpu_torch.runtime import spill as _spill
        from trino_tpu_torch.runtime.memory import (
            ExceededMemoryLimitException,
            batches_bytes,
        )

        device = self.device
        ctx = self.memory.child("join_build")
        observer = self._observer()
        need = 2 * batches_bytes(build_batches)  # raw batches + dense copy
        try:
            ctx.add_bytes(need)
        except ExceededMemoryLimitException:
            n_waves = _spill.wave_count(need, self._budget(), self.properties)
            spiller = self._make_spiller()
            build_host = _spill.pull_host(list(build_batches))
            build_batches.clear()
            build_side = _spill.partition_side(
                build_host, build_keys, n_waves, spiller, "jb"
            )
            del build_host

            def wave_stream():
                try:
                    probe_host = _spill.pull_host(list(probe.stream))
                    probe_side = _spill.partition_side(
                        probe_host, probe_keys, n_waves, spiller, "jp"
                    )
                    del probe_host
                    yield from _spill.partition_wave_join(
                        make_op, build_side, probe_side, n_waves, ctx, observer, device
                    )
                finally:
                    if spiller is not None:
                        spiller.close()

            return wave_stream()
        op = make_op()
        op.set_build(build_batches, device)
        if full:
            # a full outer join tracks the build's matched flags across the
            # whole probe; a mid-stream revoke cannot split that state
            # exactly, so full joins are not revocable (the up-front waves
            # above still cover them)
            def stream():
                yield from op.process(probe.stream)
                ctx.close()

            return stream()

        holder: dict = {}

        def revoke_spill() -> int:
            # runs on the REQUESTING thread under the handle's lock; the
            # owner may be mid-batch against the dense build, so only the
            # raw build batches are copied out here, and the owner drops
            # its own device references at its next batch
            spiller = self._make_spiller()
            k = _spill.wave_count(need, self._budget(), self.properties)
            host = _spill.pull_host(list(build_batches))
            holder["side"] = _spill.partition_side(host, build_keys, k, spiller, "jb")
            holder["spiller"] = spiller
            holder["k"] = k
            build_batches.clear()
            freed = ctx.reserved
            ctx.set_bytes(0)
            return freed

        handle = _spill.REVOCABLES.register(
            _spill.RevocableOperator("join", ctx, revoke_spill)
        )

        def stream():
            try:
                it = iter(probe.stream)
                for pb in it:
                    if handle.revoked:
                        # the revoke tier spilled the build: drop the device
                        # references; this batch and the rest of the probe
                        # finish in waves against the spilled build
                        import itertools

                        op.release_build()
                        yield from _revoked_join_remainder(
                            make_op, holder, probe_keys,
                            itertools.chain([pb], it), ctx, observer, device,
                        )
                        return
                    yield op._join_batch(pb)
                ctx.close()
            finally:
                handle.finish()
                sp = holder.get("spiller")
                if sp is not None:
                    sp.close()

        return stream()

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

    def _visit_WindowNode(self, node: P.WindowNode) -> PhysicalPlan:
        from trino_tpu_torch.ops.window import WindowOperator

        src = self.plan(node.source)
        part, order, specs = window_args(node, src)
        budget = self._budget()
        if budget and part:
            stream = _window_wave_stream(
                lambda: WindowOperator(part, order, specs),
                src.stream, list(part), int(budget), self.device,
                observer=self._observer(), spill_factory=self._make_spiller,
                properties=self.properties,
            )
        else:
            # a window with no PARTITION BY needs every row at once: no
            # partition-disjoint wave exists
            stream = WindowOperator(part, order, specs).process(src.stream)
        return PhysicalPlan(stream, node.outputs)

    # -- ordering -------------------------------------------------------------

    def _sort_keys(self, plan: PhysicalPlan, orderings) -> list:
        return [
            SortKey(plan.channel(sym.name), ascending, nulls_first)
            for sym, ascending, nulls_first in orderings
        ]

    def _visit_SortNode(self, node: P.SortNode) -> PhysicalPlan:
        src = self.plan(node.source)
        op = OrderByOperator(
            self._sort_keys(src, node.orderings),
            memory_ctx=self.memory.child("sort"),
            spill_factory=self._make_spiller,
            observer=self._observer(),
        )
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


def _revoked_join_remainder(make_op, holder, probe_keys, probe_iter, ctx,
                            observer, device):
    """Finish a revoked join: the build already sits in spilled partitions
    (`holder`, written by the revoke callback); the unprocessed remainder
    of the probe partitions the same way and the join completes in waves.
    Probe batches emitted before the revoke were joined against the whole
    build, so the split point is exact."""
    from trino_tpu_torch.runtime import spill as _spill

    probe_host = _spill.pull_host(list(probe_iter))
    probe_side = _spill.partition_side(
        probe_host, probe_keys, holder["k"], holder["spiller"], "jp"
    )
    del probe_host
    yield from _spill.partition_wave_join(
        make_op, holder["side"], probe_side, holder["k"], ctx, observer, device
    )


def _agg_wave_stream(make_op, feed, key_channels: list, budget: int, device,
                     observer=None, spill_factory=None, properties=None):
    """Memory-bounded grouped aggregation: group-hash STATE waves.

    Reference role: HashAggregationOperator.startMemoryRevoke:449.  Input
    batches reduce to partial states at once; when the states on the
    device pass a quarter of the budget they SPILL (through the filesystem
    under `spill_enabled`, host RAM otherwise).  The final merge then runs
    in group-hash waves over the spilled states: hashing by the whole group
    key keeps every group inside one wave, so the merges are exact and
    group-disjoint.  A query within budget never spills and never copies:
    one merge on the device, as on the unbudgeted path.

    The accumulating state is registered REVOCABLE: pressure from the
    shared pool can flush it to the spill tier early instead of killing a
    query.  An aggregation without streamable partials (a collect
    aggregate) takes raw-input waves instead (`_agg_raw_wave_stream`).
    """
    from trino_tpu_torch.columnar.batch import concat_batches
    from trino_tpu_torch.runtime import spill as _spill
    from trino_tpu_torch.runtime.memory import (
        ExceededMemoryLimitException,
        batch_bytes,
    )

    if observer is None:
        observer = _spill.PressureObserver()
    op = make_op()
    if not op.streaming:
        yield from _agg_raw_wave_stream(
            make_op, op, feed, key_channels, budget, device, observer,
            spill_factory, properties,
        )
        return
    out_mode = "merge" if op.mode in ("partial", "merge") else "final"
    spill_at = max(budget // 4, 1)
    spiller = None
    spiller_made = False

    def get_spiller():
        nonlocal spiller, spiller_made
        if not spiller_made:
            spiller_made = True
            spiller = spill_factory() if spill_factory is not None else None
        return spiller

    acc: list = [None]  # created at the first flush
    state = {"device": [], "bytes": 0}

    def flush() -> int:
        """Move the device states to the spill tier; returns bytes freed.
        Called by the owner (over spill_at) and by the revoke tier (under
        the handle's reentrant lock)."""
        with handle.lock:
            if not state["device"]:
                return 0
            if acc[0] is None:
                acc[0] = _spill.SpillingAccumulator(get_spiller(), "aggstate")
            acc[0].push_chunk(_spill.pull_host(list(state["device"])))
            state["device"].clear()
            freed = state["bytes"]
            state["bytes"] = 0
        op.memory_ctx.set_bytes(0)
        return freed

    handle = _spill.REVOCABLES.register(
        _spill.RevocableOperator("aggregation", op.memory_ctx, flush)
    )
    seen_any = False
    try:
        for b in feed:
            seen_any = True
            s = op.reduce_batch(b)
            with handle.lock:
                state["device"].append(s)
                state["bytes"] += batch_bytes(s)
                cur = state["bytes"]
            over = cur > spill_at
            try:
                op.memory_ctx.set_bytes(cur)
            except ExceededMemoryLimitException:
                over = True  # the reservation tree is the breach signal
            with handle.lock:
                # a concurrent revoke may have flushed (and released)
                # between the read of `cur` and set_bytes: re-sync so freed
                # memory is not reserved again (a handle revokes once, so
                # one correction closes the window)
                resync = state["bytes"] if state["bytes"] != cur else None
            if resync is not None:
                try:
                    op.memory_ctx.set_bytes(resync)
                except ExceededMemoryLimitException:
                    over = True
            if over:
                flush()
        handle.finish()  # the merge phase is no longer revocable
        if not seen_any:
            yield op.finish()
            op.memory_ctx.close()
            return
        if acc[0] is None:
            # within budget: one merge on the device, no host round trip
            device_states = state["device"]
            yield op._combine(
                device_states[0] if len(device_states) == 1 else concat_batches(device_states),
                out_mode,
            )
            op.memory_ctx.close()
            return
        flush()
        total = acc[0].total_bytes
        n_waves = _spill.wave_count(2 * total, budget, properties)
        observer.waves("aggregation", n_waves)
        for wave in range(n_waves):
            # waves select rows on the host by VALUE hash (state batches
            # carry batch-local dictionaries, so code hashes would split a
            # group across waves); each wave's footprint is ~total/n_waves
            parts = [
                _spill.to_device(p, device)
                for p in acc[0].wave_parts(key_channels, n_waves, wave)
            ]
            if not parts:
                continue
            yield op._combine(
                parts[0] if len(parts) == 1 else concat_batches(parts), out_mode
            )
        op.memory_ctx.close()
    finally:
        handle.finish()
        if spiller is not None:
            spiller.close()


def _agg_raw_wave_stream(make_op, op, feed, key_channels: list, budget: int, device,
                         observer, spill_factory=None, properties=None):
    """Raw-input waves for aggregates without streamable partials (the
    collect aggregates): the input accumulates in the operator until the
    budget is breached (the spool holds the same device batches the
    operator keeps, so a run under the budget copies nothing); then every
    batch is pulled to the host (one wait for all the copies), partitioned
    by the group-key hash into as many waves as the projected footprint
    needs (spilled under `spill_enabled`), and each wave is fed to a fresh
    operator."""
    from trino_tpu_torch.runtime import spill as _spill
    from trino_tpu_torch.runtime.memory import ExceededMemoryLimitException

    it = iter(feed)
    spool = []
    over = False
    for b in it:
        spool.append(b)
        try:
            op.push(b)
            if op.state_bytes() > budget:
                over = True
        except ExceededMemoryLimitException:
            over = True  # the reservation tree is the breach signal
        if over:
            break
    if not over:
        yield op.finish()
        op.memory_ctx.close()
        return
    consumed = len(spool)
    copies: list = []
    spool = [_spill.pull_host_async(b, copies) for b in spool]
    spool.extend(_spill.pull_host_async(b, copies) for b in it)
    _spill.wait_pulls(copies)
    frac = consumed / max(len(spool), 1)
    projected = op.state_bytes() / max(frac, 1e-3)
    n_waves = _spill.wave_count(int(2 * projected), budget, properties)
    op.memory_ctx.close()
    del op  # free the over-budget device state before the first wave
    spiller = spill_factory() if spill_factory is not None else None
    # the wave count is known before anything is written, so the raw input
    # partitions at write time: one part per wave, each read once
    side = _spill.partition_side(spool, key_channels, n_waves, spiller, "aggraw")
    spool = None
    observer.waves("aggregation", n_waves)
    try:
        for wave in range(n_waves):
            wop = make_op()
            for p in side.load_part(wave):
                wop.push(_spill.to_device(p, device))
            yield wop.finish()
            wop.memory_ctx.close()
    finally:
        if spiller is not None:
            spiller.close()


def _window_wave_stream(make_op, feed, key_channels: list, budget: int, device,
                        observer=None, spill_factory=None, properties=None):
    """Memory-bounded window execution: a window function looks within ONE
    partition only, so hash-partitioning the input by the PARTITION BY keys
    into waves is exact; each wave materializes and sorts only its slice on
    the device (reference role: the spill path of WindowOperator /
    PagesIndex, as partition-disjoint waves).  Input over budget stages
    through the filesystem under `spill_enabled`."""
    from trino_tpu_torch.runtime import spill as _spill
    from trino_tpu_torch.runtime.memory import batch_bytes

    if observer is None:
        observer = _spill.PressureObserver()
    acc_dev: list = []
    store = None
    spiller = None
    total = 0
    seen_dicts: set = set()
    try:
        for b in feed:
            # shared dictionaries counted once across the accumulation
            total += batch_bytes(b, _seen_dicts=seen_dicts)
            if store is not None:
                store.push_chunk([_spill.pull_host(b)])
            else:
                acc_dev.append(b)
                if total > budget:
                    spiller = spill_factory() if spill_factory is not None else None
                    store = _spill.SpillingAccumulator(spiller, "window")
                    store.push_chunk(_spill.pull_host(list(acc_dev)))
                    acc_dev.clear()
        if store is None:
            yield from make_op().process(iter(acc_dev))
            return
        n_waves = _spill.wave_count(2 * total, budget, properties)
        observer.waves("window", n_waves)
        for wave in range(n_waves):
            parts = store.wave_parts(key_channels, n_waves, wave)
            if not parts:
                continue
            yield from make_op().process(_spill.to_device(p, device) for p in parts)
    finally:
        if spiller is not None:
            spiller.close()


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
                param=getattr(agg, "param", None),
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


def window_args(node: "P.WindowNode", src) -> tuple:
    """(partition channels, order keys, WindowSpecs) of a WindowNode over
    `src`'s layout (a PhysicalPlan or a mesh stage value)."""
    from trino_tpu_torch.ops.window import WindowSpec

    part = [src.channel(s.name) for s in node.partition_by]
    order = [SortKey(src.channel(s.name), asc, nf) for s, asc, nf in node.order_by]
    specs = []
    for out_sym, fn in node.functions:
        arg = src.channel(fn.args[0].name) if fn.args else None
        default_ch = src.channel(fn.default.name) if fn.default is not None else None
        specs.append(
            WindowSpec(
                fn.name if fn.name != "count_star" else "count",
                arg,
                out_sym.type,
                offset=fn.offset,
                default_channel=default_ch,
                n_buckets=fn.n_buckets_expr or 1,
                frame=fn.frame,
                start_off=fn.start_off,
                end_off=fn.end_off,
                ignore_nulls=fn.ignore_nulls,
                sum_bound=fn.sum_bound,
            )
        )
    return part, order, specs


def null_column(t: T.Type, n: int, device: torch.device) -> Column:
    """`n` NULLs of type `t` on `device` (a long decimal as [n, 2] limbs; an
    array as [n, 1] and a map as [n, 2] with zero lengths; a string kind
    with an empty dictionary)."""
    from trino_tpu_torch.columnar.column import torch_dtype
    from trino_tpu_torch.columnar.dictionary import StringDictionary

    lengths = None
    if isinstance(t, (T.ArrayType, T.MapType)):
        shape = (n, 2 if isinstance(t, T.MapType) else 1)
        lengths = torch.zeros(n, dtype=torch.int32, device=device)
    elif isinstance(t, T.DecimalType) and t.is_long:
        shape = (n, 2)
    else:
        shape = (n,)
    data = torch.zeros(shape, dtype=torch_dtype(t.np_dtype), device=device)
    valid = torch.zeros(n, dtype=torch.bool, device=device)
    d = StringDictionary([]) if T.is_string_kind(t) else None
    return Column(data, t, valid, d, lengths)


def _host_minmax(batches, channel: int):
    """(lo, hi) of a materialized column's live+valid values, or None when
    the domain is empty or unfilterable (dictionary codes are not portable
    across scans; long-decimal limb planes and booleans have no useful
    scalar range).  The reduction runs on the device and three scalars come
    back per batch in one transfer."""
    lo = hi = None
    for b in batches:
        c = b.columns[channel]
        if (
            c.dictionary is not None
            or c.lengths is not None  # an array or map key has no range
            or c.data.ndim > 1  # long-decimal limb planes
            or c.data.dtype == torch.bool
        ):
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

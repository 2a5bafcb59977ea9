"""AST -> logical plan (reference: sql/planner/LogicalPlanner.java:155,
QueryPlanner.java, RelationPlanner.java, SubqueryPlanner — combined).

Planning is analysis-driven: expressions are typed while the plan is built.
Subqueries decorrelate on the way in: correlated equi-conjuncts become join
criteria (scalar aggregates -> grouped LEFT JOIN; EXISTS/IN -> semi join with
mark), mirroring the reference's TransformCorrelated* rule family but done
directly at plan time.
"""

from __future__ import annotations

from typing import Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.api import CatalogManager, TableHandle
from trino_tpu_torch.expr import ir
from trino_tpu_torch.expr.ir import Call, Expr, Form, Literal, SpecialForm, SymbolRef
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.analyzer import (
    AnalysisError,
    ExprAnalyzer,
    Field,
    Scope,
    collect_aggregates,
    split_conjuncts,
)
from trino_tpu_torch.planner.functions import AGG_FUNCS, REWRITTEN_AGGS, agg_result_type
from trino_tpu_torch.sql import ast


class RelationPlan:
    def __init__(self, node: P.PlanNode, fields: list[Field]):
        self.node = node
        self.fields = fields

    def scope(self, parent: Optional[Scope] = None) -> Scope:
        return Scope(self.fields, parent)


class Session:
    """Minimal session state (reference: Session.java)."""

    def __init__(self, catalog: Optional[str] = None, schema: Optional[str] = None):
        self.catalog = catalog
        self.schema = schema
        self.properties: dict = {}


class LogicalPlanner:
    def __init__(self, catalogs: CatalogManager, session: Session, views=None):
        self.catalogs = catalogs
        self.session = session
        self.alloc = P.SymbolAllocator()
        #: (catalog, schema, name) -> view Query AST; views expand inline at
        #: plan time (reference: sql/analyzer view expansion in
        #: StatementAnalyzer.Visitor.visitTable)
        self.views = views or {}
        #: views currently being expanded (cycle detection: the reference
        #: raises VIEW_IS_RECURSIVE instead of recursing to death)
        self._view_stack: set = set()

    # -- statements ----------------------------------------------------------

    def plan(self, query: ast.Query) -> P.OutputNode:
        rp, names = self.plan_query(query, outer=None, ctes={})
        return P.OutputNode(rp.node, names, [f.symbol for f in rp.fields])

    # -- queries -------------------------------------------------------------

    def plan_query(self, q: ast.Query, outer: Optional[Scope], ctes: dict):
        ctes = dict(ctes)
        for w in q.ctes:
            ctes[w.name] = w
        rp, names = self.plan_query_body(q.body, outer, ctes)
        # ORDER BY / LIMIT at query level
        if q.order_by or q.limit is not None or q.offset:
            rp, names = self._apply_order_limit(rp, names, q, outer, ctes)
        return rp, names

    def _apply_order_limit(self, rp, names, q: ast.Query, outer, ctes):
        node = rp.node
        if q.order_by:
            orderings = []
            hidden: list = []  # (Symbol, Expr) computed sort keys
            hidden_src: list = []  # sort keys over PRE-projection symbols
            # expressions in ORDER BY see the output columns under their
            # display names (reference: Scope of the query's output)
            scope = Scope(
                [
                    Field(n, f.symbol, f.alias)
                    for f, n in zip(rp.fields, names)
                ],
                outer,
            )
            by_alias = {}
            for f, n in zip(rp.fields, names):
                by_alias.setdefault(n, f.symbol)
            for item in q.order_by:
                sym = None
                if isinstance(item.expr, ast.Identifier) and len(item.expr.parts) == 1:
                    sym = by_alias.get(item.expr.parts[0])
                if sym is None and isinstance(item.expr, ast.NumberLiteral):
                    sym = rp.fields[int(item.expr.text) - 1].symbol
                if sym is None:
                    try:
                        e = ExprAnalyzer(scope).analyze(item.expr)
                    except AnalysisError:
                        e = None
                    if isinstance(e, SymbolRef):
                        sym = P.Symbol(e.name, e.type)
                    elif e is not None:
                        # computed sort key over output columns: pre-project
                        # a hidden symbol, sort on it, drop it afterwards
                        # (reference: QueryPlanner ORDER BY synthetic symbols)
                        sym = self.alloc.new("orderby", e.type)
                        hidden.append((sym, e))
                if (
                    sym is None
                    and isinstance(item.expr, ast.Identifier)
                    and len(item.expr.parts) >= 2
                ):
                    # qualified ref (dt.d_year) whose qualifier the output
                    # scope no longer tracks: accept only when an output item
                    # carries the same source alias + display name (propagated
                    # by _plan_select_items); never bind a bare-name match to
                    # a different table's column
                    qual, name = item.expr.parts[-2], item.expr.parts[-1]
                    matches = [
                        f.symbol for f, n in zip(rp.fields, names)
                        if f.alias == qual
                        and (
                            n == name
                            # SELECT a.col AS alias ... ORDER BY a.col: the
                            # display name moved, but the Field remembers the
                            # source column
                            or f.source_name == name
                        )
                    ]
                    if len(matches) == 1:
                        sym = matches[0]
                if sym is None:
                    # ORDER BY repeating an output item's source expression
                    # (`ORDER BY substr(s_city, 1, 30)`, `ORDER BY sum(x)`) or
                    # the pre-rename source column of an aliased item —
                    # frozen-dataclass equality gives the structural match
                    matches = [
                        f.symbol
                        for f in rp.fields
                        if f.source_expr is not None
                        and f.source_expr == item.expr
                    ]
                    if not matches and isinstance(item.expr, ast.Identifier):
                        nm = item.expr.parts[-1]
                        matches = [
                            f.symbol for f in rp.fields if f.source_name == nm
                        ]
                        if len(matches) > 1:
                            raise AnalysisError(
                                f"ORDER BY column is ambiguous: {nm}"
                            )
                    if len(matches) == 1:
                        sym = matches[0]
                if sym is None and getattr(rp, "source_fields", None):
                    # ORDER BY a source column that is NOT an output item
                    # (`SELECT o_orderkey FROM orders ORDER BY o_totalprice`):
                    # resolve against the pre-projection scope and sort on a
                    # hidden symbol pushed into the final projection
                    # (reference: QueryPlanner's ORDER BY scope = source +
                    # output)
                    try:
                        e = ExprAnalyzer(
                            Scope(rp.source_fields, outer)
                        ).analyze(item.expr)
                    except AnalysisError:
                        e = None
                    if e is not None:
                        if isinstance(e, SymbolRef):
                            sym = P.Symbol(e.name, e.type)
                        else:
                            sym = self.alloc.new("orderby", e.type)
                        hidden_src.append((sym, e))
                if sym is None:
                    raise AnalysisError(
                        "ORDER BY expression must be an output column here: "
                        f"{item.expr!r}"
                    )
                nf = item.nulls_first
                if nf is None:
                    nf = not item.ascending  # reference default: NULLS LAST asc, FIRST desc
                orderings.append((sym, item.ascending, nf))
            if hidden_src:
                # push hidden source-column sort keys into the output
                # projection (its source still carries those symbols)
                assert isinstance(node, P.ProjectNode), node
                node = P.ProjectNode(
                    node.source,
                    list(node.assignments)
                    + [
                        (s, e)
                        for s, e in hidden_src
                        if not any(s.name == o.name for o, _ in node.assignments)
                    ],
                )
            if hidden:
                node = P.ProjectNode(
                    node,
                    [(f.symbol, f.symbol.ref()) for f in rp.fields]
                    + [(s, s.ref()) for s, _ in hidden_src]
                    + hidden,
                )
            for osym, *_rest in orderings:
                if not osym.type.orderable:
                    raise AnalysisError(
                        f"ORDER BY on non-orderable type {osym.type.name}"
                    )
            if q.limit is not None and not q.offset:
                node = P.TopNNode(node, orderings, q.limit)
            else:
                node = P.SortNode(node, orderings)
                if q.limit is not None or q.offset:
                    node = P.LimitNode(node, q.limit, q.offset or 0)
            if hidden or hidden_src:
                node = P.ProjectNode(
                    node, [(f.symbol, f.symbol.ref()) for f in rp.fields]
                )
        elif q.limit is not None or q.offset:
            node = P.LimitNode(node, q.limit, q.offset or 0)
        return RelationPlan(node, rp.fields), names

    def plan_query_body(self, body: ast.Node, outer, ctes):
        if isinstance(body, ast.QuerySpec):
            return self.plan_query_spec(body, outer, ctes)
        if isinstance(body, ast.SetOp):
            return self.plan_set_op(body, outer, ctes)
        if isinstance(body, ast.ValuesRelation):
            rp = self.plan_values(body)
            return rp, [f.name for f in rp.fields]
        if isinstance(body, ast.Query):
            return self.plan_query(body, outer, ctes)
        if isinstance(body, ast.TableRef):
            rp = self.plan_relation(body, outer, ctes)
            return rp, [f.name for f in rp.fields]
        raise AnalysisError(f"unsupported query body {type(body).__name__}")

    def plan_set_op(self, s: ast.SetOp, outer, ctes):
        lrp, lnames = self.plan_query_body(s.left, outer, ctes)
        rrp, rnames = self.plan_query_body(s.right, outer, ctes)
        if len(lrp.fields) != len(rrp.fields):
            raise AnalysisError(
                f"{s.op.upper()} inputs must have the same arity"
            )
        if s.op == "union":
            out_syms = []
            for lf, rf in zip(lrp.fields, rrp.fields):
                t = T.common_super_type(lf.symbol.type, rf.symbol.type)
                out_syms.append(self.alloc.new(lf.name, t))
            node = P.UnionNode(
                [lrp.node, rrp.node],
                out_syms,
                [[f.symbol for f in lrp.fields], [f.symbol for f in rrp.fields]],
            )
            if not s.all:
                node = P.AggregationNode(node, list(out_syms), [])
            fields = [Field(n, s_) for n, s_ in zip(lnames, out_syms)]
            return RelationPlan(node, fields), lnames
        # INTERSECT / EXCEPT: lowered to a tagged UNION ALL + per-side
        # counts + filter (reference: the ImplementIntersectAsUnion /
        # ImplementExceptAsUnion rules under sql/planner/iterative/rule/ +
        # SqlBase.g4:244-245).  ALL (bag) semantics ride the same plan with
        # a per-side occurrence number (row_number over all columns): the
        # k-th copy of a value on the left pairs with the k-th copy on the
        # right, so the distinct machinery over (columns..., occ) yields
        # exactly min(l, r) / max(l - r, 0) copies.
        sides = []
        for rp in (lrp, rrp):
            node_in = rp.node
            syms = [f.symbol for f in rp.fields]
            if s.all:
                occ = self.alloc.new("occ", T.BIGINT)
                node_in = P.WindowNode(
                    node_in,
                    list(syms),
                    [],
                    [(occ, P.WindowFunction("row_number", []))],
                )
                syms = syms + [occ]
            side = self.alloc.new("side", T.BIGINT)
            tag = P.ProjectNode(
                node_in,
                [(sy, sy.ref()) for sy in syms]
                + [(side, Literal(len(sides), T.BIGINT))],
            )
            sides.append((tag, syms + [side]))
        out_syms = []
        for lf, rf in zip(lrp.fields, rrp.fields):
            t = T.common_super_type(lf.symbol.type, rf.symbol.type)
            out_syms.append(self.alloc.new(lf.name, t))
        group_syms = list(out_syms)
        if s.all:
            occ_out = self.alloc.new("occ", T.BIGINT)
            group_syms.append(occ_out)
        side_sym = self.alloc.new("side", T.BIGINT)
        union = P.UnionNode(
            [n for n, _ in sides],
            group_syms + [side_sym],
            [syms for _, syms in sides],
        )
        lcnt = self.alloc.new("lcnt", T.BIGINT)
        rcnt = self.alloc.new("rcnt", T.BIGINT)
        aggs = [
            (
                lcnt,
                P.Aggregation(
                    "count_star",
                    [],
                    filter=ir.comparison(
                        "=", side_sym.ref(), Literal(0, T.BIGINT)
                    ),
                ),
            ),
            (
                rcnt,
                P.Aggregation(
                    "count_star",
                    [],
                    filter=ir.comparison(
                        "=", side_sym.ref(), Literal(1, T.BIGINT)
                    ),
                ),
            ),
        ]
        agg = P.AggregationNode(union, group_syms, aggs)
        both = ir.comparison(">", lcnt.ref(), Literal(0, T.BIGINT))
        other = (
            ir.comparison(">", rcnt.ref(), Literal(0, T.BIGINT))
            if s.op == "intersect"
            else ir.comparison("=", rcnt.ref(), Literal(0, T.BIGINT))
        )
        filt = P.FilterNode(agg, ir.and_(both, other))
        proj = P.ProjectNode(filt, [(sym, sym.ref()) for sym in out_syms])
        fields = [Field(n, s_) for n, s_ in zip(lnames, out_syms)]
        return RelationPlan(proj, fields), lnames

    def plan_values(self, v: ast.ValuesRelation) -> RelationPlan:
        scope = Scope([])
        an = ExprAnalyzer(scope)
        rows = []
        col_types: list[T.Type] = []
        for row in v.rows:
            vals = []
            for i, e in enumerate(row):
                lit = an.analyze(e)
                if not isinstance(lit, Literal):
                    from trino_tpu_torch.expr.constant_folding import try_fold

                    lit = try_fold(lit)
                    if not isinstance(lit, Literal):
                        raise AnalysisError("VALUES entries must be constant")
                if i >= len(col_types):
                    col_types.append(lit.type)
                else:
                    col_types[i] = T.common_super_type(col_types[i], lit.type)
                vals.append(lit.value)
            rows.append(vals)
        syms = [
            self.alloc.new(f"_col{i}", t if t != T.UNKNOWN else T.BIGINT)
            for i, t in enumerate(col_types)
        ]
        fields = [Field(s.name, s) for s in syms]
        return RelationPlan(P.ValuesNode(syms, rows), fields)

    # -- relations -----------------------------------------------------------

    def plan_relation(self, rel: ast.Node, outer, ctes) -> RelationPlan:
        if isinstance(rel, ast.TableRef):
            if len(rel.name) == 1 and rel.name[0] in ctes:
                w = ctes[rel.name[0]]
                sub_ctes = {k: v for k, v in ctes.items() if k != rel.name[0]}
                rp, names = self.plan_query(w.query, outer, sub_ctes)
                colnames = list(w.column_names) or names
                fields = [
                    Field(n, f.symbol, rel.name[0])
                    for n, f in zip(colnames, rp.fields)
                ]
                return RelationPlan(rp.node, fields)
            vkey = self.resolve_table_name(rel.name)
            vq = self.views.get(vkey)
            if vq is not None:
                # view expansion: plan the stored definition inline
                if vkey in self._view_stack:
                    raise AnalysisError(
                        f"view {'.'.join(rel.name)} is recursive"
                    )
                self._view_stack.add(vkey)
                try:
                    rp, names = self.plan_query(vq, None, {})
                finally:
                    self._view_stack.discard(vkey)
                fields = [
                    Field(n, f.symbol, rel.name[-1])
                    for n, f in zip(names, rp.fields)
                ]
                return RelationPlan(rp.node, fields)
            return self.plan_table_scan(rel)
        if isinstance(rel, ast.AliasedRelation):
            rp = self.plan_relation(rel.relation, outer, ctes)
            names = list(rel.column_aliases) or [f.name for f in rp.fields]
            fields = [
                Field(n, f.symbol, rel.alias) for n, f in zip(names, rp.fields)
            ]
            return RelationPlan(rp.node, fields)
        if isinstance(rel, ast.SubqueryRelation):
            rp, names = self.plan_query(rel.query, outer, ctes)
            fields = [Field(n, f.symbol) for n, f in zip(names, rp.fields)]
            return RelationPlan(rp.node, fields)
        if isinstance(rel, ast.MatchRecognize):
            return self.plan_match_recognize(rel, outer, ctes)
        if isinstance(rel, ast.TableSample):
            if not (0.0 <= rel.percent <= 100.0):
                raise AnalysisError(
                    "sample percentage must be between 0 and 100, "
                    f"got {rel.percent}"
                )
            src = self.plan_relation(rel.relation, outer, ctes)
            return RelationPlan(
                P.SampleNode(src.node, rel.percent / 100.0), src.fields
            )
        if isinstance(rel, ast.Join):
            return self.plan_join(rel, outer, ctes)
        if isinstance(rel, ast.ValuesRelation):
            return self.plan_values(rel)
        if isinstance(rel, ast.Unnest):
            # standalone FROM UNNEST(...): unnest over a one-row source
            single = RelationPlan(P.ValuesNode([], [()]), [])
            return self.plan_unnest(rel, single, outer, ctes, alias=None)
        if isinstance(rel, ast.TableFunctionCall):
            from trino_tpu_torch.planner.table_functions import TABLE_FUNCTIONS

            tf = TABLE_FUNCTIONS.get(rel.name)
            if tf is None:
                raise AnalysisError(f"table function not found: {rel.name}")
            return tf.plan(self, list(rel.args), outer, ctes)
        raise AnalysisError(f"unsupported relation {type(rel).__name__}")

    def plan_match_recognize(
        self, mr: ast.MatchRecognize, outer, ctes
    ) -> RelationPlan:
        """relation MATCH_RECOGNIZE (...) -> PatternRecognitionNode
        (reference: sql/analyzer's pattern-recognition analysis +
        RelationPlanner.visitPatternRecognitionRelation)."""
        import dataclasses

        from trino_tpu_torch.ops.pattern import parse_pattern, pattern_variables

        src = self.plan_relation(mr.relation, outer, ctes)
        scope = src.scope()
        an = ExprAnalyzer(scope)
        pvars = set(pattern_variables(parse_pattern(mr.pattern)))

        def make_strip(allowed):
            """Pattern-variable qualifiers (A.price) resolve to the source
            column.  Inside DEFINE only the variable being defined may
            qualify (a reference to ANOTHER variable means 'the last row
            matched to it' — the vectorized evaluator cannot honor that, so
            it must be an error, never a silently-wrong current-row read)."""

            def strip_qualifiers(node):
                if not isinstance(node, ast.Node):
                    return node
                if (
                    isinstance(node, ast.Identifier)
                    and len(node.parts) > 1
                    and node.parts[0].lower() in pvars
                ):
                    q = node.parts[0].lower()
                    if allowed is not None and q not in allowed:
                        raise AnalysisError(
                            f"cross-variable reference {q}.{node.parts[1]} "
                            "in DEFINE is not supported (only the variable "
                            "being defined may qualify)"
                        )
                    node = ast.Identifier(tuple(node.parts[1:]))
                kwargs = {}
                for f in dataclasses.fields(node):
                    v = getattr(node, f.name)
                    if isinstance(v, ast.Node):
                        kwargs[f.name] = strip_qualifiers(v)
                    elif isinstance(v, tuple):
                        kwargs[f.name] = tuple(
                            strip_qualifiers(x) if isinstance(x, ast.Node) else x
                            for x in v
                        )
                    else:
                        kwargs[f.name] = v
                return dataclasses.replace(node, **kwargs)

            return strip_qualifiers

        strip_qualifiers = make_strip(None)

        def col_symbol(e: ast.Node, what: str) -> P.Symbol:
            ir_e = an.analyze(strip_qualifiers(e))
            if not isinstance(ir_e, SymbolRef):
                raise AnalysisError(
                    f"MATCH_RECOGNIZE {what} must be a column reference"
                )
            return P.Symbol(ir_e.name, ir_e.type)

        partition_by = [col_symbol(e, "PARTITION BY") for e in mr.partition_by]
        order_by = [
            (col_symbol(it.expr, "ORDER BY"), it.ascending, it.nulls_first)
            for it in mr.order_by
        ]
        defines = [
            (v.lower(), an.analyze(make_strip({v.lower()})(cond)))
            for v, cond in mr.defines
        ]
        for v, _ in defines:
            if v not in pvars:
                raise AnalysisError(
                    f"DEFINE variable {v} not used in PATTERN"
                )
        measures = []
        for e, name in mr.measures:
            spec, out_t = self._analyze_measure(e, pvars, an, strip_qualifiers)
            measures.append((P.Symbol(name, out_t), spec))
        node = P.PatternRecognitionNode(
            src.node,
            partition_by,
            order_by,
            defines,
            mr.pattern,
            measures,
            mr.rows_per_match,
            mr.after_match,
        )
        if mr.rows_per_match == "one":
            fields = [Field(s.name, s) for s in partition_by] + [
                Field(s.name, s) for s, _ in measures
            ]
        else:
            fields = list(src.fields) + [
                Field(s.name, s) for s, _ in measures
            ]
        return RelationPlan(node, fields)

    def _analyze_measure(self, e: ast.Node, pvars, an, strip):
        """-> (MeasureSpec, out_type).  Supported shapes (reference:
        PatternRecognitionNode.Measure): FIRST/LAST(V.col [, offset]),
        V.col / col (= LAST), CLASSIFIER(), MATCH_NUMBER(), and
        count/sum/avg/min/max(V.col | col)."""
        from trino_tpu_torch.planner.functions import agg_result_type

        def var_and_col(arg):
            var = None
            if isinstance(arg, ast.Identifier) and len(arg.parts) > 1:
                q = arg.parts[0].lower()
                if q in pvars:
                    var = q
            ir_e = an.analyze(strip(arg))
            if not isinstance(ir_e, SymbolRef):
                raise AnalysisError(
                    "MATCH_RECOGNIZE measures support column navigation, "
                    "CLASSIFIER(), MATCH_NUMBER() and simple aggregates"
                )
            return var, P.Symbol(ir_e.name, ir_e.type)

        if isinstance(e, ast.FunctionCall):
            fn = e.name.lower()
            if fn == "classifier":
                return P.MeasureSpec("classifier"), T.VARCHAR
            if fn == "match_number":
                return P.MeasureSpec("match_number"), T.BIGINT
            if fn in ("first", "last"):
                var, sym = var_and_col(e.args[0])
                off = 0
                if len(e.args) > 1:
                    off = int(e.args[1].text)
                return P.MeasureSpec(fn, var, sym, offset=off), sym.type
            if fn in ("count", "sum", "avg", "min", "max"):
                if fn == "count" and (e.is_star or not e.args):
                    return P.MeasureSpec("agg", None, None, agg="count"), T.BIGINT
                var, sym = var_and_col(e.args[0])
                return (
                    P.MeasureSpec("agg", var, sym, agg=fn),
                    agg_result_type(fn, sym.type),
                )
        if isinstance(e, ast.Identifier):
            var, sym = var_and_col(e)
            return P.MeasureSpec("last", var, sym), sym.type
        raise AnalysisError(
            f"unsupported MATCH_RECOGNIZE measure: {e!r}"
        )

    def plan_unnest(
        self,
        u: ast.Unnest,
        left: RelationPlan,
        outer,
        ctes,
        alias: Optional[str] = None,
        column_aliases: tuple = (),
        keep_left_fields: bool = True,
    ) -> RelationPlan:
        """UNNEST relation, possibly correlated to `left` (the relation that
        precedes it in the FROM list).  Reference:
        sql/planner/QueryPlanner.java's planCrossJoinUnnest."""
        scope = left.scope(outer)
        an = ExprAnalyzer(scope)
        unnest = []
        elem_fields = []
        for i, e in enumerate(u.exprs):
            expr = an.analyze(e)
            if not isinstance(expr.type, T.ArrayType):
                raise AnalysisError(
                    f"UNNEST argument must be an array, got {expr.type.name}"
                )
            name = (
                column_aliases[i]
                if i < len(column_aliases)
                else _name_hint(e)
            )
            sym = self.alloc.new(name, expr.type.element)
            unnest.append((sym, expr))
            elem_fields.append(Field(name, sym, alias))
        ord_sym = None
        if u.with_ordinality:
            oname = (
                column_aliases[len(u.exprs)]
                if len(column_aliases) > len(u.exprs)
                else "ordinality"
            )
            ord_sym = self.alloc.new(oname, T.BIGINT)
            elem_fields.append(Field(oname, ord_sym, alias))
        node = P.UnnestNode(left.node, unnest, ord_sym)
        fields = (list(left.fields) if keep_left_fields else []) + elem_fields
        return RelationPlan(node, fields)

    def resolve_table_name(self, parts: tuple) -> tuple:
        """Name parts -> (catalog, schema, table) with session defaults."""
        if len(parts) == 3:
            return tuple(parts)
        if len(parts) == 2:
            return (self.session.catalog,) + tuple(parts)
        return (self.session.catalog, self.session.schema, parts[0])

    def plan_table_scan(self, ref: ast.TableRef) -> RelationPlan:
        parts = ref.name
        catalog, schema, table = self.resolve_table_name(parts)
        if catalog is None or schema is None:
            raise AnalysisError(f"table {'.'.join(parts)}: no current catalog/schema")
        conn = self.catalogs.get(catalog)
        meta = conn.metadata().table_metadata(schema, table)
        handle = TableHandle(catalog, schema, table)
        assignments = []
        fields = []
        for cm in meta.columns:
            sym = self.alloc.new(cm.name, cm.type)
            assignments.append((sym, cm.name))
            fields.append(Field(cm.name, sym, table))
        return RelationPlan(P.TableScanNode(handle, meta, assignments), fields)

    def plan_join(self, j: ast.Join, outer, ctes) -> RelationPlan:
        left = self.plan_relation(j.left, outer, ctes)
        # CROSS JOIN UNNEST(expr-over-left) — correlated array expansion
        inner_rel, u_alias, u_cols = j.right, None, ()
        if isinstance(inner_rel, ast.AliasedRelation):
            u_alias, u_cols = inner_rel.alias, inner_rel.column_aliases
            inner_rel = inner_rel.relation
        if isinstance(inner_rel, ast.Unnest):
            if j.kind not in ("cross", "inner") or j.on is not None or j.using:
                raise AnalysisError(
                    f"{j.kind.upper()} JOIN UNNEST with condition not supported"
                )
            return self.plan_unnest(
                inner_rel, left, outer, ctes,
                alias=u_alias, column_aliases=u_cols,
            )
        if isinstance(inner_rel, ast.SubqueryRelation) and inner_rel.lateral:
            if j.kind in ("cross", "inner") and j.on is None and not j.using:
                return self.plan_lateral(
                    left, inner_rel.query, outer, ctes,
                    alias=u_alias, column_aliases=u_cols,
                )
            # LEFT JOIN LATERAL ... ON cond: fall through to ordinary join
            # planning (works when the subquery is uncorrelated; correlated
            # references fail with column-not-found like before)
        right = self.plan_relation(j.right, outer, ctes)
        fields = left.fields + right.fields
        if j.kind == "cross":
            node = P.JoinNode("cross", left.node, right.node, [])
            return RelationPlan(node, fields)
        criteria = []
        residual: list[Expr] = []
        scope = Scope(fields, outer)
        left_syms = {f.symbol.name for f in left.fields}
        right_syms = {f.symbol.name for f in right.fields}
        conjuncts: list[ast.Node] = []
        if j.on is not None:
            conjuncts = split_conjuncts(j.on)
        for name in j.using:
            lsym = Scope(left.fields).resolve((name,))[0]
            rsym = Scope(right.fields).resolve((name,))[0]
            criteria.append((lsym, rsym))
        an = ExprAnalyzer(scope)
        for c in conjuncts:
            e = an.analyze(c)
            pair = _as_equi_pair(e, left_syms, right_syms)
            if pair is not None:
                criteria.append(pair)
            else:
                residual.append(e)
        if not criteria and j.kind in ("left", "right", "full"):
            raise AnalysisError(
                f"{j.kind.upper()} JOIN requires an equi-join condition"
            )
        node = P.JoinNode(
            j.kind, left.node, right.node, criteria,
            ir.and_(*residual) if residual else None,
        )
        return RelationPlan(node, fields)

    def plan_lateral(
        self, left, q: ast.Query, outer, ctes, alias=None, column_aliases=()
    ) -> RelationPlan:
        """LATERAL (subquery referencing left-relation columns) — the
        correlated-apply relation (reference: sql/tree/Lateral.java +
        the TransformCorrelated* decorrelation rules).  Decorrelates into
        ordinary joins the same way plan_subquery_value does: correlated
        equi-conjuncts become join criteria, aggregates group by them."""
        spec = _subquery_spec(q)
        if spec.distinct:
            raise AnalysisError("LATERAL with SELECT DISTINCT not supported")
        lat_scope = left.scope(outer)

        def _named(i, default):
            return column_aliases[i] if i < len(column_aliases) else default

        # projection-only lateral (no FROM): computed columns over each
        # left row — the common `lateral (select expr as x)` idiom
        if spec.relation is None:
            if spec.group_by or spec.having is not None or spec.where is not None:
                raise AnalysisError(
                    "LATERAL without FROM supports plain SELECT only"
                )
            an = ExprAnalyzer(lat_scope)
            assigns = [(f.symbol, f.symbol.ref()) for f in left.fields]
            new_fields = []
            for i, item in enumerate(spec.items):
                if not isinstance(item, ast.SelectItem):
                    raise AnalysisError(
                        "SELECT * not supported in LATERAL without FROM"
                    )
                e = an.analyze(item.expr)
                name = _named(i, item.alias or _name_hint(item.expr))
                sym = self.alloc.new(name, e.type)
                assigns.append((sym, e))
                new_fields.append(Field(name, sym, alias))
            node = P.ProjectNode(left.node, assigns)
            return RelationPlan(node, left.fields + new_fields)

        agg_calls: list = []
        for item in spec.items:
            if isinstance(item, ast.SelectItem):
                collect_aggregates(item.expr, agg_calls)
        aggregated = bool(agg_calls or spec.group_by or spec.having is not None)

        if q.order_by or q.limit is not None or q.offset is not None:
            # uncorrelated only: plan the whole query (order/limit intact)
            # and cross join; correlated references fail cleanly inside.
            # Silently dropping the ordering/limit is never acceptable.
            if aggregated:
                raise AnalysisError(
                    "LATERAL aggregate with ORDER BY/LIMIT not supported"
                )
            rp, names = self.plan_query(q, outer, ctes)
            fields = [
                Field(_named(i, n), f.symbol, alias)
                for i, (n, f) in enumerate(zip(names, rp.fields))
            ]
            node = P.JoinNode("cross", left.node, rp.node, [])
            return RelationPlan(node, left.fields + fields)

        # plan the lateral FROM, then classify WHERE conjuncts exactly like
        # plan_subquery_value: local filters apply in place, correlated
        # equi-conjuncts become (outer, inner) criteria, the rest residual
        sub = self.plan_relation(spec.relation, lat_scope, ctes)
        sub_scope = sub.scope(lat_scope)
        sub_syms = {f.symbol.name for f in sub.fields}
        crit: list[tuple] = []
        correlated: list[Expr] = []
        if spec.where is not None:
            for c in split_conjuncts(spec.where):
                if _contains_subquery(c):
                    # nested subquery conjunct: applied over the lateral
                    # relation ONLY (outer=None) — a left-column reference
                    # here would otherwise build a filter below the join
                    # over symbols the sub never produces
                    sub = self._apply_where(sub, c, None, ctes)
                    sub_scope = sub.scope(lat_scope)
                    continue
                outer_refs: set = set()
                an = ExprAnalyzer(sub_scope, outer_refs=outer_refs)
                e = an.analyze(c)
                if not outer_refs:
                    sub = RelationPlan(P.FilterNode(sub.node, e), sub.fields)
                    sub_scope = sub.scope(lat_scope)
                    continue
                pair = _as_equi_pair(e, outer_refs, sub_syms)
                if pair is not None:
                    crit.append(pair)
                else:
                    correlated.append(e)

        if aggregated:
            if correlated:
                # residuals reference pre-aggregation inner symbols that the
                # aggregation output no longer exposes
                raise AnalysisError(
                    "correlated LATERAL aggregate supports equi-join "
                    "correlation only"
                )
            inner_keys = [i for _, i in crit]
            spec2 = ast.QuerySpec(
                spec.items, None, None, spec.group_by, spec.having, False
            )
            rp2, names2 = self._plan_aggregation(
                spec2, sub, sub_scope, lat_scope, ctes, extra_keys=inner_keys
            )
            nk = len(inner_keys)
            if crit:
                out_keys = [rp2.fields[i].symbol for i in range(nk)]
                # no GROUP BY: the subquery yields exactly one row per outer
                # row even over an empty group, so unmatched outers survive
                # (LEFT); with a user GROUP BY an empty group yields nothing
                # and the outer row must drop (INNER)
                kind = "inner" if spec.group_by else "left"
                node = P.JoinNode(
                    kind, left.node, rp2.node,
                    [(o, k) for (o, _), k in zip(crit, out_keys)],
                    None,
                )
            else:
                node = P.JoinNode("cross", left.node, rp2.node, [])
            val_fields = [
                Field(_named(i - nk, names2[i]), rp2.fields[i].symbol, alias)
                for i in range(nk, len(rp2.fields))
            ]
            out = RelationPlan(node, left.fields + val_fields)
            if crit and _is_bare_count(spec):
                # count over no matching rows reads NULL off the LEFT JOIN
                # but must be 0 (the classic count bug)
                f0 = val_fields[0]
                fixed = self.alloc.new(f0.name, T.BIGINT)
                assigns = [
                    (f.symbol, f.symbol.ref()) for f in left.fields
                ] + [
                    (
                        fixed,
                        SpecialForm(
                            Form.COALESCE,
                            [f0.symbol.ref(), Literal(0, T.BIGINT)],
                            T.BIGINT,
                        ),
                    )
                ]
                out = RelationPlan(
                    P.ProjectNode(out.node, assigns),
                    left.fields + [Field(f0.name, fixed, alias)],
                )
            return out

        # non-aggregated: correlated equi pairs join, items project over the
        # combined row (they may mix inner and outer columns)
        if crit or correlated:
            node = P.JoinNode(
                "inner", left.node, sub.node, crit,
                ir.and_(*correlated) if correlated else None,
            )
        else:
            node = P.JoinNode("cross", left.node, sub.node, [])
        combined = RelationPlan(node, left.fields + sub.fields)
        an = ExprAnalyzer(combined.scope(outer))
        assigns = [(f.symbol, f.symbol.ref()) for f in left.fields]
        new_fields = []
        i = 0
        for item in spec.items:
            if isinstance(item, ast.Star):
                for f in sub.fields:
                    if item.qualifier and f.alias != item.qualifier[-1]:
                        continue  # t.* expands t's columns only
                    assigns.append((f.symbol, f.symbol.ref()))
                    new_fields.append(Field(_named(i, f.name), f.symbol, alias))
                    i += 1
                continue
            e = an.analyze(item.expr)
            name = _named(i, item.alias or _name_hint(item.expr))
            sym = self.alloc.new(name, e.type)
            assigns.append((sym, e))
            new_fields.append(Field(name, sym, alias))
            i += 1
        return RelationPlan(
            P.ProjectNode(combined.node, assigns), left.fields + new_fields
        )

    # -- SELECT core ---------------------------------------------------------

    def plan_query_spec(self, spec: ast.QuerySpec, outer, ctes):
        # FROM
        if spec.relation is not None:
            rp = self.plan_relation(spec.relation, outer, ctes)
        else:
            rp = RelationPlan(P.ValuesNode([], [[]]), [])
        source_scope = rp.scope(outer)

        # WHERE (with subquery grafting)
        if spec.where is not None:
            rp = self._apply_where(rp, spec.where, outer, ctes)
            source_scope = rp.scope(outer)

        # aggregation?
        agg_calls: list[ast.FunctionCall] = []
        for item in spec.items:
            if isinstance(item, ast.SelectItem):
                collect_aggregates(item.expr, agg_calls)
        if spec.having is not None:
            collect_aggregates(spec.having, agg_calls)
        has_agg = bool(spec.group_by) or bool(agg_calls)

        names: list[str] = []
        if has_agg:
            rp, names = self._plan_aggregation(spec, rp, source_scope, outer, ctes)
        else:
            src_fields = rp.fields
            rp, names = self._plan_select_items(spec, rp, source_scope, outer, ctes)
            if not spec.distinct:
                # ORDER BY may reference source columns that are not output
                # items; DISTINCT forbids that (post-dedupe rows have no
                # source row identity)
                rp.source_fields = src_fields

        if spec.distinct:
            rp = RelationPlan(
                P.AggregationNode(rp.node, [f.symbol for f in rp.fields], []),
                rp.fields,
            )
        return rp, names

    def _plan_select_items(self, spec, rp, scope, outer, ctes):
        assignments = []
        fields = []
        names = []
        graft = _SubqueryGrafter(self, rp, outer, ctes)
        windows = _WindowExtractor(self, scope)
        an = ExprAnalyzer(scope, on_subquery=graft, hook=windows.hook)
        for item in spec.items:
            if isinstance(item, ast.Star):
                for f in rp.fields:
                    if item.qualifier and f.alias != item.qualifier[-1]:
                        continue
                    assignments.append((f.symbol, f.symbol.ref()))
                    fields.append(Field(f.name, f.symbol))
                    names.append(f.name)
                continue
            e = an.analyze(item.expr)
            name = item.alias or _name_hint(item.expr)
            sym = self.alloc.new(name, e.type)
            assignments.append((sym, e))
            fields.append(
                Field(
                    name if item.alias else sym.name,
                    sym,
                    _source_alias(item),
                    _source_column(item),
                    item.expr,
                )
            )
            names.append(name)
        rp = graft.plan  # subqueries may have grown the source plan
        node = windows.attach(rp.node, rp.fields)
        node = P.ProjectNode(node, assignments)
        return RelationPlan(node, fields), names

    @staticmethod
    def _expand_grouping_sets(group_by):
        """Normalize GROUP BY elements into explicit grouping sets
        (reference: QueryPlanner.planGroupingSets / Analyzer grouping-set
        cross product).  Returns None for a plain single-set GROUP BY, else
        the list of sets as tuples of AST exprs (cross product across
        elements, per the SQL spec)."""
        import itertools

        if not any(isinstance(g, ast.GroupingElement) for g in group_by):
            return None
        per_element = []
        for g in group_by:
            if not isinstance(g, ast.GroupingElement):
                per_element.append([(g,)])
            elif g.kind == "rollup":
                per_element.append(
                    [tuple(g.sets[:i]) for i in range(len(g.sets), -1, -1)]
                )
            elif g.kind == "cube":
                exprs = list(g.sets)
                subs = []
                for r in range(len(exprs), -1, -1):
                    subs.extend(itertools.combinations(exprs, r))
                per_element.append([tuple(s) for s in subs])
            else:  # explicit GROUPING SETS
                per_element.append([tuple(s) for s in g.sets])
        return [
            tuple(e for part in combo for e in part)
            for combo in itertools.product(*per_element)
        ]

    def _plan_aggregation(self, spec, rp, source_scope, outer, ctes, extra_keys=()):
        """`extra_keys`: source symbols injected as group keys and kept in the
        output (used by subquery decorrelation)."""
        alloc = self.alloc
        pre_assign: list = []  # [(Symbol, Expr)] inputs to the aggregation
        pre_map: dict = {}  # ir key -> Symbol

        def pre_symbol(e: Expr, hint: str) -> P.Symbol:
            k = e.key()
            if k in pre_map:
                return pre_map[k]
            if isinstance(e, SymbolRef):
                sym = P.Symbol(e.name, e.type)
            else:
                sym = alloc.new(hint, e.type)
            pre_map[k] = sym
            pre_assign.append((sym, e))
            return sym

        graft = _SubqueryGrafter(self, rp, outer, ctes)
        src_an = ExprAnalyzer(source_scope, on_subquery=graft)

        # grouping sets (ROLLUP/CUBE/GROUPING SETS) normalize to an explicit
        # set list; plain GROUP BY keeps gsets=None
        gsets_ast = self._expand_grouping_sets(spec.group_by)

        def _resolve_ordinal(g):
            if isinstance(g, ast.NumberLiteral):
                return spec.items[int(g.text) - 1].expr
            return g

        # group-by expressions (ordinals allowed): the UNION of all keys
        # across sets, in first-appearance order
        group_irs: list[Expr] = []
        group_syms: list[P.Symbol] = []
        group_keys: dict = {}
        for ksym in extra_keys:
            e = ksym.ref()
            if e.key() in group_keys:
                continue
            sym = pre_symbol(e, ksym.name)
            group_syms.append(sym)
            group_keys[e.key()] = sym
        flat_exprs = (
            [g for g in spec.group_by]
            if gsets_ast is None
            else [e for s in gsets_ast for e in s]
        )
        for g in flat_exprs:
            g = _resolve_ordinal(g)
            e = src_an.analyze(g)
            if e.key() in group_keys:
                continue
            sym = pre_symbol(e, _name_hint(g))
            group_irs.append(e)
            group_syms.append(sym)
            group_keys[e.key()] = sym
        # per-set membership by analyzed expr key; decorrelation extra_keys
        # group in EVERY set
        gid_sym = None
        set_keys = None
        if gsets_ast is not None:
            gid_sym = alloc.new("groupid", T.BIGINT)
            extra = {k.ref().key() for k in extra_keys}
            set_keys = [
                extra | {src_an.analyze(_resolve_ordinal(e)).key() for e in s}
                for s in gsets_ast
            ]

        # aggregates discovered lazily while translating post-agg expressions
        aggregations: list = []  # [(Symbol, P.Aggregation)]
        agg_map: dict = {}

        def agg_symbol(fc: ast.FunctionCall) -> P.Symbol:
            filter_ir = None
            filter_key = None
            if fc.filter is not None:
                filter_sym = pre_symbol(
                    src_an.analyze(fc.filter), "agg_filter"
                )
                filter_ir = filter_sym.ref()
                filter_key = filter_ir.key()
            distinct = fc.distinct
            param = None
            fn_args = list(fc.args)
            sql_name = fc.name
            if sql_name == "approx_distinct":
                # reference role: ApproximateCountDistinctAggregation.
                # Global form: real HyperLogLog (bounded, mergeable per-chip
                # registers).  Grouped form: exact DISTINCT count rewrite —
                # per-group register matrices are not materialized.
                fn_args = fn_args[:1]  # drop max-standard-error argument
                if spec.group_by or extra_keys:
                    sql_name, distinct = "count", True
            if fc.is_star and sql_name == "count":
                key = ("count_star", (), False, filter_key)
                fname, arg_syms, arg_t = "count_star", [], None
                arg_irs = []
            else:
                fname = AGG_FUNCS[sql_name]
                if fname == "percentile":
                    if (
                        sql_name == "approx_percentile"
                        and not (spec.group_by or extra_keys)
                    ):
                        # global form: mergeable log-bucket sketch (bounded
                        # state, reference: qdigest); grouped form stays the
                        # exact sort-based percentile
                        fname = "approx_percentile"
                    if len(fn_args) != 2:
                        # weighted / accuracy signatures would silently give
                        # wrong numbers — reject anything but (value, frac)
                        raise AnalysisError(
                            "approx_percentile supports exactly "
                            "(value, percentile)"
                        )
                    p_ir = src_an.analyze(fn_args[-1])
                    from trino_tpu_torch.expr.constant_folding import try_fold

                    p_ir = try_fold(p_ir)
                    if not isinstance(p_ir, Literal):
                        raise AnalysisError(
                            "approx_percentile fraction must be a literal"
                        )
                    param = float(p_ir.value)
                    fn_args = fn_args[:1]
                if fc.within_group and fname not in ("array_agg", "listagg"):
                    raise AnalysisError(
                        f"ORDER BY in arguments is not supported for {fname}"
                    )
                if fname == "array_agg" and fc.within_group:
                    # array_agg(x ORDER BY k): the order key rides as a
                    # second projected argument; param = (asc, nulls_first)
                    if len(fc.within_group) > 1:
                        raise AnalysisError(
                            "array_agg supports a single ORDER BY key"
                        )
                    if distinct:
                        raise AnalysisError(
                            "array_agg does not support DISTINCT with ORDER BY"
                        )
                    order = fc.within_group[0]
                    param = (
                        order.ascending,
                        bool(order.nulls_first)
                        if order.nulls_first is not None
                        else False,
                    )
                    fn_args = fn_args[:1] + [order.expr]
                if fname in ("min_by", "max_by") and len(fn_args) == 3:
                    # N-form: min_by/max_by(value, key, n) returns the array
                    # of values at the n extreme keys (reference:
                    # MinMaxByNAggregation); n folds to the AggSpec param
                    from trino_tpu_torch.expr.constant_folding import try_fold

                    n_ir = try_fold(src_an.analyze(fn_args[2]))
                    if (
                        not isinstance(n_ir, Literal)
                        or not isinstance(n_ir.value, int)
                        or isinstance(n_ir.value, bool)
                        or n_ir.value < 1
                    ):
                        raise AnalysisError(
                            f"{fname} n must be a positive integer literal"
                        )
                    if n_ir.value > 10_000:
                        # dense [groups, n] state; the reference caps n at
                        # 10000 (MinMaxByNAggregation) for the same reason
                        raise AnalysisError(
                            f"{fname} n must not exceed 10000"
                        )
                    param = n_ir.value
                    fn_args = fn_args[:2]
                if fname == "listagg":
                    # listagg(value [, separator]) [WITHIN GROUP (ORDER BY k)]
                    # — separator folds to the AggSpec param; the first order
                    # key rides as a second projected argument
                    sep = ""  # SQL:2016 default: empty separator
                    if len(fn_args) > 1:
                        from trino_tpu_torch.expr.constant_folding import try_fold

                        s_ir = try_fold(src_an.analyze(fn_args[1]))
                        if not isinstance(s_ir, Literal) or not isinstance(
                            s_ir.value, str
                        ):
                            raise AnalysisError(
                                "listagg separator must be a string literal"
                            )
                        sep = s_ir.value
                    if len(fc.within_group) > 1:
                        raise AnalysisError(
                            "listagg supports a single WITHIN GROUP order key"
                        )
                    order = fc.within_group[0] if fc.within_group else None
                    # param carries (separator, ascending, nulls_first)
                    param = (
                        sep,
                        order.ascending if order is not None else True,
                        bool(order.nulls_first) if order is not None and order.nulls_first is not None else False,
                    )
                    fn_args = fn_args[:1] + ([order.expr] if order is not None else [])
                arg_irs = [src_an.analyze(a) for a in fn_args]
                key = (
                    fname,
                    tuple(a.key() for a in arg_irs),
                    distinct,
                    filter_key,
                    param,
                )
                arg_syms = [
                    pre_symbol(a, _name_hint(fn_args[i]))
                    for i, a in enumerate(arg_irs)
                ]
                arg_t = arg_irs[0].type if arg_irs else None
            if key in agg_map:
                return agg_map[key]
            arg_t2 = arg_irs[1].type if len(arg_irs) > 1 else None
            out_t = agg_result_type(fname, arg_t, arg_t2)
            if fname in ("min_by", "max_by") and param is not None:
                out_t = T.ArrayType(arg_t)  # the N-form collects an array
            sym = alloc.new(fc.name, out_t)
            aggregations.append(
                (
                    sym,
                    P.Aggregation(
                        fname,
                        [s.ref() for s in arg_syms],
                        distinct,
                        filter_ir,
                        param,
                    ),
                )
            )
            agg_map[key] = sym
            return sym

        def grouping_ir(node: ast.FunctionCall) -> Expr:
            """GROUPING(e1..em): bitmask of which args are NOT grouped in
            this row's grouping set, decoded from the group-id column
            (reference: sql/analyzer — GroupingOperationRewriter)."""
            if set_keys is None:
                # single grouping set: every argument is grouped
                return Literal(0, T.BIGINT)
            arg_keys = [src_an.analyze(a).key() for a in node.args]
            masks = []
            for sk in set_keys:
                bits = 0
                for j, ak in enumerate(arg_keys):
                    if ak not in sk:
                        bits |= 1 << (len(arg_keys) - 1 - j)
                masks.append(bits)
            if len(set(masks)) == 1:
                return Literal(masks[0], T.BIGINT)
            args: list[Expr] = []
            for k, bits in enumerate(masks[:-1]):
                args.append(
                    ir.comparison("=", gid_sym.ref(), Literal(k, T.BIGINT))
                )
                args.append(Literal(bits, T.BIGINT))
            args.append(Literal(masks[-1], T.BIGINT))
            return SpecialForm(Form.CASE, args, T.BIGINT)

        def post_hook(node: ast.Node, _an) -> Optional[Expr]:
            if isinstance(node, ast.FunctionCall) and node.name == "grouping":
                return grouping_ir(node)
            if (
                isinstance(node, ast.FunctionCall)
                and node.name in REWRITTEN_AGGS
                and node.window is None
            ):
                if node.name == "count_if":
                    # reference: CountIfAggregation = count(*) FILTER (cond)
                    if node.distinct:
                        raise AnalysisError("count_if does not support DISTINCT")
                    cond = node.args[0]
                    if node.filter is not None:
                        cond = ast.BinaryOp("and", cond, node.filter)
                    inner = ast.FunctionCall(
                        "count", (), is_star=True, filter=cond
                    )
                    return agg_symbol(inner).ref()
                # geometric_mean (reference: GeometricMeanAggregations) —
                # exp of the mean of logs; planned as that composition
                inner = ast.FunctionCall(
                    "avg",
                    (ast.FunctionCall("ln", tuple(node.args)),),
                    distinct=node.distinct,
                    filter=node.filter,
                )
                return Call("exp", [agg_symbol(inner).ref()], T.DOUBLE)
            if isinstance(node, ast.FunctionCall) and node.window is None and (
                node.name in AGG_FUNCS or (node.is_star and node.name == "count")
            ):
                return agg_symbol(node).ref()
            # match against group-by expressions.  TypeError covers
            # speculative analysis of expressions containing functions the
            # scalar registry doesn't know (e.g. grouping() nested inside
            # arithmetic — resolved by this hook on recursion, not here).
            try:
                e = src_an.analyze(node)
            except (AnalysisError, TypeError):
                return None
            sym = group_keys.get(e.key())
            if sym is not None:
                return sym.ref()
            if isinstance(node, ast.Identifier):
                raise AnalysisError(
                    f"column {'.'.join(node.parts)} must appear in GROUP BY "
                    "or be used in an aggregate"
                )
            return None

        # translate select items (this fills pre_assign/aggregations)
        post_assignments = []
        post_fields = []
        names = []
        # injected decorrelation keys lead the output so callers can find them
        for ksym in extra_keys:
            gsym = group_keys[ksym.ref().key()]
            post_assignments.append((gsym, gsym.ref()))
            post_fields.append(Field(gsym.name, gsym))
            names.append(gsym.name)
        # windows over the aggregation's output (planWindowFunctions runs
        # after aggregation planning in the reference's QueryPlanner)
        wx = _WindowExtractor(self, source_scope, an_hook=post_hook)

        def item_hook(node: ast.Node, an) -> Optional[Expr]:
            got = wx.hook(node, an)
            if got is not None:
                return got
            return post_hook(node, an)

        for item in spec.items:
            if isinstance(item, ast.Star):
                raise AnalysisError("SELECT * not allowed with GROUP BY")
            post_an = ExprAnalyzer(source_scope, hook=item_hook)
            e = post_an.analyze(item.expr)
            name = item.alias or _name_hint(item.expr)
            sym = alloc.new(name, e.type)
            post_assignments.append((sym, e))
            post_fields.append(
                Field(
                    name if item.alias else sym.name,
                    sym,
                    _source_alias(item),
                    _source_column(item),
                    item.expr,
                )
            )
            names.append(name)

        having_ir = None
        having_subqueries = []
        if spec.having is not None:
            for conj in split_conjuncts(spec.having):
                if _contains_subquery(conj):
                    having_subqueries.append(conj)
                else:
                    post_an = ExprAnalyzer(source_scope, hook=post_hook)
                    e = post_an.analyze(conj)
                    having_ir = ir.and_(having_ir, e) if having_ir is not None else e

        # assemble: graft plan -> pre-project -> aggregate -> having -> project
        src_node = graft.plan.node
        # keep any source symbols referenced by pre_assign
        pre_node = P.ProjectNode(src_node, pre_assign)
        if gsets_ast is None:
            agg_node = P.AggregationNode(pre_node, group_syms, aggregations)
        else:
            # GroupIdNode analog (reference: sql/planner/plan/GroupIdNode
            # .java:40): K-way input duplication — one UNION ALL branch per
            # grouping set, non-member keys nulled, a group-id literal
            # appended — then ONE aggregation over (keys..., groupid).
            # Static-shape friendly: K is a plan constant.
            pre_syms = [s for s, _ in pre_assign]
            sym_to_key = {sym.name: k for k, sym in group_keys.items()}
            agg_syms = [s for s, _ in aggregations]
            # the () grouping set must yield its row even over EMPTY input
            # (a global aggregation's semantics) — it cannot ride the keyed
            # aggregation, which yields no groups for no rows
            empty_idx = {
                k for k, s in enumerate(gsets_ast) if not s and not extra_keys
            }
            # each grouping-set branch owns its OWN instance of the
            # pre-projected input (one shared instance in K tree positions
            # breaks the duplicate-node sanity rule); the first consumer
            # takes the original, later ones take copies
            _pre_used = [False]

            def own_pre():
                if _pre_used[0]:
                    return P.copy_tree(pre_node)
                _pre_used[0] = True
                return pre_node

            branches = []
            branch_syms = []
            for k, sk in enumerate(set_keys):
                if k in empty_idx:
                    continue
                assigns = []
                bsyms = []
                for s in pre_syms:
                    bs = alloc.new(s.name, s.type)
                    if s.name in sym_to_key and sym_to_key[s.name] not in sk:
                        assigns.append((bs, Literal(None, s.type)))
                    else:
                        assigns.append((bs, s.ref()))
                    bsyms.append(bs)
                bgid = alloc.new("groupid", T.BIGINT)
                assigns.append((bgid, Literal(k, T.BIGINT)))
                bsyms.append(bgid)
                branches.append(P.ProjectNode(own_pre(), assigns))
                branch_syms.append(bsyms)
            main = None
            if branches:
                union_node = P.UnionNode(
                    branches, pre_syms + [gid_sym], branch_syms
                )
                main = P.AggregationNode(
                    union_node, group_syms + [gid_sym], aggregations
                )
            pads = []
            for k in sorted(empty_idx):
                gaggs = [
                    (alloc.new(s.name, s.type), spec) for s, spec in aggregations
                ]
                gnode = P.AggregationNode(own_pre(), [], gaggs)
                passigns = []
                psyms = []
                for s in group_syms:
                    ns = alloc.new(s.name, s.type)
                    passigns.append((ns, Literal(None, s.type)))
                    psyms.append(ns)
                ngid = alloc.new("groupid", T.BIGINT)
                passigns.append((ngid, Literal(k, T.BIGINT)))
                psyms.append(ngid)
                for gs, _spec in gaggs:
                    ns = alloc.new(gs.name, gs.type)
                    passigns.append((ns, gs.ref()))
                    psyms.append(ns)
                pads.append((P.ProjectNode(gnode, passigns), psyms))
            canonical = group_syms + [gid_sym] + agg_syms
            if main is not None and not pads:
                agg_node = main
            else:
                sources = ([main] if main is not None else []) + [
                    p for p, _ in pads
                ]
                srcsyms = ([canonical] if main is not None else []) + [
                    ps for _, ps in pads
                ]
                agg_node = P.UnionNode(sources, canonical, srcsyms)
        cur = RelationPlan(
            agg_node,
            [Field(s.name, s) for s in agg_node.outputs],
        )
        if having_ir is not None:
            cur = RelationPlan(P.FilterNode(cur.node, having_ir), cur.fields)
        for conj in having_subqueries:
            cur = self._apply_conjunct_with_subquery(
                cur, conj, outer, ctes,
                analyzer_factory=lambda g: ExprAnalyzer(
                    source_scope, hook=post_hook, on_subquery=g
                ),
            )
        wnode = wx.attach(cur.node, cur.fields)
        node = P.ProjectNode(wnode, post_assignments)
        return RelationPlan(node, post_fields), names

    # -- WHERE + subqueries --------------------------------------------------

    def _apply_where(self, rp, where: ast.Node, outer, ctes) -> RelationPlan:
        # plain conjuncts first: they form the equi-join edges cross-join
        # elimination needs, and a subquery graft applied over the raw comma
        # cross tree would otherwise bury those edges under its own joins
        # (q30-style plans explode into genuine cross products without this)
        plain = []
        with_subquery = []
        for conj in split_conjuncts(where):
            (with_subquery if _contains_subquery(conj) else plain).append(conj)
        for conj in plain:
            an = ExprAnalyzer(rp.scope(outer))
            rp = RelationPlan(P.FilterNode(rp.node, an.analyze(conj)), rp.fields)
        for conj in with_subquery:
            rp = self._apply_conjunct_with_subquery(rp, conj, outer, ctes)
        return rp

    def _apply_conjunct_with_subquery(
        self, rp, conj: ast.Node, outer, ctes, analyzer_factory=None
    ) -> RelationPlan:
        graft = _SubqueryGrafter(self, rp, outer, ctes)
        if analyzer_factory is not None:
            an = analyzer_factory(graft)
        else:
            an = ExprAnalyzer(rp.scope(outer), on_subquery=graft)
        e = an.analyze(conj)
        out = graft.plan
        return RelationPlan(P.FilterNode(out.node, e), out.fields)

    # -- subquery grafting ---------------------------------------------------

    def plan_subquery_value(self, rp, q: ast.Query, outer_scope, ctes, kind: str,
                            negated: bool = False, in_value: Optional[Expr] = None):
        """Attach a subquery to `rp`; returns (new RelationPlan, value Expr).

        kind: 'scalar' | 'exists' | 'in'
        """
        spec = _subquery_spec(q)
        sub_outer = outer_scope  # subquery sees the enclosing row scope
        # plan FROM
        if spec.relation is None:
            raise AnalysisError("subquery without FROM not supported")
        sub = self.plan_relation(spec.relation, sub_outer, ctes)
        # classify conjuncts
        plain: list[ast.Node] = []
        correlated: list[Expr] = []
        crit: list[tuple] = []  # (outer Symbol, inner Symbol)
        sub_scope = sub.scope(sub_outer)
        sub_syms = {f.symbol.name for f in sub.fields}
        if spec.where is not None:
            for c in split_conjuncts(spec.where):
                if _contains_subquery(c):
                    plain.append(c)  # nested subquery: recurse via _apply_where
                    continue
                outer_refs: set = set()
                an = ExprAnalyzer(sub_scope, outer_refs=outer_refs)
                e = an.analyze(c)
                if not outer_refs:
                    sub = RelationPlan(P.FilterNode(sub.node, e), sub.fields)
                    sub_scope = sub.scope(sub_outer)
                    continue
                pair = _as_equi_pair(e, outer_refs, sub_syms)
                if pair is not None:
                    crit.append(pair)
                    continue
                # correlation buried in a disjunction: factor out equi
                # conjuncts common to EVERY disjunct (q41 shape:
                # `(m = i1.m and A) or (m = i1.m and B)` ->
                # crit gets (m, i1.m), predicate becomes `A or B`)
                factored = _factor_common_equi(e, outer_refs, sub_syms)
                if factored is not None:
                    pairs, rest = factored
                    crit.extend(pairs)
                    if rest is not None:
                        rest_refs: set = set()
                        _collect_ref_names(rest, rest_refs)
                        if rest_refs <= sub_syms:
                            sub = RelationPlan(
                                P.FilterNode(sub.node, rest), sub.fields
                            )
                            sub_scope = sub.scope(sub_outer)
                        else:
                            correlated.append(rest)
                    continue
                correlated.append(e)
        for c in plain:
            sub = self._apply_where(sub, c, sub_outer, ctes)
        # ---- EXISTS / IN ----------------------------------------------------
        if kind == "exists":
            mark = self.alloc.new("exists", T.BOOLEAN)
            if not crit and not correlated:
                # uncorrelated EXISTS: one global count over the subquery,
                # cross-joined (reference: TransformUncorrelatedSubqueryToJoin)
                cnt = self.alloc.new("cnt", T.BIGINT)
                agg = P.AggregationNode(
                    sub.node, [], [(cnt, P.Aggregation("count_star", []))]
                )
                node = P.JoinNode("cross", rp.node, agg, [])
                out = RelationPlan(node, rp.fields + [Field(cnt.name, cnt)])
                val = ir.comparison(">", cnt.ref(), Literal(0, T.BIGINT))
                return out, (ir.not_(val) if negated else val)
            if not crit:
                raise AnalysisError(
                    "correlated EXISTS without an equi-join predicate "
                    "not supported yet"
                )
            (osym, isym), extra = crit[0], crit[1:]
            filt = None
            parts = correlated + [
                ir.comparison("=", o.ref(), i.ref()) for o, i in extra
            ]
            if parts:
                filt = ir.and_(*parts)
            node = P.SemiJoinNode(
                rp.node, sub.node, osym, isym, mark, filt, null_aware=False
            )
            out = RelationPlan(node, rp.fields + [Field(mark.name, mark)])
            val = mark.ref()
            return out, (ir.not_(val) if negated else val)
        if kind == "in":
            # value IN (select col ...): inner value column from select items
            sub_proj, names = self._plan_select_items(spec, sub, sub_scope, sub_outer, ctes)
            if len(sub_proj.fields) != 1:
                raise AnalysisError("IN subquery must return one column")
            item_aggs: list = []
            if spec.items and isinstance(spec.items[0], ast.SelectItem):
                collect_aggregates(spec.items[0].expr, item_aggs)
            if spec.group_by or item_aggs or spec.having is not None:
                # grouped IN subquery (Q18): plan fully then semi join
                sub_full, _ = self.plan_query_spec(spec, sub_outer, ctes)
                inner_sym = sub_full.fields[0].symbol
                sub_node = sub_full.node
            elif crit or correlated:
                # correlated IN: keep the correlation's inner symbols in the
                # filtering side so the semi join's filter can see them
                item = spec.items[0]
                if len(spec.items) != 1 or not isinstance(item, ast.SelectItem):
                    raise AnalysisError("IN subquery must return one column")
                val_e = ExprAnalyzer(sub_scope).analyze(item.expr)
                if isinstance(val_e, SymbolRef):
                    inner_sym = P.Symbol(val_e.name, val_e.type)
                else:
                    inner_sym = self.alloc.new("in_inner", val_e.type)
                needed: dict = {}
                for _, isym in crit:
                    needed[isym.name] = isym
                corr_names: set = set()
                for e in correlated:
                    _collect_ref_names(e, corr_names)
                for f in sub.fields:
                    if f.symbol.name in corr_names:
                        needed.setdefault(f.symbol.name, f.symbol)
                assigns = [(inner_sym, val_e)] + [
                    (sym, sym.ref())
                    for name, sym in needed.items()
                    if name != inner_sym.name
                ]
                sub_node = P.ProjectNode(sub.node, assigns)
            else:
                inner_sym = sub_proj.fields[0].symbol
                sub_node = sub_proj.node
            mark = self.alloc.new("in_mark", T.BOOLEAN)
            if (crit or correlated) and (
                spec.group_by or item_aggs or spec.having is not None
            ):
                raise AnalysisError(
                    "correlated grouped IN subquery not supported yet"
                )
            assert in_value is not None
            if isinstance(in_value, SymbolRef):
                src_sym = P.Symbol(in_value.name, in_value.type)
                src_node = rp.node
                out_fields = rp.fields
            else:
                src_sym = self.alloc.new("in_value", in_value.type)
                src_node = P.ProjectNode(
                    rp.node,
                    [(f.symbol, f.symbol.ref()) for f in rp.fields]
                    + [(src_sym, in_value)],
                )
                out_fields = rp.fields + [Field(src_sym.name, src_sym)]
            # correlated IN: the correlation predicates become the semi
            # join's extra filter over (source ++ filtering) symbols
            # (reference: TransformCorrelatedInPredicateToJoin)
            filt = None
            parts = correlated + [
                ir.comparison("=", o.ref(), i.ref()) for o, i in crit
            ]
            if parts:
                filt = ir.and_(*parts)
            node = P.SemiJoinNode(
                src_node, sub_node, src_sym, inner_sym, mark, filt
            )
            out = RelationPlan(node, out_fields + [Field(mark.name, mark)])
            val = mark.ref()
            return out, (ir.not_(val) if negated else val)
        # ---- scalar ---------------------------------------------------------
        assert kind == "scalar"
        agg_calls: list = []
        for item in spec.items:
            if isinstance(item, ast.SelectItem):
                collect_aggregates(item.expr, agg_calls)
        if not agg_calls and not spec.group_by:
            # non-aggregated scalar subquery: single row enforced
            if crit or correlated:
                raise AnalysisError(
                    "correlated non-aggregated scalar subquery not supported"
                )
            sub_proj, _ = self._plan_select_items(spec, sub, sub_scope, sub_outer, ctes)
            sub_node = sub_proj.node
            if spec.distinct:
                # SELECT DISTINCT x: dedupe before the single-row check
                sub_node = P.AggregationNode(
                    sub_node, [f.symbol for f in sub_proj.fields], []
                )
            single = P.EnforceSingleRowNode(sub_node)
            node = P.JoinNode("cross", rp.node, single, [])
            out = RelationPlan(node, rp.fields + sub_proj.fields)
            return out, sub_proj.fields[0].symbol.ref()
        # aggregated scalar subquery: group by correlation keys, LEFT JOIN
        inner_keys = [i for _, i in crit]
        spec2 = ast.QuerySpec(
            spec.items, None, None, spec.group_by, spec.having, False
        )
        rp2, names2 = self._plan_aggregation(
            spec2, sub, sub_scope, sub_outer, ctes, extra_keys=inner_keys
        )
        if crit:
            # join against the *output* key symbols of the grouped subquery
            out_keys = [rp2.fields[i].symbol for i in range(len(inner_keys))]
            node = P.JoinNode(
                "left",
                rp.node,
                rp2.node,
                [(o, k) for (o, _), k in zip(crit, out_keys)],
                ir.and_(*correlated) if correlated else None,
            )
            out = RelationPlan(node, rp.fields + rp2.fields)
            value_sym = rp2.fields[len(inner_keys)].symbol
            val: Expr = value_sym.ref()
            # count over no matching rows must be 0, but the LEFT JOIN yields
            # NULL for unmatched outer rows — coalesce when the subquery's
            # value is exactly a count aggregate (the classic count bug)
            if _is_bare_count(spec):
                val = SpecialForm(
                    Form.COALESCE, [val, Literal(0, T.BIGINT)], T.BIGINT
                )
            return out, val
        # uncorrelated aggregated scalar: global agg -> single row cross join
        if correlated:
            # refusing is mandatory: a dropped correlation silently counts
            # the WHOLE inner relation per outer row (wrong results)
            raise AnalysisError(
                "correlated aggregated scalar subquery without an equi-join "
                "predicate not supported"
            )
        node = P.JoinNode("cross", rp.node, rp2.node, [])
        out = RelationPlan(node, rp.fields + rp2.fields)
        return out, rp2.fields[0].symbol.ref()


def _collect_ref_names(e: Expr, out: set) -> None:
    """Names of every SymbolRef inside `e`."""
    from trino_tpu_torch.expr.ir import visit

    def fn(x):
        if isinstance(x, SymbolRef):
            out.add(x.name)
        return x

    visit(e, fn)


def _is_bare_count(spec: ast.QuerySpec) -> bool:
    if len(spec.items) != 1 or not isinstance(spec.items[0], ast.SelectItem):
        return False
    e = spec.items[0].expr
    return isinstance(e, ast.FunctionCall) and e.name == "count"


def _subquery_spec(q: ast.Query) -> ast.QuerySpec:
    body = q.body
    if isinstance(body, ast.QuerySpec):
        return body
    raise AnalysisError("unsupported subquery shape")


#: window functions and their result-type rules (reference: the
#: operator/window/* function registry)
_WINDOW_RANK = {"row_number", "rank", "dense_rank", "ntile"}
_WINDOW_DOUBLE = {"percent_rank", "cume_dist"}
_WINDOW_VALUE = {"lag", "lead", "first_value", "last_value", "nth_value"}


class _WindowExtractor:
    """Collects OVER() calls during select-item translation and attaches a
    WindowNode below the final projection (reference role: the window planning
    in QueryPlanner.planWindowFunctions)."""

    def __init__(self, planner: "LogicalPlanner", scope: Scope, an_hook=None):
        self.planner = planner
        self.scope = scope
        #: analyzer hook for window args/partition/order — the aggregation
        #: planner passes its post-agg translation hook so windows OVER
        #: aggregates (`sum(sum(x)) over (partition by k)`, the reference's
        #: planWindowFunctions-after-aggregation ordering) resolve inner
        #: aggregates and group keys to their computed symbols
        self.an_hook = an_hook
        self.pre_assign: list = []  # [(Symbol, Expr)] computed inputs
        self.pre_map: dict = {}
        self.functions: list = []  # [(out Symbol, partition syms, order, fn)]

    def hook(self, node: ast.Node, _an) -> Optional[Expr]:
        if not (isinstance(node, ast.FunctionCall) and node.window is not None):
            return None
        return self._plan_call(node).ref()

    def _pre_symbol(self, e: Expr, hint: str) -> P.Symbol:
        k = e.key()
        if k in self.pre_map:
            return self.pre_map[k]
        if isinstance(e, SymbolRef):
            sym = P.Symbol(e.name, e.type)
        else:
            sym = self.planner.alloc.new(hint, e.type)
        self.pre_map[k] = sym
        self.pre_assign.append((sym, e))
        return sym

    def _plan_call(self, fc: ast.FunctionCall) -> P.Symbol:
        an = ExprAnalyzer(self.scope, hook=self.an_hook)
        w = fc.window
        if getattr(w, "ref", None) is not None:
            raise AnalysisError(f"window '{w.ref}' is not defined")
        if fc.ignore_nulls and fc.name not in (
            "lag", "lead", "first_value", "last_value", "nth_value"
        ):
            raise AnalysisError(
                f"IGNORE NULLS is not valid for {fc.name}"
            )
        part = [
            self._pre_symbol(an.analyze(p), _name_hint(p)) for p in w.partition_by
        ]
        order = []
        for si in w.order_by:
            e = an.analyze(si.expr)
            nf = si.nulls_first
            if nf is None:
                nf = not si.ascending  # NULLS LAST asc / FIRST desc default
            order.append(
                (self._pre_symbol(e, _name_hint(si.expr)), si.ascending, nf)
            )
        name = fc.name
        arg_syms: list = []
        offset, n_buckets, default_sym = 1, 1, None
        if name in _WINDOW_RANK or name in _WINDOW_DOUBLE:
            if name == "ntile":
                lit = an.analyze(fc.args[0])
                if not isinstance(lit, Literal):
                    raise AnalysisError("ntile bucket count must be a literal")
                n_buckets = int(lit.value)
            out_t = T.DOUBLE if name in _WINDOW_DOUBLE else T.BIGINT
        elif name in _WINDOW_VALUE:
            if name == "nth_value" and len(fc.args) != 2:
                raise AnalysisError("nth_value requires (value, n)")
            if not fc.args:
                raise AnalysisError(f"{name} requires an argument")
            arg = an.analyze(fc.args[0])
            arg_syms = [self._pre_symbol(arg, _name_hint(fc.args[0]))]
            out_t = arg.type
            if name in ("lag", "lead"):
                if len(fc.args) > 1:
                    off = an.analyze(fc.args[1])
                    if not isinstance(off, Literal):
                        raise AnalysisError("lag/lead offset must be a literal")
                    offset = int(off.value)
                if len(fc.args) > 2:
                    default_sym = self._pre_symbol(
                        an.analyze(fc.args[2]), "default"
                    )
            if name == "nth_value":
                off = an.analyze(fc.args[1])
                if not isinstance(off, Literal) or not isinstance(
                    off.value, int
                ):
                    raise AnalysisError(
                        "nth_value n must be an integer literal"
                    )
                offset = off.value
                if offset < 1:
                    raise AnalysisError("nth_value n must be positive")
        elif name in AGG_FUNCS or (fc.is_star and name == "count"):
            if fc.distinct:
                raise AnalysisError(
                    "DISTINCT aggregates are not supported as window functions"
                )
            if fc.is_star:
                name, out_t = "count_star", T.BIGINT
            else:
                if AGG_FUNCS.get(name) not in (
                    "count", "sum", "avg", "min", "max",
                ) or name == "approx_distinct":
                    raise AnalysisError(
                        f"{name} is not supported as a window function"
                    )
                arg = an.analyze(fc.args[0])
                arg_syms = [self._pre_symbol(arg, _name_hint(fc.args[0]))]
                out_t = agg_result_type(AGG_FUNCS[name], arg.type)
                name = AGG_FUNCS[name]
        else:
            raise AnalysisError(f"unknown window function {name}")
        frame, start_off, end_off = _resolve_frame(w.frame, bool(order))
        fn = P.WindowFunction(
            name,
            [s.ref() for s in arg_syms],
            frame=frame,
            offset=offset,
            n_buckets_expr=n_buckets,
            default=None if default_sym is None else default_sym.ref(),
            start_off=start_off,
            end_off=end_off,
            ignore_nulls=fc.ignore_nulls,
        )
        out = self.planner.alloc.new(fc.name, out_t)
        self.functions.append((out, part, order, fn))
        return out

    def attach(self, node: P.PlanNode, fields) -> P.PlanNode:
        if not self.functions:
            return node
        # pre-project: every source field plus computed window inputs
        seen = {f.symbol.name for f in fields}
        assigns = [(f.symbol, f.symbol.ref()) for f in fields]
        for sym, e in self.pre_assign:
            if sym.name not in seen:
                assigns.append((sym, e))
                seen.add(sym.name)
        node = P.ProjectNode(node, assigns)
        # one WindowNode per distinct (partition, order) spec
        by_spec: dict = {}
        for out, part, order, fn in self.functions:
            key = (
                tuple(s.name for s in part),
                tuple((s.name, a, nf) for s, a, nf in order),
            )
            by_spec.setdefault(key, (part, order, []))[2].append((out, fn))
        for part, order, fns in by_spec.values():
            node = P.WindowNode(node, part, order, fns)
        return node


class _SubqueryGrafter:
    """on_subquery callback: plans subquery expressions against the current
    relation plan, growing it via joins (SubqueryPlanner's apply mechanism)."""

    def __init__(self, planner: LogicalPlanner, rp: RelationPlan, outer, ctes):
        self.planner = planner
        self.plan = rp
        self.outer = outer
        self.ctes = ctes

    def __call__(self, node: ast.Node, an: ExprAnalyzer) -> Expr:
        scope = self.plan.scope(self.outer)
        if isinstance(node, ast.Exists):
            self.plan, val = self.planner.plan_subquery_value(
                self.plan, node.query, scope, self.ctes, "exists", node.negated
            )
            return val
        if isinstance(node, ast.InSubquery):
            value_ir = ExprAnalyzer(scope).analyze(node.value)
            self.plan, val = self.planner.plan_subquery_value(
                self.plan, node.query, scope, self.ctes, "in", node.negated,
                in_value=value_ir,
            )
            return val
        if isinstance(node, ast.ScalarSubquery):
            self.plan, val = self.planner.plan_subquery_value(
                self.plan, node.query, scope, self.ctes, "scalar"
            )
            return val
        raise AnalysisError(f"unsupported subquery node {type(node).__name__}")


def _contains_subquery(node: ast.Node) -> bool:
    if isinstance(node, (ast.Exists, ast.InSubquery, ast.ScalarSubquery,
                         ast.QuantifiedComparison)):
        return True
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, ast.Query):
            continue
        if isinstance(v, ast.Node) and _contains_subquery(v):
            return True
        if isinstance(v, tuple):
            for item in v:
                if isinstance(item, ast.Node) and _contains_subquery(item):
                    return True
                if isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, ast.Node) and _contains_subquery(sub):
                            return True
    return False


def _factor_common_equi(e: Expr, outer_refs, sub_syms):
    """If `e` is a disjunction whose EVERY disjunct conjoins the same
    outer=inner equality, hoist those equalities out:
    `(k = o and A) or (k = o and B)` == `k = o and (A or B)`.
    Returns (pairs, rest Expr or None), or None when not factorable."""
    if not (isinstance(e, SpecialForm) and e.form == Form.OR):
        return None
    disjuncts = [split_ir_conjuncts(d) for d in e.args]
    first_keys = {c.key(): c for c in disjuncts[0]}
    common = []
    for k, c in first_keys.items():
        if all(any(x.key() == k for x in d) for d in disjuncts[1:]):
            pair = _as_equi_pair(c, outer_refs, sub_syms)
            if pair is not None:
                common.append((k, pair))
    if not common:
        return None
    common_keys = {k for k, _ in common}
    rests = []
    for d in disjuncts:
        kept = [c for c in d if c.key() not in common_keys]
        rests.append(ir.and_(*kept) if kept else Literal(True, T.BOOLEAN))
    if any(isinstance(x, Literal) and x.value is True for x in rests):
        rest = None  # some disjunct was ONLY the equalities: rest is TRUE
    else:
        rest = ir.or_(*rests)
    return [p for _, p in common], rest


def split_ir_conjuncts(e: Expr) -> list:
    if isinstance(e, SpecialForm) and e.form == Form.AND:
        out = []
        for a in e.args:
            out.extend(split_ir_conjuncts(a))
        return out
    return [e]


def _as_equi_pair(e: Expr, left_names, right_names):
    """If e is `lsym = rsym` with sides in the two given name sets, return the
    (left Symbol, right Symbol) pair (swapping as needed)."""
    if not (isinstance(e, Call) and e.name == "$eq"):
        return None
    a, b = e.args
    if not (isinstance(a, SymbolRef) and isinstance(b, SymbolRef)):
        return None
    if a.name in left_names and b.name in right_names:
        return (P.Symbol(a.name, a.type), P.Symbol(b.name, b.type))
    if b.name in left_names and a.name in right_names:
        return (P.Symbol(b.name, b.type), P.Symbol(a.name, a.type))
    return None


def _source_column(item) -> Optional[str]:
    """Column part of a plain `t.col` select item."""
    e = item.expr
    if isinstance(e, ast.Identifier) and len(e.parts) >= 2:
        return e.parts[-1]
    return None


def _source_alias(item) -> Optional[str]:
    """Qualifier of a plain `t.col` select item, kept on the output Field so
    ORDER BY `t.col` can re-match it after projection (also when the item is
    renamed: `SELECT t.col AS x ... ORDER BY t.col` is valid SQL)."""
    e = item.expr
    if isinstance(e, ast.Identifier) and len(e.parts) >= 2:
        return e.parts[-2]
    return None


def _name_hint(e: ast.Node) -> str:
    if isinstance(e, ast.Identifier):
        return e.parts[-1]
    if isinstance(e, ast.FunctionCall):
        return e.name
    return "expr"


def _frame_offset(bound: ast.FrameBound) -> Optional[int]:
    """Literal row offset relative to the current row (None = unbounded)."""
    if bound.kind in ("unbounded_preceding", "unbounded_following"):
        return None
    if bound.kind == "current":
        return 0
    if not isinstance(bound.value, ast.NumberLiteral):
        raise AnalysisError("window frame offset must be an integer literal")
    try:
        k = int(bound.value.text)
    except ValueError:
        raise AnalysisError("window frame offset must be an integer literal")
    if k < 0:
        raise AnalysisError("window frame offset must be non-negative")
    return -k if bound.kind == "preceding" else k


def _resolve_frame(wf, has_order: bool):
    """AST WindowFrame → (frame kind, start_off, end_off) for the executor.

    Reference: operator/window/FrameInfo.java + sql/analyzer checks in
    StatementAnalyzer.analyzeWindowFrame.  Unsupported frame shapes raise
    AnalysisError — a frame clause is never silently dropped.
    """
    if wf is None:
        return ("range" if has_order else "full"), None, 0
    s, e = wf.start.kind, wf.end.kind
    if s == "unbounded_following" or e == "unbounded_preceding":
        raise AnalysisError(f"invalid window frame {wf.kind} {s}..{e}")
    if s == "unbounded_preceding" and e == "unbounded_following":
        return "full", None, None
    if not has_order:
        if wf.kind in ("range", "groups") and s == "unbounded_preceding" and e == "current":
            # without ORDER BY all rows are peers: the running frame IS the
            # whole partition
            return "full", None, 0
        raise AnalysisError(
            "window frame requires ORDER BY in the window specification"
        )
    if wf.kind == "rows":
        start_off, end_off = _frame_offset(wf.start), _frame_offset(wf.end)
        if (
            start_off is not None
            and end_off is not None
            and start_off > end_off
        ):
            raise AnalysisError("window frame start is after frame end")
        return "rows", start_off, end_off
    # range/groups: only the frames equivalent to the running default are
    # computable on the peer-group machinery
    if s == "unbounded_preceding" and e == "current":
        return "range", None, 0
    raise AnalysisError(
        f"unsupported window frame {wf.kind} {s}..{e}"
    )

"""In-process query runner: SQL text -> materialized results.

Port of trino_tpu/runtime/runner.py (reference role:
testing/LocalQueryRunner.java:260): parse -> analyze -> plan -> optimize
on the host, then the local execution planner's operators on one device.

Statements: SELECT (WITH RECURSIVE expands to a fixpoint of VALUES
relations on the host), USE, SET SESSION; START TRANSACTION / COMMIT /
ROLLBACK (snapshots of the written tables, runtime/transactions.py);
CREATE TABLE, CREATE TABLE AS, INSERT, DELETE, UPDATE, MERGE, ALTER TABLE
and DROP TABLE over write-capable connectors (memory, blackhole); CREATE
and DROP VIEW; PREPARE, EXECUTE, DESCRIBE INPUT/OUTPUT and DEALLOCATE;
SHOW and DESCRIBE; EXPLAIN, EXPLAIN (TYPE DISTRIBUTED) and EXPLAIN ANALYZE
(runtime/query_stats.py).  A write runs its query, brings the rows to the
host (`_collect_rows`), builds host columns (`_write_rows`:
`column_from_values` on the CPU) and appends them through the connector's
sink; DELETE, UPDATE and MERGE rewrite the whole table from a pre-image
that is restored if the write fails.  `last_writes` records the host
seconds of each of the last statement's writes in their three parts.

CREATE TABLE and CTAS WITH (bucketed_by, bucket_count) declare a
hash-bucketed layout (partitioning/layout.py): a connector that stores
one (memory: it rolls back with the table) owns it, otherwise it goes to
the process registry, which DROP TABLE clears; the mesh scans such a
table co-located on its bucket columns.

Security (server/security.py): each statement runs as `user` under
`access_control` (allow-all by default): `check_can_execute_query` before
it parses, `check_can_select` for every table the local plan scans
(`_check_table_access`; the mesh runner's `_run_query` does not call it,
as in the JAX package), and the write, delete and update checks at every
write site.  CREATE TABLE, CTAS and a rename record the user as owner in
`grants`, the SQL-standard store that GRANT, REVOKE, CREATE/DROP ROLE and
SHOW ROLES/GRANTS read and write.

Each statement runs under a QueryContext (runtime/lifecycle.py) made by
the runner's QueryTracker: its state machine, its deadlines
(query_max_run_time, query_max_planning_time), its cancel token
(`query_tracker.cancel(query_id)`), and its memory on the shared pool.
The statement emits created and completed events (runtime/events.py;
system.runtime.queries reads them), bumps the registry's counters, and,
under `query_trace`, records a span tree (telemetry/spans.py: query ->
analyze, optimize, execute) that EXPLAIN ANALYZE VERBOSE renders and
system.runtime.spans lists.  Each statement also gets a plan-decision
ledger (telemetry/decisions.py), finalized with hindsight verdicts when
it ends; with a profile store attached (`profile_store`,
telemetry/profile_store.py) its profile artifact is assembled on the
statement thread and written by the store's writer thread.
`retry_policy = 'QUERY'` re-runs a statement
that failed with a retryable error (runtime/retry.py).  When the
statement ends, success or failure, its spill stores are closed (their
files deleted) and its reservations released, even when a wave generator
was abandoned mid-stream.  The runner registers the `system` catalog
(connectors/system.py), and `clone_for_dispatch` makes the engine lanes
of runtime/dispatcher.py.

The device is the CUDA card unless the caller passes another one
(`device="cpu"`); there is no fallback (see device.py).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Optional

import torch

from trino_tpu_torch.connectors.api import CatalogManager, default_catalogs
from trino_tpu_torch.device import resolve_device
from trino_tpu_torch.planner.logical_planner import LogicalPlanner, Session
from trino_tpu_torch.planner.plan import OutputNode, plan_text
from trino_tpu_torch.runtime.local_planner import LocalExecutionPlanner
from trino_tpu_torch.sql import ast
from trino_tpu_torch.sql.parser import parse_statement


#: statement ids of this process
_QUERY_IDS = itertools.count()


@dataclass
class MaterializedResult:
    """Reference role: testing/MaterializedResult.java."""

    column_names: list
    rows: list  # list of tuples of python values
    types: list

    @property
    def row_count(self) -> int:
        return len(self.rows)

    def only_value(self):
        assert len(self.rows) == 1 and len(self.rows[0]) == 1, self.rows
        return self.rows[0][0]


class LocalQueryRunner:
    #: WITH RECURSIVE iteration cap (reference: the max_recursion_depth
    #: session property guarding RecursiveCte expansion)
    MAX_RECURSION_DEPTH = 100

    def __init__(
        self,
        catalogs: Optional[CatalogManager] = None,
        catalog: str = "tpch",
        schema: str = "tiny",
        target_splits: int = 4,
        device=None,
    ):
        from collections import deque

        from trino_tpu_torch.connectors.system import QueryHistory, SystemConnector
        from trino_tpu_torch.runtime.events import EventListenerManager
        from trino_tpu_torch.runtime.lifecycle import QueryTracker
        from trino_tpu_torch.runtime.session import SessionProperties
        from trino_tpu_torch.runtime.transactions import TransactionManager
        from trino_tpu_torch.telemetry import NULL_TRACER

        self.device = resolve_device(device)
        self.catalogs = catalogs or default_catalogs()
        self.session = Session(catalog, schema)
        self.properties = SessionProperties()
        self.properties.set("target_splits", target_splits)
        self.events = EventListenerManager()
        self.transactions = TransactionManager(self.catalogs)
        # security: the statement's identity, set per statement by the
        # coordinator and dbapi layers
        from trino_tpu_torch.server.security import AllowAllAccessControl, GrantManager

        self.access_control = AllowAllAccessControl()
        #: SQL-standard grants and roles, read by GRANT/REVOKE and by
        #: SqlStandardAccessControl when installed
        self.grants = GrantManager()
        self.user = "user"
        self._query_ids = _QUERY_IDS
        #: live statements by query id: `query_tracker.cancel(query_id)`
        #: cancels one, and the deadlines come from the session properties
        #: query_max_run_time / query_max_planning_time
        self.query_tracker = QueryTracker()
        #: one-shot hook: called with the next statement's QueryContext as
        #: soon as it exists (a caller attaches its cancel surface)
        self._query_context_cb = None
        #: system.runtime.queries reads this history, fed by the events
        self.query_history = QueryHistory()
        self.events.add(self.query_history)
        #: (catalog, schema, name) -> view definition Query AST (reference:
        #: MetadataManager view storage + sql/tree/CreateView.java)
        self.views: dict[tuple, object] = {}
        #: prepared-statement name -> statement TEXT with `?` placeholders
        self.prepared: dict[str, str] = {}
        if "system" not in self.catalogs.names():
            sysconn = SystemConnector(self)
            self.catalogs.register("system", sysconn)
        else:
            sysconn = self.catalogs.get("system")
        if getattr(sysconn, "runner", None) is None:
            sysconn.runner = self
        # per-query span tracer (NULL when the query_trace session property
        # is off); the tracer / last_trace / last_mesh_profile surfaces are
        # properties resolved through the lifecycle contextvar, so
        # concurrent lanes each read their own statement's handles
        self._tracer = NULL_TRACER
        #: Chrome-trace JSON of the most recent traced query
        self.last_trace = None
        #: (query_id, flattened spans) ring buffer (system.runtime.spans)
        self.traces = deque(maxlen=64)
        #: persistent per-query profile archive (telemetry/profile_store):
        #: None = archiving off (zero cost).  Attached by runner_from_etc
        #: (attach_profile_store) or explicitly; not here, so a dispatcher
        #: lane never builds a store it immediately replaces
        self.profile_store = None
        #: statement-thread seconds the last archived artifact's assembly
        #: took (`_archive_profile`)
        self.last_artifact_s = 0.0
        #: the last statement's QueryContext (its peak reservation)
        self.last_query = None
        #: the running statement's class name and its `_collect_rows`
        #: seconds so far (whole pulls, and batches turned into rows)
        self._statement = ""
        self._collect_s = [0.0, 0.0]
        #: the last statement's table writes (CTAS, INSERT, ALTER TABLE and
        #: the DML rewrites), one entry each: (statement, "catalog.schema.
        #: table", rows, host seconds in `_collect_rows` during the
        #: statement up to the write, of which turning batches into Python
        #: rows, seconds building the host columns, seconds of the sink's
        #: append)
        self.last_writes: list = []

    def clone_for_dispatch(self) -> "Optional[LocalQueryRunner]":
        """An engine-lane clone for the concurrent dispatcher
        (runtime/dispatcher.QueryDispatcher): it shares everything whose
        identity matters across lanes (the device, catalogs and through
        them the system connector bound to THIS runner, the query tracker
        and id counter, the events and query history, the session
        properties, transactions, views, prepared statements, the span
        ring, the profile store, the grants and the access control) while
        per-statement state (tracer, last trace, mesh profile, last query,
        user) stays lane-private.
        Subclasses (the mesh runner) return None: the dispatcher then runs
        one lane."""
        if type(self) is not LocalQueryRunner:
            return None
        lane = LocalQueryRunner(
            self.catalogs, self.session.catalog, self.session.schema,
            device=self.device,
        )
        lane.session = self.session
        lane.properties = self.properties
        # ONE transaction state across lanes: a BEGIN on one lane and its
        # COMMIT on another see the same TransactionManager
        lane.transactions = self.transactions
        lane.events = self.events
        lane.query_history = self.query_history
        lane.query_tracker = self.query_tracker
        lane._query_ids = self._query_ids
        lane.views = self.views
        lane.prepared = self.prepared
        lane.traces = self.traces
        lane.profile_store = self.profile_store
        lane.grants = self.grants
        lane.access_control = self.access_control
        return lane

    # -- per-statement telemetry handles (lane safety) -------------------------
    #
    # INSIDE a statement the lifecycle contextvar names that statement's
    # own handle; OUTSIDE one, the most recently finished statement's.

    _last_mesh_profile = None

    @property
    def _tracer(self):
        from trino_tpu_torch.runtime.lifecycle import current_query

        ctx = current_query()
        if ctx is not None and ctx.tracer is not None:
            return ctx.tracer
        return self._tracer_default

    @_tracer.setter
    def _tracer(self, tracer) -> None:
        self._tracer_default = tracer

    @property
    def last_mesh_profile(self):
        from trino_tpu_torch.runtime.lifecycle import current_query

        ctx = current_query()
        if ctx is not None and ctx.mesh_profile is not None:
            return ctx.mesh_profile
        return self._last_mesh_profile

    @last_mesh_profile.setter
    def last_mesh_profile(self, profile) -> None:
        from trino_tpu_torch.runtime.lifecycle import current_query

        ctx = current_query()
        if ctx is not None:
            ctx.mesh_profile = profile
        self._last_mesh_profile = profile

    @property
    def last_trace(self):
        from trino_tpu_torch.runtime.lifecycle import current_query

        ctx = current_query()
        if ctx is not None and ctx.trace_json is not None:
            return ctx.trace_json
        return self._last_trace

    @last_trace.setter
    def last_trace(self, trace) -> None:
        self._last_trace = trace

    @property
    def in_transaction(self) -> bool:
        return self.transactions.active

    @property
    def target_splits(self) -> int:
        return self.properties.get("target_splits")

    # -- planning -------------------------------------------------------------

    def create_plan(self, sql: str) -> OutputNode:
        stmt = parse_statement(sql)
        if not isinstance(stmt, ast.SelectStatement):
            raise NotImplementedError(f"statement: {type(stmt).__name__}")
        return self.plan_query(stmt.query)

    def plan_query(self, query: ast.Query) -> OutputNode:
        from trino_tpu_torch.planner.optimizer import optimize
        from trino_tpu_torch.runtime.lifecycle import check_current_planning

        tr = self._tracer
        check_current_planning()  # query_max_planning_time / cancel token
        with tr.span("analyze"):
            query = self._expand_recursive_ctes(query)
            plan = LogicalPlanner(
                self.catalogs, self.session, views=self.views
            ).plan(query)
        check_current_planning()
        with tr.span("optimize"):
            out = optimize(
                plan,
                catalogs=self.catalogs,
                verify=self.properties.get("verify_plan"),
            )
        check_current_planning()
        return out

    # -- execution ------------------------------------------------------------

    def execute(self, sql: str) -> MaterializedResult:
        """Execute any supported statement under its QueryContext: the
        created and completed events (the failure classified), the registry
        counters, the span tracer (`query_trace`) and the retry policy
        (`retry_policy = 'QUERY'` re-runs a statement that failed with a
        retryable error).  When the statement ends, success or failure, its
        spill stores are closed and its memory released."""
        from trino_tpu_torch.runtime import lifecycle
        from trino_tpu_torch.runtime.events import (
            QueryCompletedEvent,
            QueryCreatedEvent,
            classify_error,
        )
        from trino_tpu_torch.runtime.retry import execute_with_retry
        from trino_tpu_torch.runtime.session import CURRENT_USER
        from trino_tpu_torch.telemetry import NULL_TRACER, SpanTracer
        from trino_tpu_torch.telemetry.metrics import (
            queries_counter,
            query_wall_histogram,
        )

        self.access_control.check_can_execute_query(self.user)
        CURRENT_USER.set(self.user)
        stmt = parse_statement(sql)
        m = getattr(self, "_exec_" + type(stmt).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"statement {type(stmt).__name__}: not ported yet"
            )
        qid = f"query_{next(self._query_ids)}"
        ctx = self.query_tracker.create(qid, self.properties)
        cb, self._query_context_cb = self._query_context_cb, None
        if cb is not None:
            cb(ctx)
        self.last_query = ctx
        self._statement = type(stmt).__name__
        self._collect_s = [0.0, 0.0]
        self.last_writes = []
        token = lifecycle.set_current(ctx)
        tracer = (
            SpanTracer(query_id=qid)
            if self.properties.get("query_trace")
            else NULL_TRACER
        )
        prev_tracer = self._tracer  # a nested execute (EXECUTE) restores it
        self._tracer = tracer
        ctx.tracer = tracer
        # plan-decision ledger: one per statement, like the tracer, so
        # concurrent lanes record into disjoint ledgers
        from trino_tpu_torch.telemetry.decisions import ensure_ledger

        ensure_ledger(ctx)
        if self.profile_store is not None and self.device.type == "cuda":
            # the artifact's peak memory is the allocator's peak during
            # this statement
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.time()
        self.events.query_created(QueryCreatedEvent(qid, sql, t0))
        try:
            ctx.begin()
            with tracer.span("query", query_id=qid, sql=sql[:200]):
                self._record_queue_span(tracer)
                # fault_tolerant_execution promotes NONE to TASK; an
                # explicit QUERY policy wins.  A local runner has no stage
                # to retry, so TASK runs the statement once, as in the JAX
                # package; the mesh raises for TASK (parallel/runner.py)
                policy = self.properties.get("retry_policy")
                if (
                    policy == "NONE"
                    and self.properties.get("fault_tolerant_execution")
                ):
                    policy = "TASK"
                result = execute_with_retry(lambda: m(stmt), policy)
            ctx.finish()
        except BaseException as e:
            end = time.time()
            state = ctx.fail(e)  # CANCELED for user cancels, else FAILED
            etype = classify_error(e)
            queries_counter().labels(state, etype).inc()
            query_wall_histogram().observe(end - t0)
            self._finish_trace(qid, tracer, prev_tracer, ctx)
            self._finalize_decisions(ctx)
            self._archive_profile(
                ctx, sql, state, end - t0,
                error_code=getattr(e, "error_code", None),
            )
            self.events.query_completed(
                QueryCompletedEvent(
                    qid, sql, state, t0, end, error=str(e),
                    error_type=etype,
                    error_code=getattr(e, "error_code", None),
                    statistics=self._query_statistics(
                        end - t0, 0, tracer, ctx
                    ),
                )
            )
            raise
        finally:
            lifecycle.reset_current(token)
            ctx.release_spills()  # an aborted wave leaves no spill file
            ctx.release_memory()  # the shared pool's reservations end here
            self.query_tracker.remove(ctx)
        end = time.time()
        queries_counter().labels("FINISHED", "").inc()
        query_wall_histogram().observe(end - t0)
        self._finish_trace(qid, tracer, prev_tracer, ctx)
        self._finalize_decisions(ctx)
        self._archive_profile(ctx, sql, "FINISHED", end - t0, rows=result.row_count)
        self.events.query_completed(
            QueryCompletedEvent(
                qid, sql, "FINISHED", t0, end, rows=result.row_count,
                statistics=self._query_statistics(
                    end - t0, result.row_count, tracer, ctx
                ),
            )
        )
        return result

    def _record_queue_span(self, tracer) -> None:
        """When this statement came through the dispatcher's admission
        queue, record its wait as a `queued` span under the query root."""
        if not tracer.enabled:
            return
        from trino_tpu_torch.runtime.lifecycle import current_admission
        from trino_tpu_torch.telemetry.spans import now as _now

        adm = current_admission()
        if adm is None:
            return
        group, queued_s = adm
        end = _now()
        tracer.record(
            "queued", end - max(0.0, queued_s), end,
            {"group": group, "queued_s": round(queued_s, 6)},
        )

    def _finish_trace(self, qid: str, tracer, prev_tracer, ctx) -> None:
        """Export the finished query's spans (Chrome JSON, and the
        flattened rows of system.runtime.spans); the export is stored on
        the statement's own context too (lane safety)."""
        self._tracer = prev_tracer
        if not tracer.enabled:
            return
        if ctx.gate_wait_s > 0 and tracer.root is not None:
            # device-gate contention next to the spans it delayed
            tracer.root.attrs["gate_wait_s"] = round(ctx.gate_wait_s, 6)
        trace = tracer.to_chrome_trace()
        ctx.trace_json = trace
        self.last_trace = trace
        self.traces.append((qid, tracer.flat_spans()))

    def _finalize_decisions(self, ctx) -> None:
        """Join the statement's plan-decision ledger with its measured
        outcomes and stamp hindsight verdicts (telemetry/decisions).
        Runs before the profile artifact is assembled so the ledger lands
        in it.  Host-side arithmetic on integers the profile already
        holds; must never break a query."""
        ledger = getattr(ctx, "decisions", None)
        if ledger is None:
            return
        try:
            wm = getattr(self, "wm", None)
            n = wm.n if wm is not None else 1
            prof = ctx.mesh_profile
            phases = (
                {fid: st.wall_s for fid, st in prof.fragments.items()}
                if prof is not None
                else None
            )
            ledger.finalize(
                n_workers=n,
                regret_ratio=float(
                    self.properties.get("decision_regret_ratio")
                ),
                min_bytes=int(
                    self.properties.get("decision_regret_min_bytes")
                ),
                fragment_phases=phases,
            )
        except Exception:
            import logging

            logging.getLogger("trino_tpu_torch.decisions").warning(
                "failed to finalize decision ledger for %s", ctx.query_id,
                exc_info=True,
            )

    def _archive_profile(self, ctx, sql: str, state: str, wall_s: float,
                         rows: int = 0, error_code=None) -> None:
        """Assemble + archive this statement's profile artifact
        (telemetry/profile_store) when a store is attached.  Assembly is
        host-side dict building on the statement thread, timed into
        `last_artifact_s`; the SPI write happens on the store's background
        writer, after FINISHING.  Archiving must never break a query."""
        store = getattr(self, "profile_store", None)
        if store is None:
            return
        t0 = time.perf_counter()
        try:
            from trino_tpu_torch.telemetry.profile_store import artifact_from_runner

            ctx.profile_ref = store.archive(
                artifact_from_runner(
                    self, ctx, sql, state, wall_s, rows=rows,
                    error_code=error_code,
                )
            )
        except Exception:
            import logging

            logging.getLogger("trino_tpu_torch.profile_store").warning(
                "failed to assemble profile artifact for %s", ctx.query_id,
                exc_info=True,
            )
        self.last_artifact_s = time.perf_counter() - t0

    def compile_manifest(self) -> list:
        """The deduplicated (step, bucket, mesh) compile-key set this
        process's workload has needed, with per-key seconds — the compile
        observatory's manifest (telemetry/compile_events): step-cache
        builds and kernel builds/loads.  A workload whose warm replays add
        zero entries has a closed key set."""
        from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

        return OBSERVATORY.manifest()

    def _query_statistics(self, wall_s: float, rows: int, tracer, ctx):
        """The QueryStatistics payload from the statement's own handles
        (the mesh profile when distributed, the span count, the peak
        reservation, the device-gate wait and the admission)."""
        from trino_tpu_torch.runtime.events import QueryStatistics
        from trino_tpu_torch.runtime.lifecycle import current_admission

        stats = QueryStatistics(wall_s=round(wall_s, 6), rows=rows)
        prof = ctx.mesh_profile
        if prof is not None:
            stats.phase_totals_s = prof.phase_totals()
            stats.counters = dict(prof.counters)
            stats.trace_cache = {
                "hits": prof.trace_hits,
                "misses": prof.trace_misses,
                "retraces": prof.retraces,
            }
        stats.peak_memory_bytes = ctx.peak_memory
        stats.gate_wait_s = round(ctx.gate_wait_s, 6)
        adm = current_admission()
        if adm is not None:
            stats.group, stats.queued_s = adm[0], round(adm[1], 6)
        if tracer.enabled:
            stats.spans = len(tracer.flat_spans())
        ref = ctx.profile_ref
        if ref is not None:
            stats.profile_key = ref["key"]
        return stats

    def _collect_rows(self, stream) -> list:
        """Rows of a result stream.  Each batch pull runs under the device
        time-slice gate (runtime/dispatcher.device_slice), so concurrent
        dispatcher lanes interleave their device work at batch boundaries;
        turning the batch into rows runs outside it.  The statement's
        cancel token and deadline are checked between batches.  The stream
        is closed however it ends, so the finally blocks of the operators'
        generators (spill stores, revocable handles) run now and no
        generator keeps the statement's tensors alive."""
        from trino_tpu_torch.runtime.dispatcher import device_slice
        from trino_tpu_torch.runtime.lifecycle import check_current

        rows = []
        t0 = time.perf_counter()
        to_rows = 0.0
        it = iter(stream)
        done = object()
        try:
            while True:
                with device_slice():
                    batch = next(it, done)
                if batch is done:
                    break
                check_current()  # cancel/deadline between result batches
                t1 = time.perf_counter()
                rows.extend(batch.to_pytuples())
                to_rows += time.perf_counter() - t1
        finally:
            for s in (it, stream):
                close = getattr(s, "close", None)
                if close is not None:
                    close()
            self._collect_s[0] += time.perf_counter() - t0
            self._collect_s[1] += to_rows
        return rows

    def _execute_plan(self, plan: OutputNode, stats=None) -> MaterializedResult:
        from trino_tpu_torch.runtime.dispatcher import device_slice

        with self._tracer.span("execute"):
            with device_slice():
                lp = LocalExecutionPlanner(
                    self.catalogs,
                    self.device,
                    target_splits=self.target_splits,
                    stats=stats,
                    properties=self.properties,
                )
                physical = lp.plan(plan)
            rows = self._collect_rows(physical.stream)
        return MaterializedResult(
            list(plan.column_names), rows, [s.type for s in plan.symbols]
        )

    def _check_table_access(self, plan) -> None:
        """check_can_select for every scanned table (the reference checks in
        the analyzer; checking the optimized plan also covers views/CTEs)."""
        from trino_tpu_torch.planner.plan import TableScanNode

        def walk(node):
            if isinstance(node, TableScanNode):
                h = node.handle
                self.access_control.check_can_select(
                    self.user, h.catalog, h.schema, h.table
                )
            for c in node.children:
                walk(c)

        walk(plan)

    def _run_query(self, query: ast.Query, stats=None) -> MaterializedResult:
        """Plan, check SELECT access and run one query (the seam the mesh
        runner overrides); `stats` is EXPLAIN ANALYZE's StatsCollector."""
        plan = self.plan_query(query)
        self._check_table_access(plan)
        return self._execute_plan(plan, stats=stats)

    def _exec_SelectStatement(self, stmt: ast.SelectStatement) -> MaterializedResult:
        return self._run_query(stmt.query)

    def _expand_recursive_ctes(self, query: ast.Query) -> ast.Query:
        """WITH RECURSIVE t AS (anchor UNION [ALL] step) — iterate to a
        fixpoint and replace the CTE with its materialized rows (reference:
        sql/planner's recursive CTE expansion, which the reference also
        bounds by max-recursion-depth; here each step plans the recursive
        term against a VALUES relation of the previous delta)."""
        if not query.recursive:
            return query
        from trino_tpu_torch import types as T

        new_ctes = []
        for w in query.ctes:
            if not _references(w.query, w.name):
                new_ctes.append(w)
                continue
            if w.query.order_by or w.query.limit is not None or w.query.offset:
                raise NotImplementedError(
                    "ORDER BY/LIMIT inside a recursive CTE definition"
                )
            body = w.query.body
            if not (isinstance(body, ast.SetOp) and body.op == "union"):
                raise NotImplementedError(
                    "recursive CTE must be anchor UNION [ALL] recursive-term"
                )
            anchor, step = body.left, body.right
            if _references(anchor, w.name):
                raise NotImplementedError(
                    "recursive CTE anchor must not reference the CTE"
                )
            # the CTE definition's own nested WITH entries stay in scope for
            # both the anchor and every recursive step
            prior_ctes = tuple(new_ctes) + tuple(w.query.ctes)
            res = self._run_query(ast.Query(anchor, ctes=prior_ctes))
            names = list(w.column_names) or list(res.column_names)
            distinct = not body.all
            total: list = []
            seen: set = set()
            for r in res.rows:
                t = tuple(r)
                if distinct:
                    if t in seen:
                        continue
                    seen.add(t)
                total.append(r)
            cur_types = list(res.types)
            work = list(total) if distinct else list(res.rows)
            for _ in range(self.MAX_RECURSION_DEPTH):
                if not work:
                    break
                bound = ast.Query(
                    step,
                    ctes=prior_ctes
                    + (
                        ast.WithQuery(
                            w.name,
                            ast.Query(_values_relation(work, cur_types)),
                            tuple(names),
                        ),
                    ),
                )
                nxt = self._run_query(bound)
                # UNION coercion: widen the carried types so step values
                # are never cast back down to the anchor's narrower type
                cur_types = [
                    T.common_super_type(a, b)
                    for a, b in zip(cur_types, nxt.types)
                ]
                rows = []
                for r in nxt.rows:
                    t = tuple(r)
                    if distinct:
                        if t in seen:
                            continue
                        seen.add(t)
                    rows.append(r)
                if not rows:
                    break
                total.extend(rows)
                work = rows
            else:
                raise RuntimeError(
                    f"recursive CTE {w.name} exceeded "
                    f"{self.MAX_RECURSION_DEPTH} iterations"
                )
            new_ctes.append(
                ast.WithQuery(
                    w.name,
                    ast.Query(_values_relation(total, cur_types, names)),
                    tuple(names),
                )
            )
        return ast.Query(
            query.body, query.order_by, query.limit, query.offset,
            tuple(new_ctes), False,
        )

    # -- EXPLAIN --------------------------------------------------------------

    def _exec_ExplainStatement(self, stmt: ast.ExplainStatement) -> MaterializedResult:
        from trino_tpu_torch import types as T

        inner = stmt.statement
        if not isinstance(inner, ast.SelectStatement):
            raise NotImplementedError("EXPLAIN supports queries only")
        if stmt.analyze:
            from trino_tpu_torch.runtime.query_stats import StatsCollector

            collector = StatsCollector()
            self._run_query(inner.query, stats=collector)
            text = collector.render()
            if stmt.verbose:
                # VERBOSE: the span tree and the Perfetto-loadable
                # Chrome-trace JSON on one line
                import json as _json

                tr = self._tracer
                text += "\n" + tr.render_text()
                if tr.enabled:
                    text += "\nTrace JSON: " + _json.dumps(
                        tr.to_chrome_trace()
                    )
        elif stmt.explain_type == "distributed":
            # fragments + partitioning handles, even from a local runner
            # (reference: EXPLAIN (TYPE DISTRIBUTED) -> PlanFragmenter)
            from trino_tpu_torch.planner.fragmenter import (
                add_exchanges,
                create_subplans,
                fragment_text,
            )

            plan = self.plan_query(inner.query)
            sub = create_subplans(
                add_exchanges(plan, self.catalogs, self.properties),
                properties=self.properties,
                catalogs=self.catalogs,
            )
            text = fragment_text(sub)
        else:
            text = plan_text(self.plan_query(inner.query))
            from trino_tpu_torch.planner import optimizer as _opt

            if _opt.LAST_RULE_STATS:
                fires = ", ".join(
                    f"{k}={v}"
                    for k, v in sorted(_opt.LAST_RULE_STATS.items())
                )
                text += f"\nrule fires: {fires}"
        return MaterializedResult(
            ["Query Plan"], [(line,) for line in text.splitlines()], [T.VARCHAR]
        )

    # -- session statements ---------------------------------------------------

    def _exec_UseStatement(self, stmt: ast.UseStatement) -> MaterializedResult:
        if stmt.catalog:
            self.catalogs.get(stmt.catalog)  # validate
            self.session = Session(stmt.catalog, stmt.schema)
        else:
            self.session = Session(self.session.catalog, stmt.schema)
        return _ok("USE")

    def _exec_SetSession(self, stmt: ast.SetSession) -> MaterializedResult:
        from trino_tpu_torch.expr.ir import Literal
        from trino_tpu_torch.planner.analyzer import ExprAnalyzer, Scope

        e = ExprAnalyzer(Scope([])).analyze(stmt.value)
        if not isinstance(e, Literal):
            raise ValueError("SET SESSION value must be a literal")
        value = e.value
        if e.type.name.startswith("varchar"):
            value = str(value)
        self.properties.set(stmt.name, value)
        return _ok("SET SESSION")

    def _exec_TransactionStatement(self, stmt: ast.TransactionStatement) -> MaterializedResult:
        if stmt.action == "start":
            self.transactions.begin()
            return _ok("START TRANSACTION")
        if stmt.action == "commit":
            self.transactions.commit()
            return _ok("COMMIT")
        self.transactions.rollback()
        return _ok("ROLLBACK")

    # -- SHOW / DESCRIBE ------------------------------------------------------

    def _exec_ShowStatement(self, stmt: ast.ShowStatement) -> MaterializedResult:
        from trino_tpu_torch import types as T

        if stmt.what == "catalogs":
            return MaterializedResult(
                ["Catalog"], [(n,) for n in sorted(self.catalogs.names())], [T.VARCHAR]
            )
        if stmt.what == "schemas":
            cat = stmt.target[0] if stmt.target else self.session.catalog
            conn = self.catalogs.get(cat)
            return MaterializedResult(
                ["Schema"],
                [(s,) for s in sorted(conn.metadata().list_schemas())],
                [T.VARCHAR],
            )
        if stmt.what == "tables":
            if len(stmt.target) == 2:
                cat, schema = stmt.target
            elif len(stmt.target) == 1:
                cat, schema = self.session.catalog, stmt.target[0]
            else:
                cat, schema = self.session.catalog, self.session.schema
            conn = self.catalogs.get(cat)
            return MaterializedResult(
                ["Table"],
                [(t,) for t in sorted(conn.metadata().list_tables(schema))],
                [T.VARCHAR],
            )
        if stmt.what == "columns":
            cat, schema, table = self._resolve_table(stmt.target)
            meta = self.catalogs.get(cat).metadata().table_metadata(schema, table)
            return MaterializedResult(
                ["Column", "Type"],
                [(c.name, c.type.name) for c in meta.columns],
                [T.VARCHAR, T.VARCHAR],
            )
        if stmt.what == "functions":
            from trino_tpu_torch.expr.strings import like_to_regex
            from trino_tpu_torch.planner.registry import global_registry

            rows = [
                (
                    m.name,
                    m.return_type,
                    ", ".join(m.argument_types),
                    m.kind,
                    m.deterministic,
                    m.description,
                )
                for m in global_registry().list()
            ]
            if stmt.target:
                rx = like_to_regex(stmt.target[0])
                rows = [r for r in rows if rx.match(r[0])]
            return MaterializedResult(
                [
                    "Function",
                    "Return Type",
                    "Argument Types",
                    "Function Type",
                    "Deterministic",
                    "Description",
                ],
                rows,
                [T.VARCHAR, T.VARCHAR, T.VARCHAR, T.VARCHAR, T.BOOLEAN, T.VARCHAR],
            )
        if stmt.what == "create_table":
            # reference: sql/rewrite/ShowQueriesRewrite's SHOW CREATE TABLE
            cat, schema, table = self._resolve_table(stmt.target)
            meta = self.catalogs.get(cat).metadata().table_metadata(schema, table)
            cols = ",\n".join(
                f"   {c.name} {c.type.name}" for c in meta.columns
            )
            ddl = f"CREATE TABLE {cat}.{schema}.{table} (\n{cols}\n)"
            return MaterializedResult(["Create Table"], [(ddl,)], [T.VARCHAR])
        if stmt.what == "roles":
            return MaterializedResult(
                ["Role"], [(r,) for r in self.grants.list_roles()], [T.VARCHAR]
            )
        if stmt.what == "grants":
            if stmt.target:
                cat, schema, table = self._resolve_table(stmt.target)
                rows = self.grants.grants_for(cat, schema, table)
            else:
                rows = self.grants.grants_for()
            return MaterializedResult(
                ["grantee", "privilege", "catalog", "schema", "table"],
                rows,
                [T.VARCHAR] * 5,
            )
        if stmt.what == "stats":
            # reference: sql/rewrite/ShowStatsRewrite.java — one row per
            # column plus a NULL-named summary row carrying row_count
            cat, schema, table = self._resolve_table(stmt.target)
            md = self.catalogs.get(cat).metadata()
            meta = md.table_metadata(schema, table)
            ts = md.table_statistics(schema, table)
            rows = []
            for c in meta.columns:
                cs = ts.columns.get(c.name)
                rows.append(
                    (
                        c.name,
                        None,
                        float(cs.distinct_count) if cs and cs.distinct_count else None,
                        float(cs.null_fraction) if cs else None,
                        None,
                        str(cs.low) if cs and cs.low is not None else None,
                        str(cs.high) if cs and cs.high is not None else None,
                    )
                )
            rows.append(
                (
                    None, None, None, None,
                    float(ts.row_count) if ts.row_count is not None else None,
                    None, None,
                )
            )
            return MaterializedResult(
                [
                    "column_name", "data_size", "distinct_values_count",
                    "nulls_fraction", "row_count", "low_value", "high_value",
                ],
                rows,
                [T.VARCHAR, T.DOUBLE, T.DOUBLE, T.DOUBLE, T.DOUBLE, T.VARCHAR, T.VARCHAR],
            )
        if stmt.what == "session":
            rows = [
                (name, str(value), meta.type.__name__, meta.description)
                for name, value, meta in sorted(self.properties.items())
            ]
            return MaterializedResult(
                ["Name", "Value", "Type", "Description"],
                rows,
                [T.VARCHAR, T.VARCHAR, T.VARCHAR, T.VARCHAR],
            )
        raise NotImplementedError(f"SHOW {stmt.what}")

    def _resolve_table(self, parts: tuple) -> tuple:
        if len(parts) == 3:
            return parts
        if len(parts) == 2:
            return (self.session.catalog, parts[0], parts[1])
        return (self.session.catalog, self.session.schema, parts[0])

    # -- DDL / DML (reference: execution/CreateTableTask, DropTableTask,
    # InsertStatement via TableWriterOperator -> ConnectorPageSink) ----------

    @staticmethod
    def _table_layout_from(properties: tuple, column_names) -> "object":
        """Extract a TableLayout from CREATE TABLE WITH (...) properties
        (reference: connector table properties -> bucketing handle)."""
        from trino_tpu_torch.partitioning import TableLayout

        props = dict(properties or ())
        unknown = set(props) - {"bucketed_by", "bucket_count"}
        if unknown:
            raise ValueError(
                f"unknown table properties: {sorted(unknown)} "
                "(supported: bucketed_by, bucket_count)"
            )
        if not props:
            return None
        cols = props.get("bucketed_by")
        count = props.get("bucket_count")
        if not cols or not count:
            raise ValueError(
                "bucketed tables need BOTH bucketed_by and bucket_count"
            )
        cols = tuple(str(c) for c in (cols if isinstance(cols, tuple) else (cols,)))
        missing = [c for c in cols if c not in list(column_names)]
        if missing:
            raise ValueError(f"bucketed_by names unknown columns: {missing}")
        return TableLayout(cols, int(count))

    @staticmethod
    def _create_with_layout(conn, schema, table, cols, layout) -> bool:
        """Create the table, passing the layout to a connector that stores
        one (memory: transactional with the table via snapshots); returns
        whether the connector took ownership of the layout."""
        import inspect

        kw = {}
        if layout is not None:
            try:
                if "layout" in inspect.signature(conn.create_table).parameters:
                    kw = {"layout": layout}
            except (TypeError, ValueError):  # builtins / C callables
                pass
        conn.create_table(schema, table, cols, **kw)
        return bool(kw)

    @staticmethod
    def _register_layout(cat, schema, table, layout, owned: bool) -> None:
        """The engine registry for a connector that cannot store the layout
        itself.  Not transactional (a rolled-back CREATE leaves the entry
        until the matching DROP)."""
        if layout is not None and not owned:
            from trino_tpu_torch.partitioning import declare_layout

            declare_layout((cat, schema, table), layout.bucket_columns,
                           layout.bucket_count)

    def _exec_CreateTable(self, stmt: ast.CreateTable) -> MaterializedResult:
        from trino_tpu_torch import types as T
        from trino_tpu_torch.connectors.api import ColumnMeta

        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        self.access_control.check_can_write(self.user, cat, schema, table)
        if table in conn.metadata().list_tables(schema):
            if stmt.if_not_exists:
                return _ok("CREATE TABLE")
            raise ValueError(f"table '{cat}.{schema}.{table}' already exists")
        cols = [ColumnMeta(n, T.parse_type(t)) for n, t in stmt.columns]
        layout = self._table_layout_from(
            stmt.properties, [n for n, _ in stmt.columns]
        )
        self.transactions.notify_write(cat, schema, table)
        owned = self._create_with_layout(conn, schema, table, cols, layout)
        self._register_layout(cat, schema, table, layout, owned)
        self.grants.set_owner(cat, schema, table, self.user)
        return _ok("CREATE TABLE")

    def _exec_CreateTableAs(self, stmt: ast.CreateTableAs) -> MaterializedResult:
        from trino_tpu_torch.connectors.api import ColumnMeta, TableHandle

        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        self.access_control.check_can_write(self.user, cat, schema, table)
        if table in conn.metadata().list_tables(schema):
            if stmt.if_not_exists:
                return _ok("CREATE TABLE AS")
            raise ValueError(f"table '{cat}.{schema}.{table}' already exists")
        result = self._run_query(stmt.query)
        cols = [
            ColumnMeta(n, t) for n, t in zip(result.column_names, result.types)
        ]
        layout = self._table_layout_from(stmt.properties, result.column_names)
        self.transactions.notify_write(cat, schema, table)
        owned = self._create_with_layout(conn, schema, table, cols, layout)
        self._register_layout(cat, schema, table, layout, owned)
        self.grants.set_owner(cat, schema, table, self.user)
        self._write_rows(conn, TableHandle(cat, schema, table), result)
        return MaterializedResult(["rows"], [(result.row_count,)], [])

    def _exec_InsertStatement(self, stmt: ast.InsertStatement) -> MaterializedResult:
        from trino_tpu_torch.connectors.api import TableHandle

        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        meta = conn.metadata().table_metadata(schema, table)
        result = self._run_query(stmt.query)
        if stmt.columns:
            # align provided columns to table order, nulls elsewhere
            name_to_idx = {n: i for i, n in enumerate(stmt.columns)}
            reordered = []
            for r in result.rows:
                row = []
                for c in meta.columns:
                    i = name_to_idx.get(c.name)
                    row.append(None if i is None else r[i])
                reordered.append(tuple(row))
            result = MaterializedResult(
                [c.name for c in meta.columns], reordered,
                [c.type for c in meta.columns],
            )
        self.access_control.check_can_write(self.user, cat, schema, table)
        self.transactions.notify_write(cat, schema, table)
        self._write_rows(conn, TableHandle(cat, schema, table), result)
        return MaterializedResult(["rows"], [(result.row_count,)], [])

    def _exec_CreateView(self, stmt: ast.CreateView) -> MaterializedResult:
        key = self._resolve_table(stmt.name)
        if key in self.views and not stmt.or_replace:
            raise ValueError(f"view {'.'.join(stmt.name)} already exists")
        # validate with the NEW definition installed so a self-referencing
        # replacement trips the planner's recursion check, then roll back
        # on any validation failure
        missing = object()
        prev = self.views.get(key, missing)
        self.views[key] = stmt.query
        try:
            self.plan_query(stmt.query)
        except BaseException:
            if prev is missing:
                del self.views[key]
            else:
                self.views[key] = prev
            raise
        return _ok("CREATE VIEW")

    def _exec_DropView(self, stmt: ast.DropView) -> MaterializedResult:
        key = self._resolve_table(stmt.name)
        if key not in self.views:
            if stmt.if_exists:
                return _ok("DROP VIEW")
            raise KeyError(f"view {'.'.join(stmt.name)} does not exist")
        del self.views[key]
        return _ok("DROP VIEW")

    def _exec_PrepareStatement(self, stmt: ast.PrepareStatement) -> MaterializedResult:
        self.prepared[stmt.name] = stmt.text
        return _ok("PREPARE")

    def _exec_ExecuteStatement(self, stmt: ast.ExecuteStatement) -> MaterializedResult:
        from trino_tpu_torch.sql.placeholders import substitute

        text = self.prepared.get(stmt.name)
        if text is None:
            raise KeyError(f"prepared statement {stmt.name} not found")
        params = [_ast_literal_value(p) for p in stmt.params]
        return self.execute(substitute(text, params))

    def _exec_DescribeStatement(self, stmt: ast.DescribeStatement) -> MaterializedResult:
        """DESCRIBE INPUT/OUTPUT over a prepared statement (reference:
        sql/analyzer DescribeInputRewrite / DescribeOutputRewrite): the
        statement plans with placeholders bound to NULL; OUTPUT reports the
        result columns, INPUT the parameter positions (types unknown — the
        engine does not infer placeholder types, like the reference reports
        'unknown' for non-inferable positions)."""
        from trino_tpu_torch import types as T
        from trino_tpu_torch.sql.placeholders import substitute

        text = self.prepared.get(stmt.name)
        if text is None:
            raise KeyError(f"prepared statement {stmt.name} not found")
        n_params = text.count("?")
        if stmt.kind == "input":
            return MaterializedResult(
                ["Position", "Type"],
                [(i, "unknown") for i in range(n_params)],
                [T.BIGINT, T.VARCHAR],
            )
        bound = substitute(text, [None] * n_params)
        parsed = parse_statement(bound)
        if not isinstance(parsed, ast.SelectStatement):
            raise NotImplementedError("DESCRIBE OUTPUT supports queries only")
        plan = self.plan_query(parsed.query)
        rows = [
            (name, sym.type.name)
            for name, sym in zip(plan.column_names, plan.symbols)
        ]
        return MaterializedResult(
            ["Column Name", "Type"], rows, [T.VARCHAR, T.VARCHAR]
        )

    def _exec_DeallocateStatement(
        self, stmt: ast.DeallocateStatement
    ) -> MaterializedResult:
        self.prepared.pop(stmt.name, None)
        return _ok("DEALLOCATE")

    def _exec_AlterTable(self, stmt: ast.AlterTable) -> MaterializedResult:
        """ALTER TABLE via snapshot + rebuild on write-capable connectors
        (reference roles: sql/tree/RenameTable/AddColumn/DropColumn/
        RenameColumn + connector metadata DDL methods)."""
        from trino_tpu_torch import types as T
        from trino_tpu_torch.connectors.api import ColumnMeta, TableHandle

        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        if not conn.supports_writes():
            raise NotImplementedError(f"connector {cat} does not support ALTER")
        meta = conn.metadata().table_metadata(schema, table)
        self.access_control.check_can_write(self.user, cat, schema, table)
        self.transactions.notify_write(cat, schema, table)
        data = self._run_query(
            ast.Query(
                ast.QuerySpec(
                    (ast.Star(),), ast.TableRef((cat, schema, table)), None, (), None
                )
            )
        )
        cols = list(meta.columns)
        rows = [list(r) for r in data.rows]
        if stmt.action == "rename_table":
            # unqualified targets resolve against the SOURCE table's
            # catalog/schema (the reference renames within them)
            if len(stmt.target) == 1:
                tgt = (cat, schema, stmt.target[0])
            elif len(stmt.target) == 2:
                tgt = (cat, stmt.target[0], stmt.target[1])
            else:
                tgt = tuple(stmt.target)
            if tgt[0] != cat:
                raise ValueError("RENAME cannot move tables across catalogs")
            new_schema, new_table = tgt[1], tgt[2]
            existing = conn.metadata().list_tables(new_schema)
            if new_table in existing:
                raise ValueError(
                    f"target table {new_schema}.{new_table} already exists"
                )
            self.transactions.notify_write(cat, new_schema, new_table)
        else:
            new_schema, new_table = schema, table
            names = [c.name for c in cols]
            if stmt.action == "add_column":
                if stmt.column in names:
                    raise ValueError(f"column {stmt.column} already exists")
                cols.append(ColumnMeta(stmt.column, T.parse_type(stmt.column_type)))
                for r in rows:
                    r.append(None)
            elif stmt.action == "drop_column":
                if stmt.column not in names:
                    raise ValueError(f"column {stmt.column} does not exist")
                ix = names.index(stmt.column)
                cols.pop(ix)
                for r in rows:
                    r.pop(ix)
            elif stmt.action == "rename_column":
                if stmt.column not in names:
                    raise ValueError(f"column {stmt.column} does not exist")
                if stmt.new_name in names:
                    raise ValueError(
                        f"column {stmt.new_name} already exists"
                    )
                ix = names.index(stmt.column)
                cols[ix] = ColumnMeta(stmt.new_name, cols[ix].type)
            else:
                raise NotImplementedError(f"ALTER action {stmt.action}")
        result = MaterializedResult(
            [c.name for c in cols], [tuple(r) for r in rows], [c.type for c in cols]
        )
        same_name = (new_schema, new_table) == (schema, table)
        snap_fn = getattr(conn, "snapshot_table", None)
        snap = snap_fn(schema, table) if (same_name and snap_fn) else None
        conn.create_table(new_schema, new_table, cols)
        try:
            self._write_rows(conn, TableHandle(cat, new_schema, new_table), result)
        except BaseException:
            # never leave the table truncated/half-built
            if same_name and snap_fn is not None:
                conn.restore_table(schema, table, snap)
            elif not same_name:
                conn.drop_table(TableHandle(cat, new_schema, new_table))
            raise
        if not same_name:
            conn.drop_table(TableHandle(cat, schema, table))
            self.grants.set_owner(cat, new_schema, new_table, self.user)
        return _ok("ALTER TABLE")

    # -- security ---------------------------------------------------------------

    def _exec_GrantStatement(self, stmt: ast.GrantStatement) -> MaterializedResult:
        if stmt.roles:
            for r in stmt.roles:
                self.grants.grant_role(r, stmt.grantee)
            return _ok("GRANT ROLE")
        cat, schema, table = self._resolve_table(stmt.name)
        self.grants.grant(stmt.grantee, stmt.privileges, cat, schema, table)
        return _ok("GRANT")

    def _exec_RevokeStatement(self, stmt: ast.RevokeStatement) -> MaterializedResult:
        if stmt.roles:
            for r in stmt.roles:
                self.grants.revoke_role(r, stmt.grantee)
            return _ok("REVOKE ROLE")
        cat, schema, table = self._resolve_table(stmt.name)
        self.grants.revoke(stmt.grantee, stmt.privileges, cat, schema, table)
        return _ok("REVOKE")

    def _exec_RoleStatement(self, stmt: ast.RoleStatement) -> MaterializedResult:
        if stmt.action == "create":
            self.grants.create_role(stmt.role)
            return _ok("CREATE ROLE")
        self.grants.drop_role(stmt.role)
        return _ok("DROP ROLE")

    # -- DML --------------------------------------------------------------------

    def _exec_DeleteStatement(self, stmt: ast.DeleteStatement) -> MaterializedResult:
        """DELETE = filtered table rewrite (reference roles: sql/tree/Delete
        .java + plan/TableDeleteNode.java; connector-pushdown deletes become
        a full rewrite here, exact under the same snapshot semantics as
        INSERT)."""
        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        if not conn.supports_writes():
            raise NotImplementedError(f"connector {cat} does not support DELETE")
        meta = conn.metadata().table_metadata(schema, table)
        self.access_control.check_can_delete(self.user, cat, schema, table)
        # rows to KEEP: predicate FALSE or NULL; bare DELETE keeps nothing
        if stmt.where is None:
            keep_where: ast.Node = ast.BooleanLiteral(False)
        else:
            keep_where = ast.UnaryOp(
                "not",
                ast.FunctionCall(
                    "coalesce", (stmt.where, ast.BooleanLiteral(False))
                ),
            )
        ref = ast.TableRef((cat, schema, table))
        kept = self._run_query(
            ast.Query(ast.QuerySpec((ast.Star(),), ref, keep_where, (), None))
        )
        total = conn.metadata().table_row_count(schema, table) if hasattr(
            conn.metadata(), "table_row_count"
        ) else None
        if total is None:
            total = self._run_query(
                ast.Query(
                    ast.QuerySpec(
                        (ast.SelectItem(
                            ast.FunctionCall("count", (), is_star=True)
                        ),),
                        ref, None, (), None,
                    )
                )
            ).rows[0][0]
        self.transactions.notify_write(cat, schema, table)
        self._rewrite_table(conn, cat, schema, table, meta, kept)
        return MaterializedResult(["rows"], [(total - kept.row_count,)], [])

    def _rewrite_table(self, conn, cat, schema, table, meta, result) -> None:
        """Crash-safe truncate+rewrite: the pre-image is captured first and
        restored if the write-back fails partway (DML must never leave the
        table truncated)."""
        from trino_tpu_torch.connectors.api import TableHandle

        snap_fn = getattr(conn, "snapshot_table", None)
        snap = snap_fn(schema, table) if snap_fn is not None else None
        try:
            conn.create_table(schema, table, list(meta.columns))
            self._write_rows(conn, TableHandle(cat, schema, table), result)
        except BaseException:
            if snap_fn is not None:
                conn.restore_table(schema, table, snap)
            raise

    def _exec_MergeStatement(self, stmt: ast.MergeStatement) -> MaterializedResult:
        """MERGE = three rewrite queries stitched host-side (reference roles:
        sql/tree/Merge.java + planner MergeWriterNode + connector merge
        sinks):

          1. target LEFT-correlated: matched rows run the first WHEN MATCHED
             clause that fires (UPDATE projects new values, DELETE drops);
          2. target rows with no source match are kept verbatim;
          3. WHEN NOT MATCHED INSERT rows come from source rows with no
             target match.

        First-match-wins across clauses is a nested IF chain, exactly the
        searched-CASE the reference plans.  A target row matched by more than
        one source row is a cardinality violation (reference:
        MERGE_TARGET_ROW_MULTIPLE_MATCHES); detected by comparing the join
        pair count against the count of distinct matched target rows.  The
        runner executes one statement at a time and nothing writes the
        target until the rewrite, so every part reads the same snapshot."""
        cat, schema, table = self._resolve_table(stmt.target)
        conn = self.catalogs.get(cat)
        if not conn.supports_writes():
            raise NotImplementedError(f"connector {cat} does not support MERGE")
        meta = conn.metadata().table_metadata(schema, table)
        self.access_control.check_can_update(self.user, cat, schema, table)
        self.access_control.check_can_write(self.user, cat, schema, table)
        ta = stmt.target_alias or table
        tgt_rel: ast.Node = ast.AliasedRelation(
            ast.TableRef((cat, schema, table)), ta
        )
        if isinstance(stmt.source, ast.Query):
            src_rel: ast.Node = ast.SubqueryRelation(stmt.source)
        else:
            src_rel = stmt.source
        if stmt.source_alias:
            src_rel = ast.AliasedRelation(src_rel, stmt.source_alias)

        def chain(cases, leaf_fn, else_expr):
            """First-match-wins nested IF over WHEN clauses."""
            out = else_expr
            for c in reversed(cases):
                cond = c.condition if c.condition is not None else ast.BooleanLiteral(True)
                out = ast.FunctionCall("if", (cond, leaf_fn(c), out))
            return out

        matched_cases = [c for c in stmt.cases if c.matched]
        insert_cases = [c for c in stmt.cases if not c.matched]

        # -- part 1: matched target rows through the WHEN MATCHED chain ------
        matched_rows: list = []
        n_matched_actioned = 0
        if matched_cases:
            items = []
            for col in meta.columns:
                ref = ast.Identifier((ta, col.name))

                def leaf(c, col=col, ref=ref):
                    if c.action == "delete":
                        return ast.CastExpr(ast.NullLiteral(), col.type.name)
                    assigns = dict(c.assignments)
                    if col.name in assigns:
                        return ast.CastExpr(assigns[col.name], col.type.name)
                    return ref

                items.append(ast.SelectItem(chain(matched_cases, leaf, ref), alias=col.name))
            # __keep: FALSE when the first firing clause is DELETE;
            # __hit: TRUE when any clause fired (for the affected-row count)
            items.append(
                ast.SelectItem(
                    chain(
                        matched_cases,
                        lambda c: ast.BooleanLiteral(c.action != "delete"),
                        ast.BooleanLiteral(True),
                    ),
                    alias="__keep",
                )
            )
            items.append(
                ast.SelectItem(
                    chain(
                        matched_cases,
                        lambda c: ast.BooleanLiteral(True),
                        ast.BooleanLiteral(False),
                    ),
                    alias="__hit",
                )
            )
            join = ast.Join("inner", tgt_rel, src_rel, stmt.on)
            res = self._run_query(
                ast.Query(ast.QuerySpec(tuple(items), join, None, (), None))
            )
            n_join_pairs = len(res.rows)
            for r in res.rows:
                keep, hit = r[-2], r[-1]
                if hit:
                    n_matched_actioned += 1
                if keep:
                    matched_rows.append(tuple(r[:-2]))

        # -- part 2: target rows without any source match ---------------------
        # (without matched clauses, matched target rows stay unchanged: they
        # are kept here with every other target row)
        exists_q = ast.Query(
            ast.QuerySpec(
                (ast.SelectItem(ast.NumberLiteral("1")),),
                src_rel,
                stmt.on,
                (),
                None,
            )
        )
        not_matched_where = (
            ast.UnaryOp("not", ast.Exists(exists_q)) if matched_cases else None
        )
        kept = self._run_query(
            ast.Query(
                ast.QuerySpec(
                    (ast.Star(),), tgt_rel, not_matched_where, (), None
                )
            )
        )
        if matched_cases:
            # Cardinality check: part 1 emitted one row per (target, source)
            # join pair.  #pairs > #matched-target-rows means some target
            # row was matched by >1 source row.
            n_target = self._run_query(
                ast.Query(
                    ast.QuerySpec(
                        (
                            ast.SelectItem(
                                ast.FunctionCall("count", (), is_star=True)
                            ),
                        ),
                        tgt_rel,
                        None,
                        (),
                        None,
                    )
                )
            ).rows[0][0]
            n_matched = int(n_target) - len(kept.rows)
            if n_join_pairs > n_matched:
                raise ValueError(
                    "MERGE: one target table row matched more than one "
                    "source row (MERGE_TARGET_ROW_MULTIPLE_MATCHES)"
                )

        # -- part 3: WHEN NOT MATCHED inserts ---------------------------------
        insert_rows: list = []
        if insert_cases:
            tgt_exists = ast.Query(
                ast.QuerySpec(
                    (ast.SelectItem(ast.NumberLiteral("1")),),
                    tgt_rel,
                    stmt.on,
                    (),
                    None,
                )
            )
            items = []
            for col in meta.columns:

                def leaf_ins(c, col=col):
                    cols = list(c.columns) or [m.name for m in meta.columns]
                    if col.name in cols:
                        v = c.assignments[cols.index(col.name)]
                        return ast.CastExpr(v, col.type.name)
                    return ast.CastExpr(ast.NullLiteral(), col.type.name)

                items.append(
                    ast.SelectItem(
                        chain(
                            insert_cases,
                            leaf_ins,
                            ast.CastExpr(ast.NullLiteral(), col.type.name),
                        ),
                        alias=col.name,
                    )
                )
            items.append(
                ast.SelectItem(
                    chain(
                        insert_cases,
                        lambda c: ast.BooleanLiteral(True),
                        ast.BooleanLiteral(False),
                    ),
                    alias="__hit",
                )
            )
            res = self._run_query(
                ast.Query(
                    ast.QuerySpec(
                        tuple(items),
                        src_rel,
                        ast.UnaryOp("not", ast.Exists(tgt_exists)),
                        (),
                        None,
                    )
                )
            )
            for r in res.rows:
                if r[-1]:
                    insert_rows.append(tuple(r[:-1]))

        all_rows = matched_rows + list(kept.rows) + insert_rows
        combined = MaterializedResult(
            [c.name for c in meta.columns],
            all_rows,
            [c.type for c in meta.columns],
        )
        self.transactions.notify_write(cat, schema, table)
        self._rewrite_table(conn, cat, schema, table, meta, combined)
        return MaterializedResult(
            ["rows"], [(n_matched_actioned + len(insert_rows),)], []
        )

    def _exec_UpdateStatement(self, stmt: ast.UpdateStatement) -> MaterializedResult:
        """UPDATE = per-column conditional rewrite (reference:
        sql/tree/Update.java + plan/MergeWriterNode.java roles)."""
        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        if not conn.supports_writes():
            raise NotImplementedError(f"connector {cat} does not support UPDATE")
        meta = conn.metadata().table_metadata(schema, table)
        assigns = dict(stmt.assignments)
        unknown = set(assigns) - {c.name for c in meta.columns}
        if unknown:
            raise ValueError(f"unknown columns in UPDATE: {sorted(unknown)}")
        self.access_control.check_can_update(self.user, cat, schema, table)
        cond = (
            ast.FunctionCall("coalesce", (stmt.where, ast.BooleanLiteral(False)))
            if stmt.where is not None
            else ast.BooleanLiteral(True)
        )
        items = []
        for c in meta.columns:
            ref = ast.Identifier((c.name,))
            if c.name in assigns:
                # the assigned value is cast to the COLUMN's declared type
                # (never the other way round: the stored payload must match
                # the table metadata)
                val = ast.CastExpr(assigns[c.name], c.type.name)
                items.append(
                    ast.SelectItem(
                        ast.FunctionCall("if", (cond, val, ref)),
                        alias=c.name,
                    )
                )
            else:
                items.append(ast.SelectItem(ref, alias=c.name))
        tref = ast.TableRef((cat, schema, table))
        rewritten = self._run_query(
            ast.Query(ast.QuerySpec(tuple(items), tref, None, (), None))
        )
        touched = self._run_query(
            ast.Query(
                ast.QuerySpec(
                    (ast.SelectItem(
                        ast.FunctionCall("count", (), is_star=True)
                    ),),
                    tref, stmt.where, (), None,
                )
            )
        ).rows[0][0]
        self.transactions.notify_write(cat, schema, table)
        self._rewrite_table(conn, cat, schema, table, meta, rewritten)
        return MaterializedResult(["rows"], [(touched,)], [])

    def _exec_DropTable(self, stmt: ast.DropTable) -> MaterializedResult:
        from trino_tpu_torch.connectors.api import TableHandle

        cat, schema, table = self._resolve_table(stmt.name)
        conn = self.catalogs.get(cat)
        if stmt.if_exists and table not in conn.metadata().list_tables(schema):
            return _ok("DROP TABLE")
        self.access_control.check_can_write(self.user, cat, schema, table)
        self.transactions.notify_write(cat, schema, table)
        conn.drop_table(TableHandle(cat, schema, table))
        from trino_tpu_torch.partitioning import drop_layout

        drop_layout((cat, schema, table))
        return _ok("DROP TABLE")

    def _write_rows(self, conn, handle, result: MaterializedResult) -> None:
        """Scaled writers (reference: the scaled-writer operators behind
        task_writer_count): host columns are built on `writer_count`
        threads, one column each; the sink commits once.  The columns are
        built on the CPU: the connector's store is host numpy."""
        from concurrent.futures import ThreadPoolExecutor

        from trino_tpu_torch.columnar.builders import column_from_values
        from trino_tpu_torch.connectors.api import ColumnData

        meta = conn.metadata().table_metadata(handle.schema, handle.table)
        sink = conn.page_sink(
            handle, [c.name for c in meta.columns], [c.type for c in meta.columns]
        )
        if not result.rows:
            return
        from trino_tpu_torch import types as T

        for cm in meta.columns:
            if isinstance(cm.type, T.MapType):
                # the JAX package fails here building the column (a
                # TypeError over the map's dict values)
                raise NotImplementedError(
                    f"writing {cm.type.name} values into a table: not ported"
                )
        writers = max(1, int(self.properties.get("writer_count") or 1))
        cpu = torch.device("cpu")

        def build(i_cm):
            i, cm = i_cm
            col = column_from_values([r[i] for r in result.rows], cm.type, cpu)
            return ColumnData(
                col.data.numpy(),
                None if col.valid is None else col.valid.numpy(),
                col.dictionary,
            )

        t0 = time.perf_counter()
        items = list(enumerate(meta.columns))
        if writers <= 1 or len(items) <= 1 or len(result.rows) < 1024:
            cols = [build(x) for x in items]
        else:
            # column-parallel build keeps dictionaries whole and the commit
            # single (one sink append = one snapshot)
            with ThreadPoolExecutor(max_workers=min(writers, len(items))) as pool:
                cols = list(pool.map(build, items))
        t1 = time.perf_counter()
        sink.append(cols)
        t2 = time.perf_counter()
        self.last_writes.append(
            (
                self._statement,
                f"{handle.catalog}.{handle.schema}.{handle.table}",
                len(result.rows),
                self._collect_s[0],
                self._collect_s[1],
                t1 - t0,
                t2 - t1,
            )
        )


def _references(node, name) -> bool:
    """Whether an AST subtree names the relation `name` (a recursive CTE's
    self reference)."""
    if isinstance(node, ast.TableRef) and node.name == (name,):
        return True

    def walk_tuple(t) -> bool:
        for item in t:
            if isinstance(item, ast.Node) and _references(item, name):
                return True
            if isinstance(item, tuple) and walk_tuple(item):
                return True
        return False

    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, ast.Node) and _references(v, name):
            return True
        if isinstance(v, tuple) and walk_tuple(v):
            return True
    return False


def _values_relation(rows, types, names=None):
    """Materialized python rows -> a VALUES relation of typed literal AST
    nodes (the recursive-CTE binding; reference: the VALUES node the
    reference's CTE expansion feeds each iteration)."""
    import datetime
    from decimal import Decimal

    from trino_tpu_torch import types as T

    def lit(v, t):
        if v is None:
            return ast.CastExpr(ast.NullLiteral(), t.name)
        if t is T.BOOLEAN or isinstance(v, bool):
            return ast.BooleanLiteral(bool(v))
        if isinstance(v, Decimal):
            return ast.CastExpr(ast.NumberLiteral(str(v)), t.name)
        if isinstance(v, datetime.datetime):
            return ast.TimestampLiteral(v.isoformat(sep=" "))
        if isinstance(v, datetime.date):
            return ast.DateLiteral(v.isoformat())
        if isinstance(v, str):
            return ast.CastExpr(ast.StringLiteral(v), t.name) if not T.is_string_kind(t) else ast.StringLiteral(v)
        if isinstance(v, float):
            return ast.CastExpr(ast.NumberLiteral(repr(v)), t.name)
        if isinstance(v, int):
            return ast.CastExpr(ast.NumberLiteral(str(v)), t.name)
        raise NotImplementedError(
            f"recursive CTE value of type {type(v).__name__}"
        )

    if not rows:
        # zero-row relation with the right arity/types: typed NULLs under
        # WHERE false (VALUES itself needs >= 1 row)
        items = tuple(
            ast.SelectItem(
                ast.CastExpr(ast.NullLiteral(), t.name),
                alias=(names[i] if names else f"c{i}"),
            )
            for i, t in enumerate(types)
        )
        return ast.QuerySpec(
            items, None, ast.BooleanLiteral(False), (), None
        )
    return ast.ValuesRelation(
        tuple(tuple(lit(v, t) for v, t in zip(r, types)) for r in rows)
    )


def _ast_literal_value(node):
    """EXECUTE ... USING parameter -> python literal value."""
    if isinstance(node, ast.NumberLiteral):
        txt = node.text
        return float(txt) if ("." in txt or "e" in txt.lower()) else int(txt)
    if isinstance(node, ast.StringLiteral):
        return node.value
    if isinstance(node, ast.BooleanLiteral):
        return node.value
    if isinstance(node, ast.NullLiteral):
        return None
    if isinstance(node, ast.UnaryOp) and node.op == "-":
        v = _ast_literal_value(node.operand)
        return -v
    raise ValueError(
        f"EXECUTE USING supports literal parameters only, got "
        f"{type(node).__name__}"
    )


def _ok(tag: str) -> MaterializedResult:
    return MaterializedResult([tag], [(True,)], [])

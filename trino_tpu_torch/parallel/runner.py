"""Distributed query runner: fragmented, stage-based execution on a mesh of
logical workers.

Port of trino_tpu/parallel/runner.py.  Reference roles:
SqlQueryExecution.planDistribution (plan -> SubPlan via PlanFragmenter) +
PipelinedQueryScheduler (stage orchestration) + AddExchanges' distribution
choices.  The plan is rewritten with explicit ExchangeNodes
(planner/fragmenter.add_exchanges), cut into PlanFragments with
partitioning handles, and executed bottom-up: fragment bodies run per
worker over the stacked [W, cap] layout of parallel/spmd.py, exchange edges
lower to the on-device collectives of parallel/exchange.py (hash bucketize
+ all-to-all, broadcast = all-gather) or to a gather/merge into the
coordinator's local engine.

Stage value forms: a distributed stage yields a `_Dist` (stacked [W, cap]
batch on the mesh's device); a SINGLE/COORDINATOR_ONLY stage yields
materialized batches from the local engine.

Unary operators (filter/project/sort/limit/TopN) DEFER their per-worker
step onto the `_Dist`; a chain runs at the next materialization boundary
(exchange, join, gather).  Scans cache their stacked batch in the buffer
pool's device tier, so a warm mesh query moves no table data to the card.

The mesh join (`_x_JoinNode`) sorts each worker's build shard and locates
every probe row's run of matching build rows.  On the card, a join with a
single integer key plane per side takes the hand-written Hopper kernel of
ops/locate_sorted.py whatever `pallas_probe` says (the kernel and the plain
search are bit-exact there); other keys take the port's `_locate_sorted`.
On the CPU `pallas_probe` decides, as in the JAX package: on, the kernel
module's plain version; off, `_locate_sorted`.  The property stays
accepted, and stays in the join's capacity-history key, for parity.

The mesh semi join (`_x_SemiJoinNode`) broadcasts the filtering side and
marks each source shard against it; a semi join with a residual
(correlated EXISTS) expands the key-matching pairs per shard instead, over
the connector's aligned splits or, once either side has moved, both sides
hash-placed on the key.  Both take the same probe search as the join
(`_probe_search`), so K2 runs in every K2-eligible mesh semi join on the
card.  A cross join runs in the coordinator's local engine.

A grouped aggregation with DISTINCT aggregates repartitions its raw rows
on the group keys and dedupes and aggregates each worker's rows in one
stage (`_spmd_single_stage`); a MarkDistinct marks each worker's rows over
a source the fragmenter placed on the mark's keys, and a window computes
each worker's partitions over a source placed on its partition keys.

Memory budgets: the executor holds a per-query reservation tree (on the
shared pool while a statement runs).  A join reserves its build (raw and
sorted copy) and an aggregation its fused exchange's output before they
materialize; over budget the join runs in hash-partition waves
(`_wave_join`: both stacked sides cross to the host, partition per worker
shard, spill through the filesystem under `spill_enabled`, and every wave
restacks onto the same alignment and runs the same locate/expand steps, so
the sorted-probe kernel launches on every wave of every shard) and the
aggregation's exchange runs in group-hash waves (`_wave_agg_exchange`).
Wave and spill events count in `counters` (`memory_wave`, `spill_bytes`).
A grouped aggregation counts `agg_single_stage` when it repartitions the
raw rows and aggregates each group whole on one worker (DISTINCT, and the
partitionable holistic aggregates percentile, min_by and max_by), and
`agg_partial_states` when it exchanges partial states (a global
aggregation's states are gathered to the coordinator, an approx_percentile
sketch among them).  The collect aggregates, a global holistic aggregate
and MATCH_RECOGNIZE run in the coordinator fragment, where the fragmenter
places them; a TABLESAMPLE raises, as the JAX mesh does.

Every statement of the local runner runs here too: the queries inside
CTAS, INSERT ... SELECT, DELETE, UPDATE, MERGE, ALTER TABLE and WITH
RECURSIVE's steps run on the mesh (`_run_query`), and a memory table's
splits (row ranges of one stored column set) stack per worker like any
scan's.

The per-fragment profile (runtime/query_stats.MeshProfile, the
statement's `last_mesh_profile`): every stage's self wall split into
phases (`trace` = the step cache's builds, `compute` and `collective` =
the launches of its steps, `transfer` = host pulls, gathers and stacks,
`other` = the remainder), the bytes it moved and its event counts
(`bump`, mirrored into the registry; `counters` is a view of the
profile's).  The step cache routes each launch through the executor's
`_call` (parallel/spmd.set_launch_hook), which checks the statement's
cancel token and deadline first; each fragment checks them too.  A
deferred step chain is billed to the fragment that materializes it (the
JAX package bills its producer); the phases still sum to each wall.
Under EXPLAIN ANALYZE the profile waits on the card inside each phase
window.  The `fragment` span covers fragmenting, `schedule` the run.

Bucketed table layouts (`table_layouts`, or a table created WITH
(bucketed_by, bucket_count)): under `colocated_join` a scan whose layout
is usable (partitioning/layout.scan_partitioning) shards its rows by the
exchange hash of the bucket columns instead of round-robin splits, so the
stacked scan already is the placement a hash repartition on those keys
would give; the fragmenter elides the repartition of a co-located join or
aggregation (`exchange_elided`), and the device scan cache keys the
layout.

Collective-schedule license (verify/schedule.py): `create_subplan` stamps
`last_collective_signature` and `last_schedule_license`; the stage
executor, given the license, runs each fragment's licensed build-side
children before the fragment's body (`collective_async`, mirrored into
`telemetry.metrics.collective_async_counter`).  They are the feeds the
lazy order would run first anyway, before any of the body's dynamic
filters register, so the rows and the pruning stay the same.

Fault-tolerant execution (`retry_policy = 'TASK'`, or
`fault_tolerant_execution = true`): every stage is a retryable unit of up
to `TASK_ATTEMPTS` attempts.  A distributed stage's output crosses to the
host once, is split per worker and spooled as one npz file per attempt
(runtime/fte.SpoolManager, a directory per query, removed when the query
ends); each consumer rehydrates the spooled shards onto the mesh's device
with their placements, after the spool's `AttemptDedup` committed the
first attempt and discarded the duplicates.  A failed stage re-runs alone:
its finished children are served from the memo or the spool.  The
injection points `stage:{fid}`, `stage:{fid}:finish` and
`stage:{fid}:spooled` (runtime/retry.FAILURE_INJECTOR) fire before the
body, after it and after the spool; each recovery is counted
(`task_retries_total{outcome}`) and recorded in the decision ledger.

Plan decisions (telemetry/decisions.py): `create_subplan` records the
schedule license; each exchange, join side placement, broadcast,
aggregation exchange and capacity-sized expansion runs under the scope of
the decision that chose it, so the collective bytes it moves are credited
there; a budget's waves and each join's capacity source are recorded where
the runtime decides them.  A step's first launch closes the compile events
its build opened (telemetry/compile_events.py).

Membership: the runner keeps a `failure_detector`
(runtime/membership.HeartbeatFailureDetector) over `worker-0..W-1`,
refreshed and checked before every query (a worker silent past its
timeout fails the query), and `resize_mesh(W)` re-shapes the mesh for
later queries, dropping the old signature's device scan-cache entries and
kicking the attached prewarm executor (runtime/prewarm), which replays
its manifest at the new signature.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.columnar.column import pad_slots
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.expr import ExprCompiler
from trino_tpu_torch.expr.ir import InputRef, and_
from trino_tpu_torch.ops.aggregation import AggregationOperator, AggSpec, _pad_device
from trino_tpu_torch.ops.common import SortKey, next_pow2
from trino_tpu_torch.ops.filter_project import FilterProjectOperator
from trino_tpu_torch.ops.join import (
    HashJoinOperator,
    SemiJoinOperator,
    _canon_probe_device,
    _locate_sorted,
    _sort_build_device,
)
from trino_tpu_torch.ops.locate_sorted import locate_sorted, probe_kernel_eligible
from trino_tpu_torch.ops.sort import TopNOperator, _sorted
from trino_tpu_torch.parallel import exchange as ex
from trino_tpu_torch.parallel.spmd import (
    TRACE_CACHE,
    WorkerMesh,
    bucket_cap,
    cached_spmd_step,
    launch_bucket,
    mesh_key,
    shard,
    stack_batches,
    stack_shards,
    trailing_cap,
    unstack_batch,
)
from trino_tpu_torch.partitioning import (
    CAP_HISTORY,
    LayoutResolver,
    bucket_rows,
    initial_cap,
    join_output_placements,
    next_cap,
    scan_partitioning,
    speculation_mode,
)
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import (
    FIXED_ARBITRARY,
    FIXED_HASH,
    SOURCE,
    RemoteSourceNode,
    SubPlan,
    add_exchanges,
    create_subplans,
    fragment_text,
)
from trino_tpu_torch.planner.functions import HOLISTIC_AGGS, PARTITIONABLE_HOLISTIC
from trino_tpu_torch.planner.join_planning import collect_symbol_names
from trino_tpu_torch.runtime.local_planner import (
    LocalExecutionPlanner,
    PhysicalPlan,
    null_column,
    window_args,
)
from trino_tpu_torch.runtime.lifecycle import check_current
from trino_tpu_torch.runtime.memory import batch_bytes
from trino_tpu_torch.runtime.query_stats import MeshProfile
from trino_tpu_torch.runtime.runner import LocalQueryRunner, MaterializedResult
from trino_tpu_torch.telemetry.compile_events import OBSERVATORY
from trino_tpu_torch.telemetry.decisions import (
    decision_scope,
    observe_decision,
    record_decision,
)
from trino_tpu_torch.telemetry.spans import now

_DIST_KINDS = (SOURCE, FIXED_HASH, FIXED_ARBITRARY)

#: capacity-economy decline threshold: a licensed join whose certified
#: expand capacity exceeds the CapacityHistory-learned tight bucket by more
#: than this factor falls back to the runtime sizing path
_LICENSE_WIDTH_FACTOR = 64


class _Dist:
    """A distributed intermediate: stacked [W, cap] batch + symbol layout.

    `pending` holds deferred per-worker steps [(key_part, fn)] appended by
    unary operators; accessing `.stacked` runs them as one chain per
    worker.  `cap` tracks the trailing row capacity through deferred
    shape-changing steps.  `placements` carries the partitioning property
    (symbol-name tuples the rows are exchange-hash-placed on), so a
    repartition of already-placed data is elided.  `realigned` records that
    rows were moved off the connector's default split alignment (an
    exchange, a partitioned join, a host re-stack); `unaligned` names the
    columns that left it while the rows did not (a broadcast join's build
    columns now sit beside their probe matches): the residual semi join
    marks per shard only while both sides' keys keep that alignment."""

    def __init__(self, stacked: Batch, symbols: list, ex=None, pending=(),
                 cap: Optional[int] = None, placements: tuple = (),
                 realigned: bool = False, unaligned: frozenset = frozenset()):
        self._stacked = stacked
        self.symbols = list(symbols)
        self.ex = ex
        self.pending = list(pending)
        self.cap = cap if cap is not None else trailing_cap(stacked)
        self.placements = tuple(placements)
        self.realigned = realigned
        self.unaligned = frozenset(unaligned)

    @property
    def stacked(self) -> Batch:
        if self.pending:
            self._stacked = self.ex._run_chain(self._stacked, self.pending)
            self.pending = []
        return self._stacked

    def defer(self, key_part, step, symbols=None, cap: Optional[int] = None,
              placements: Optional[tuple] = None,
              unaligned: Optional[frozenset] = None) -> "_Dist":
        """Append a per-worker step lazily (a pure Batch -> Batch function;
        `key_part` fingerprints its semantics).  Placements survive
        symbol-preserving steps; a step that renames its output symbols must
        pass the remapped `placements` (default: dropped) and `unaligned`
        (default: every output column, once any input column is)."""
        if placements is None:
            placements = self.placements if symbols is None else ()
        if unaligned is None:
            unaligned = self.unaligned
            if symbols is not None and unaligned:
                unaligned = frozenset(s.name for s in symbols)
        return _Dist(
            self._stacked,
            self.symbols if symbols is None else symbols,
            self.ex,
            self.pending + [(key_part, step)],
            cap if cap is not None else self.cap,
            placements,
            self.realigned,
            unaligned,
        )

    def channel(self, name: str) -> int:
        for i, s in enumerate(self.symbols):
            if s.name == name:
                return i
        raise KeyError(name)

    def rewrite(self, expr):
        return PhysicalPlan(iter(()), self.symbols).rewrite(expr)


def _sig(symbols) -> tuple:
    """Channel-layout signature for step-cache keys (types only)."""
    return tuple(s.type.name for s in symbols)


def _spec_sig(specs) -> tuple:
    """Full AggSpec fingerprint for step-cache keys."""
    return tuple(
        (s.name, s.arg, s.out_type.name, s.sum_bound, s.arg2, repr(s.param)) for s in specs
    )


class DistributedQueryRunner(LocalQueryRunner):
    """A LocalQueryRunner whose queries run fragmented over `n_workers`
    logical workers on one device (the card unless `device` says
    otherwise; there is no fallback)."""

    def __init__(
        self,
        catalogs: Optional[CatalogManager] = None,
        catalog: str = "tpch",
        schema: str = "tiny",
        n_workers: int = 4,
        device=None,
    ):
        from trino_tpu_torch.runtime.membership import HeartbeatFailureDetector

        super().__init__(catalogs, catalog=catalog, schema=schema, device=device)
        self.wm = WorkerMesh(n_workers, self.device)
        #: coordinator-side worker liveness (HeartbeatFailureDetector.java:78);
        #: in-process mesh workers share our liveness, so they are refreshed
        #: at query start
        self.failure_detector = HeartbeatFailureDetector()
        for i in range(self.wm.n):
            self.failure_detector.register(f"worker-{i}")
        #: the last query's executor (its dynamic filters and event counts)
        self.last_stage_executor = None
        #: the last subplan's collective signature and schedule license
        #: (create_subplan), which verify.device_residency reads
        self.last_collective_signature = None
        self.last_schedule_license = None
        #: scan-cache entries the last resize_mesh dropped (evidence)
        self.last_resize_invalidated = 0

    def resize_mesh(self, n_workers: int) -> None:
        """Re-shape the mesh for subsequent queries.  A changed W is a new
        mesh signature: the old signature's device-resident scan entries
        are dead weight and are dropped here.  The mesh is W logical
        workers on one card, so no device count bounds W from above (the
        JAX mesh slices W of its devices); W < 1 raises ValueError as it
        does there.  A changed W is a new `mesh_key(wm)`, so every step
        is built again: the attached prewarm executor (runner.prewarm,
        runtime/prewarm) replays the workload manifest at the new
        signature in the background, so the next query arrives warm.

        Deliberately NOT named `add_worker`: that name is the coordinator
        register endpoint's protocol (`add_worker(url)` on the multi-host
        runner).  Call between queries."""
        from trino_tpu_torch.parallel.spmd import mesh_key
        from trino_tpu_torch.runtime.membership import invalidate_mesh_scans
        from trino_tpu_torch.runtime.prewarm import kick_grow_prewarm

        if n_workers < 1:
            raise ValueError(f"mesh size {n_workers} out of range (must be >= 1)")
        if n_workers == self.wm.n:
            return
        old_sig = mesh_key(self.wm)
        old_n = self.wm.n
        self.wm = WorkerMesh(n_workers, self.wm.device)
        for i in range(self.wm.n):
            self.failure_detector.register(f"worker-{i}")
        # a SHRINK must forget the dropped workers: a stale detector entry
        # would time out and fail every later query's liveness check
        for i in range(self.wm.n, old_n):
            self.failure_detector.unregister(f"worker-{i}")
        self.last_resize_invalidated = invalidate_mesh_scans(old_sig)
        kick_grow_prewarm(self)

    # -- planning -------------------------------------------------------------

    def create_subplan(self, plan: P.OutputNode) -> SubPlan:
        from trino_tpu_torch.verify.capacity import seal_licenses
        from trino_tpu_torch.verify.collectives import collective_signature
        from trino_tpu_torch.verify.schedule import license_schedule

        dplan = add_exchanges(
            plan, self.catalogs, self.properties, n_workers=self.wm.n
        )
        sub = create_subplans(
            dplan,
            properties=self.properties,
            catalogs=self.catalogs,
            n_workers=self.wm.n,
        )
        # seal every capacity certificate for THIS mesh width: the stage
        # executor honors a license only when the seal matches the mesh
        for frag in sub.all_fragments():
            seal_licenses(frag.root, self.wm.n)
        # the statically enumerated per-fragment collective sequence of the
        # most recent subplan: verify.device_residency holds warm replays
        # to it
        self.last_collective_signature = collective_signature(sub)
        # divergence-free fragments license eager pre-dispatch of their
        # independent build-side children (verify/schedule.py)
        self.last_schedule_license = license_schedule(sub, self.wm.n)
        lic = self.last_schedule_license
        n_async = (
            sum(len(v) for v in lic.async_children.values())
            if lic is not None
            else 0
        )
        record_decision(
            "schedule_license", "planner.create_subplan",
            "async" if n_async else "sync",
            "sync" if n_async else "async",
            {"async_children": n_async},
        )
        return sub

    def explain_distributed(self, sql: str) -> str:
        return fragment_text(self.create_subplan(self.create_plan(sql)))

    # -- execution ------------------------------------------------------------

    def _run_query(self, query, stats=None) -> MaterializedResult:
        from trino_tpu_torch.runtime.lifecycle import current_query

        # in-process mesh workers share this process's liveness: refresh them
        # BEFORE the dead check, so only stale registrations can fail it
        for i in range(self.wm.n):
            self.failure_detector.heartbeat(f"worker-{i}")
        dead = self.failure_detector.failed_workers()
        if dead:
            raise RuntimeError(f"workers failed heartbeat: {sorted(dead)}")
        tr = self._tracer
        plan = self.plan_query(query)
        with tr.span("fragment"):
            sub = self.create_subplan(plan)
        # EXPLAIN ANALYZE runs the same distributed path with the profile
        # in blocking mode, so the phase times measure device work
        profile = MeshProfile(
            blocking=stats is not None, tracer=tr, device=self.wm.device
        )
        ctx = current_query()
        executor = StageExecutor(
            self.catalogs, self.wm, self.properties,
            # the statement's own id (spool file names, attempt dedup)
            query_id=ctx.query_id if ctx is not None else "q",
            profile=profile, schedule=self.last_schedule_license,
        )
        self.last_stage_executor = executor
        self.last_mesh_profile = profile
        with tr.span("schedule"):
            rows = self._collect_rows(executor.run(sub).stream)
        if stats is not None:
            stats.mesh_profile = profile
        return MaterializedResult(
            list(plan.column_names), rows, [s.type for s in plan.symbols]
        )


class StageExecutor:
    """Executes a SubPlan tree bottom-up (reference role: StageManager +
    SqlStage inside PipelinedQueryScheduler, with on-device collectives as
    the data plane)."""

    #: attempts per stage under retry_policy = TASK (reference:
    #: EventDrivenFaultTolerantQueryScheduler's task retry budget)
    TASK_ATTEMPTS = 4

    def __init__(self, catalogs, wm: WorkerMesh, properties, query_id: str = "q",
                 profile: Optional[MeshProfile] = None, schedule=None):
        self.catalogs = catalogs
        self.wm = wm
        self.properties = properties
        self.query_id = query_id
        #: collective-schedule license (verify/schedule.py): authorizes the
        #: eager pre-dispatch of independent build-side child fragments;
        #: None (or a license for another mesh width) = strictly lazy
        self.schedule = (
            schedule if schedule is not None and schedule.mesh_w == wm.n else None
        )
        #: the statement's per-fragment profile (runtime/query_stats.py)
        self.profile = (
            profile if profile is not None else MeshProfile(device=wm.device)
        )
        self._subplans: dict = {}
        self._results: dict = {}
        #: the fragment executing now (-1 outside every fragment)
        self._current_fid = -1
        #: per-stage elapsed bookkeeping, so fragment walls are SELF time
        self._frame_stack: list = []
        #: open phase windows (a nested launch books into the outer one)
        self._window_depth = 0
        #: seconds of child stages run so far: a phase window that encloses
        #: a child stage subtracts the child's time
        self._excl_s = 0.0
        self._trace_base = (TRACE_CACHE.hits, TRACE_CACHE.misses, TRACE_CACHE.retraces)
        #: cross-fragment dynamic filters: probe symbol name -> (lo, hi)
        #: build-side key range, registered when a build side completes and
        #: consumed by later probe-side scans
        self.dynamic_filters: dict = {}
        #: named event counts (exchange elisions, capacity paths, waves,
        #: ...): a view of the profile's counters
        self.counters: dict = self.profile.counters
        self.layouts = LayoutResolver(catalogs, properties)
        self.colocate = bool(properties.get("colocated_join"))
        self.license_caps = bool(properties.get("join_capacity_license"))
        # fault_tolerant_execution implies the TASK machinery: stage outputs
        # spool, stages retry one by one, consumers dedup attempts
        self.retry_task = str(properties.get("retry_policy")).upper() == "TASK" or bool(
            properties.get("fault_tolerant_execution")
        )
        #: the query's spool of stage outputs (TASK only; closed by `run`)
        self.spool = None
        #: fid -> (symbols, dictionaries, placements, realigned, unaligned)
        #: of its spooled output
        self._spool_meta: dict = {}
        #: duplicate spooled attempts discarded by consumer-side dedup
        self.dedup_discards = 0
        #: spool traffic: bytes written and read, host seconds of `_spool`
        #: and `_load_spooled`
        self.spool_stats = {
            "bytes_written": 0, "bytes_read": 0, "spool_s": 0.0, "load_s": 0.0,
        }
        if self.retry_task:
            from trino_tpu_torch.runtime.fte import SpoolManager

            self.spool = SpoolManager()
        # per-query budget tree of the mesh path: join builds and the fused
        # exchange's aggregation output reserve BEFORE materializing; over
        # budget they degrade to partition waves (runtime/spill.py)
        from trino_tpu_torch.runtime.lifecycle import query_memory_context
        from trino_tpu_torch.runtime.spill import session_budget

        self.memory = query_memory_context(session_budget(properties))

    def _budget(self) -> int:
        """Effective device budget (0 = unconstrained), read at each
        reservation so a pool limit shrunk mid-query takes effect."""
        from trino_tpu_torch.runtime.spill import effective_budget

        return effective_budget(self.properties, self.memory)

    def bump(self, name: str, n: int = 1) -> None:
        """Count an event in the profile (mirrored into the registry's
        trino_tpu_mesh_events_total)."""
        self.profile.bump(name, n)

    # -- instrumented launches and transfers ------------------------------------

    @contextmanager
    def _phase(self, name: str, launch: bool = False):
        """Time a window of the executing fragment as phase `name`; a
        blocking profile waits on the device inside the window.  A window
        nested in another books nothing (the outer one holds its time),
        and a child stage run inside a window is subtracted from it, so a
        fragment's phases never exceed its self wall."""
        fid = self._current_fid
        if self._window_depth or fid < 0:
            yield
            return
        prof = self.profile
        self._window_depth += 1
        excl0 = self._excl_s
        t0 = now()
        try:
            yield
            prof.wait()
        finally:
            t1 = now()
            self._window_depth -= 1
            prof.add_phase(fid, name, (t1 - t0) - (self._excl_s - excl0))
            tr = prof.tracer
            if tr.enabled:
                if launch:
                    tr.record("launch", t0, t1, {"phase": name, "fragment": fid})
                else:
                    tr.record(name, t0, t1, {"fragment": fid})

    def _call(self, fn, args, phase: str = "compute"):
        """Launch one step (the step cache's launch hook): the statement's
        cancel token and deadline are checked first, and the launch is
        timed as `phase` of the executing fragment.  A step's first launch
        closes the compile events its build opened."""
        check_current()  # cooperative cancel/deadline point per launch
        if not OBSERVATORY.has_open():
            with self._phase(phase, launch=True):
                return fn(*args)
        # the first launch of a step the cache just built: it closes the
        # compile events the build opened (telemetry/compile_events)
        t0 = now()
        with self._phase(phase, launch=True):
            out = fn(*args)
        t1 = now()
        fid = self._current_fid if self._current_fid >= 0 else None
        events = OBSERVATORY.close_open(
            t1 - t0, bucket=launch_bucket(args), fragment=fid,
            mesh=mesh_key(self.wm),
        )
        tr = self.profile.tracer
        if tr.enabled:
            for ev in events:
                tr.record(
                    "compile", t1 - ev.wall_s, t1,
                    {"step": ev.step, "key": ev.key_fp, "bucket": ev.bucket,
                     "fragment": fid},
                )
        # deadline watchdog, as at every compile-event close
        check_current()
        return out

    def _note_build(self, seconds: float) -> None:
        """The step cache built a step (a miss): book it as the fragment's
        `trace` phase, unless a window already holds the time."""
        if not self._window_depth and self._current_fid >= 0:
            self.profile.add_phase(self._current_fid, "trace", seconds)

    def _host_pull(self, *vals):
        """The runner's small device -> host reads, in one transfer."""
        with self._phase("transfer"):
            out = [v.cpu().numpy() for v in vals]
        return out if len(out) > 1 else out[0]

    def _gather(self, stacked: Batch, purpose: str) -> Batch:
        """Gather a stacked batch's live rows to one batch (a transfer)."""
        stacked = self._gather_compact(stacked)
        with self._phase("transfer"):
            host = unstack_batch(stacked)
        nbytes = batch_bytes(host)
        if self._current_fid >= 0:
            self.profile.fragment(self._current_fid).bytes_to_host += nbytes
            self.profile.add_collective(self._current_fid, nbytes, "gather", purpose)
        return host

    def _broadcast(self, stacked: Batch) -> Batch:
        """The all-gather (parallel/exchange.broadcast), as a collective
        phase of the executing fragment."""
        with self._phase("collective"):
            out = ex.broadcast(stacked, self.wm)
        if self._current_fid >= 0:
            self.profile.add_collective(
                self._current_fid, batch_bytes(out), "all_gather", "broadcast"
            )
        return out

    def _stack(self, batches, cap: Optional[int] = None) -> Batch:
        """Stack per-worker batches onto the mesh (a transfer)."""
        with self._phase("transfer"):
            stacked = stack_batches(batches, self.wm, cap=cap)
        if self._current_fid >= 0:
            self.profile.fragment(self._current_fid).bytes_to_device += batch_bytes(stacked)
        return stacked

    def _dist(self, stacked: Batch, symbols: list, placements: tuple = (),
              realigned: bool = False, unaligned: frozenset = frozenset()) -> _Dist:
        return _Dist(
            stacked, symbols, ex=self, placements=placements, realigned=realigned,
            unaligned=unaligned,
        )

    def _run_chain(self, stacked: Batch, pending: list) -> Batch:
        """Run a deferred step chain once per worker."""
        keys = tuple(k for k, _ in pending)
        steps = [s for _, s in pending]

        def build():
            def chain(b: Batch) -> Batch:
                for s in steps:
                    b = s(b)
                return b

            return chain

        return cached_spmd_step(self.wm, ("chain",) + keys, build)(stacked)

    # -- public ---------------------------------------------------------------

    def run(self, sub: SubPlan) -> PhysicalPlan:
        """Run every stage of `sub`.  While it runs, this thread's step
        launches go through `_call` and the step cache's builds through
        `_note_build`."""
        from trino_tpu_torch.parallel.spmd import set_launch_hook

        self._register(sub)
        prev_hook = set_launch_hook(
            lambda fn, args, phase: self._call(fn, args, phase)
        )
        prev_build = TRACE_CACHE.on_build
        TRACE_CACHE.on_build = self._note_build
        try:
            out = self._fragment_result(sub.fragment.id)
            if isinstance(out, _Dist):  # defensive: the root should be SINGLE
                self._current_fid = sub.fragment.id
                host = self._gather(out.stacked, "result_gather")
                self.bump("result_gather")
                self._current_fid = -1
                return PhysicalPlan(iter([host]), out.symbols)
            return out
        finally:
            set_launch_hook(prev_hook)
            TRACE_CACHE.on_build = prev_build
            self._finalize_profile()
            # every _Dist points back at this executor: drop the stage
            # outputs now, or the cycles keep their device tensors alive
            # until the garbage collector next runs
            self._results.clear()
            if self.spool is not None:
                self.spool.close()

    def _finalize_profile(self) -> None:
        """The step cache's hits and misses during the run, each fragment's
        kind, and the `other` phase that closes each fragment's wall."""
        from trino_tpu_torch.telemetry.metrics import query_retraces_counter

        prof = self.profile
        h0, m0, r0 = self._trace_base
        prof.trace_hits = TRACE_CACHE.hits - h0
        prof.trace_misses = TRACE_CACHE.misses - m0
        prof.retraces = TRACE_CACHE.retraces - r0
        if prof.retraces:
            query_retraces_counter().inc(prof.retraces)
        for fid, sub in self._subplans.items():
            if fid in prof.fragments:
                prof.fragments[fid].kind = str(sub.fragment.partitioning)
        for st in prof.fragments.values():
            st.close()

    # -- stage orchestration --------------------------------------------------

    def _register(self, sub: SubPlan) -> None:
        self._subplans[sub.fragment.id] = sub
        for c in sub.children:
            self._register(c)

    def _fragment_result(self, fid: int):
        """Stage output: a _Dist, or ('host', batches, symbols) for SINGLE
        fragments (materialized so several consumers can re-read it).
        Under retry_policy = TASK each stage is a retryable unit: a
        distributed stage's output is spooled host-side and rehydrated for
        each consumer, a failed stage re-executes alone, and finished
        children are never re-run."""
        if fid not in self._results:
            res = self._run_stage(fid)
            if isinstance(res, _Dist) and self.spool is not None:
                # the spool IS the stage-output store: the device copy is
                # released, consumers rehydrate on demand
                self._results[fid] = ("spooled",)
            else:
                self._results[fid] = res
        res = self._results[fid]
        if res == ("spooled",):
            return self._load_spooled(fid)
        if isinstance(res, tuple):
            return PhysicalPlan(iter(res[1]), res[2])
        return res

    def _run_stage(self, fid: int):
        from trino_tpu_torch.runtime.retry import (
            FAILURE_INJECTOR,
            RETRYABLE,
            StageFailedException,
        )

        sub = self._subplans[fid]
        attempts = self.TASK_ATTEMPTS if self.retry_task else 1
        last = None
        prev_fid, prev_depth = self._current_fid, self._window_depth
        self._current_fid, self._window_depth = fid, 0
        self._frame_stack.append({"child_s": 0.0})
        t0 = now()
        try:
            with self.profile.tracer.span(
                f"fragment-{fid}", kind=str(sub.fragment.partitioning)
            ):
                # outside the attempt loop: a retry never pre-dispatches
                # again (the licensed children are memoized or spooled)
                self._predispatch(fid)
                for attempt in range(attempts):
                    check_current()  # fragment-boundary cancellation point
                    try:
                        FAILURE_INJECTOR.maybe_fail(f"stage:{fid}")
                        if sub.fragment.partitioning.kind in _DIST_KINDS:
                            res = self._exec(sub.fragment.root)
                        else:
                            out = self._local_fragment(sub)
                            res = ("host", list(out.stream), out.symbols)
                        # fires after the body ran (children memoized or
                        # spooled): a failure here retries ONLY this stage
                        FAILURE_INJECTOR.maybe_fail(f"stage:{fid}:finish")
                        self._spool(fid, res, attempt)
                        # fires after the attempt's output is durably
                        # spooled: the retry then spools a duplicate
                        # attempt, which the consumer's dedup discards
                        FAILURE_INJECTOR.maybe_fail(f"stage:{fid}:spooled")
                        return res
                    except RETRYABLE as e:
                        last = e
                        if self.retry_task and attempt + 1 < attempts:
                            self._record_recovery(fid, e, "retry")
                if not self.retry_task:
                    # keep the original (QUERY-level retryable) error
                    raise last
                self._record_recovery(fid, last, "fail")
                raise StageFailedException(
                    f"stage {fid} failed after {attempts} attempts: {last}"
                ) from last
        finally:
            elapsed = now() - t0
            frame = self._frame_stack.pop()
            self.profile.fragment(fid).wall_s += elapsed - frame["child_s"]
            if self._frame_stack:
                self._frame_stack[-1]["child_s"] += elapsed
            self._excl_s += elapsed
            self._current_fid, self._window_depth = prev_fid, prev_depth

    # -- spooled stage outputs (ExchangeManager role) -------------------------

    def _record_recovery(self, fid: int, exc: BaseException, outcome: str) -> None:
        """Book one task-recovery decision: the {outcome} retry metric plus
        a `recovery` entry in the plan-decision ledger."""
        from trino_tpu_torch.runtime.lifecycle import error_code_of
        from trino_tpu_torch.telemetry.metrics import task_retries_counter

        task_retries_counter().labels(outcome).inc()
        record_decision(
            "recovery", f"stage:{fid}", outcome,
            "fail" if outcome == "retry" else "retry",
            {"error_code": error_code_of(exc), "fragment": int(fid)},
        )

    def _spool(self, fid: int, res, attempt_id: int = 0) -> None:
        """Persist a distributed stage's output host-side, keyed by the
        attempt that produced it.  Only _Dist results spool (a stacked
        batch shares one dictionary per column across workers, so the
        rehydration is exact); SINGLE-fragment results stay in the memo.
        The stacked [W, cap] batch crosses to the host once, one copy per
        plane, and is split per worker there (the spooled page files of
        FileSystemExchangeSink)."""
        if self.spool is None or not isinstance(res, _Dist):
            return
        from trino_tpu_torch.telemetry.metrics import spooled_fragments_counter

        stacked = res.stacked  # a deferred chain runs as its own launches
        t0 = time.perf_counter()
        with self._phase("transfer"):
            host = stacked.to("cpu")
        nbytes = batch_bytes(host)
        self.bump("spool_write")
        spooled_fragments_counter().inc()
        self.profile.fragment(fid).bytes_to_host += nbytes
        shards = [shard(host, w) for w in range(self.wm.n)]
        dicts = [c.dictionary for c in stacked.columns]
        self.spool.save(self.query_id, fid, shards, res.symbols, attempt_id=attempt_id)
        self._spool_meta[fid] = (
            res.symbols, dicts, res.placements, res.realigned, res.unaligned
        )
        self.spool_stats["bytes_written"] += nbytes
        self.spool_stats["spool_s"] += time.perf_counter() - t0

    def _load_spooled(self, fid: int) -> _Dist:
        """Rehydrate a spooled stage output worker for worker onto the
        mesh's device, so its placements survive the host round trip.
        Consumer-side dedup (DeduplicatingDirectExchangeBuffer): the FIRST
        committed attempt wins for every consumer of this fragment, and
        the losing duplicate attempts are deleted unread."""
        t0 = time.perf_counter()
        symbols, dicts, placements, realigned, unaligned = self._spool_meta[fid]
        att = self.spool.dedup.committed(self.query_id, fid)
        if att is None:
            atts = self.spool.attempts(self.query_id, fid)
            att = self.spool.dedup.commit(self.query_id, fid, atts[0] if atts else 0)
            self.dedup_discards += self.spool.discard_duplicates(
                self.query_id, fid, att
            )
        shards = self.spool.load(self.query_id, fid, symbols, dicts, attempt_id=att)
        self.bump("spool_read")
        with self._phase("transfer"):
            stacked = stack_shards([b.to(self.wm.device) for b in shards])
        self.spool_stats["bytes_read"] += batch_bytes(stacked)
        self.spool_stats["load_s"] += time.perf_counter() - t0
        return self._dist(
            stacked, symbols, placements=placements, realigned=realigned,
            unaligned=unaligned,
        )

    def _predispatch(self, fid: int) -> None:
        """Schedule-licensed eager dispatch: run this fragment's licensed
        build-side children, back to back, before its body.  They are
        sync-free and divergence-free by the license, and sit on the
        body's first-evaluated spine, so the lazy order would run them
        before any of this body's dynamic filters register."""
        if self.schedule is None:
            return
        from trino_tpu_torch.telemetry.metrics import collective_async_counter

        for cfid in self.schedule.async_children.get(fid, ()):
            if cfid in self._results or cfid not in self._subplans:
                continue
            self._fragment_result(cfid)
            self.bump("collective_async")
            collective_async_counter().inc()

    def _local_fragment(self, sub: SubPlan) -> PhysicalPlan:
        """SINGLE/COORDINATOR_ONLY fragment: the local engine over gathered
        inputs (the final/coordinator stage of the reference)."""
        lp = LocalExecutionPlanner(
            self.catalogs,
            self.wm.device,
            target_splits=self.properties.get("target_splits"),
            properties=self.properties,
        )
        saved = lp.plan
        executor = self

        def plan_hook(node: P.PlanNode) -> PhysicalPlan:
            if isinstance(node, RemoteSourceNode):
                return executor._remote_as_host(node)
            if (
                isinstance(node, P.AggregationNode)
                and isinstance(node.source, RemoteSourceNode)
                and node.source.exchange_kind == "gather"
                and not node.group_symbols
                and not any(
                    a.distinct or a.function in HOLISTIC_AGGS
                    for _, a in node.aggregations
                )
            ):
                # global aggregation over a distributed child: partial states
                # per worker, gather the single state rows, merge — never
                # gather raw rows
                child = executor._raw_remote(node.source)
                if isinstance(child, _Dist):
                    return executor._global_agg(node, child)
            return saved(node)

        lp.plan = plan_hook
        return lp.plan(sub.fragment.root)

    # -- exchanges ------------------------------------------------------------

    def _register_dynamic_filters(self, criteria, build: _Dist) -> None:
        """Record build-side key min/max under the probe symbol names.
        Dictionary-coded, float and limb-plane keys are skipped.  All
        summaries reduce in one per-worker step and cross to the host in one
        transfer."""
        pairs = []  # (probe name, channel)
        # materialize pending steps first: deferred projections may have
        # changed a key column's dictionary, which the skip check reads
        stacked = build.stacked
        for lsym, rsym in criteria:
            try:
                chn = build.channel(rsym.name)
            except KeyError:
                continue
            col = stacked.columns[chn]
            if (
                col.dictionary is not None
                or col.data.is_floating_point()
                or col.data.ndim > 2
            ):
                continue
            pairs.append((lsym.name, chn))
        if not pairs:
            return
        chans = tuple(ch for _, ch in pairs)

        def build_step():
            def step(b: Batch):
                big = torch.iinfo(torch.int64).max
                outs = []
                for chn in chans:
                    c = b.columns[chn]
                    live = b.mask()
                    if c.valid is not None:
                        live = torch.logical_and(live, c.valid)
                    d = c.data.to(torch.int64)
                    outs.append(
                        torch.stack(
                            [
                                torch.where(live, d, big).min(),
                                torch.where(live, d, -big).max(),
                                live.sum(dtype=torch.int64),
                            ]
                        )
                    )
                return torch.stack(outs)  # [k, 3]

            return step

        fn = cached_spmd_step(
            self.wm, ("dynfilters", chans, _sig(build.symbols)), build_step
        )
        summ = self._host_pull(fn(stacked))
        self.bump("dynamic_filter_sync")
        self.profile.add_collective(
            self._current_fid, int(summ.nbytes), "reduce", "dynamic_filter"
        )
        # [W, k, 3] -> per-criterion global (lo, hi, n)
        for i, (name, _) in enumerate(pairs):
            lo = int(summ[:, i, 0].min())
            hi = int(summ[:, i, 1].max())
            n = int(summ[:, i, 2].sum())
            if n == 0:
                continue
            self.dynamic_filters[name] = (lo, hi)

    def _raw_remote(self, node: RemoteSourceNode):
        """Child fragment result WITHOUT the exchange applied."""
        return self._fragment_result(node.fragment_id)

    def _compact_live(self, batch: Batch, tag, history_key=None) -> Batch:
        """Compact a stacked batch to the pow2 bucket of the max per-worker
        live count (one [W] host read).  `history_key` also records the live
        bucket into CapacityHistory, so a licensed join's compaction teaches
        the capacity-economy policy the tight width."""
        cap = trailing_cap(batch)
        live = self._host_pull(batch.mask().sum(dim=-1))
        if history_key is not None:
            CAP_HISTORY.record(
                history_key, next_pow2(max(1, int(live.max())), floor=1024)
            )
        cap2 = bucket_cap(int(live.max()), floor=64)
        if cap2 >= cap:
            return batch

        def build():
            def step(b: Batch) -> Batch:
                return b.compact_device(out_capacity=cap2)

            return step

        return cached_spmd_step(self.wm, (tag, cap2), build)(batch)

    def _gather_compact(self, stacked: Batch) -> Batch:
        """Compact to the live bucket before a gather, so the gather moves
        data, not dead capacity."""
        if trailing_cap(stacked) <= 64:
            return stacked
        return self._compact_live(stacked, "gather_compact")

    def _remote_as_host(self, node: RemoteSourceNode) -> PhysicalPlan:
        """Apply a gather/merge exchange into the coordinator's batches."""
        child = self._raw_remote(node)
        if isinstance(child, PhysicalPlan):
            return child
        if node.exchange_kind == "merge":
            batch = self._merge_gather(child, node)
        else:
            batch = self._gather(child.stacked, "host_gather")
        self.bump("host_gather")
        return PhysicalPlan(iter([batch]), child.symbols)

    def _merge_gather(self, child: _Dist, node: RemoteSourceNode) -> Batch:
        """Merge exchange: per-worker sorted shards -> one ordered batch
        (MergeOperator role).  The merge runs on the host."""
        from trino_tpu_torch.ops.merge import merge_sorted_shards

        # compaction is stable, so the per-worker sorted runs stay sorted
        stacked = self._gather_compact(child.stacked)
        keys = [
            SortKey(child.channel(s.name), asc, nf)
            for s, asc, nf in node.orderings
        ]
        n_live = self._host_pull(stacked.mask().sum(dim=-1))
        shards = []
        with self._phase("transfer"):
            for w in range(self.wm.n):
                # partial sorts put dead rows last: the live prefix is the
                # shard
                shards.append(_slice_host(stacked, w, int(n_live[w])))
        nbytes = sum(batch_bytes(b) for b in shards)
        self.profile.fragment(self._current_fid).bytes_to_host += nbytes
        self.profile.add_collective(self._current_fid, nbytes, "gather", "host_gather")
        return merge_sorted_shards(shards, keys).to(self.wm.device)

    def _remote_as_dist(self, node: RemoteSourceNode) -> _Dist:
        """Apply a repartition/broadcast exchange into a stacked batch.
        The application runs under the placer decision's scope (the child's
        execution stays outside it — nested exchanges scope themselves), so
        the collective's bytes join the recorded choice."""
        stacked = self._to_stacked(self._raw_remote(node))
        with decision_scope(node.decision_id):
            return self._apply_dist_exchange(node, stacked)

    def _apply_dist_exchange(self, node: RemoteSourceNode, stacked: _Dist) -> _Dist:
        if node.exchange_kind == "broadcast":
            # ship live rows, not static capacity: compaction is stable, so
            # row order is preserved
            bs = stacked.stacked
            if trailing_cap(bs) > 64:
                bs = self._compact_live(bs, "broadcast_compact")
            return self._dist(self._broadcast(bs), stacked.symbols, realigned=True)
        if node.exchange_kind == "repartition":
            names = tuple(s.name for s in node.partition_symbols)
            # runtime exchange elision: the producing fragment's output is
            # already placed on (a subset of) the requested keys
            if self.colocate and any(
                t and set(t) <= set(names) for t in stacked.placements
            ):
                self.bump("exchange_elided")
                observe_decision(node.decision_id, elided=1)
                return stacked
            chans = [stacked.channel(s.name) for s in node.partition_symbols]
            return self._repartition_side(stacked, chans)
        raise NotImplementedError(
            f"exchange {node.exchange_kind} feeding a distributed fragment"
        )

    def _to_stacked(self, result) -> _Dist:
        if isinstance(result, _Dist):
            return result
        batches = list(result.stream)
        if not batches and result.symbols:
            # a coordinator fragment that produced no batch (a cross join
            # over an empty side): one dead row of its layout, so the
            # consuming stage sees an empty input, not a missing one.  The
            # JAX package raises here.
            dev = self.wm.device
            batches = [
                Batch(
                    [null_column(s.type, 1, dev) for s in result.symbols],
                    torch.zeros(1, dtype=torch.bool, device=dev),
                )
            ]
        host = concat_batches(batches) if batches else None
        if host is None or not host.width:
            raise NotImplementedError("empty single-fragment feed")
        stacked = self._stack([host] + [None] * (self.wm.n - 1))
        # a coordinator batch re-entered the mesh mid-query
        self.bump("host_restack")
        return self._dist(stacked, result.symbols, realigned=True)

    # -- distributed node execution -------------------------------------------

    def _exec(self, node: P.PlanNode):
        m = getattr(self, "_x_" + type(node).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"distributed {type(node).__name__}: not ported yet"
            )
        return m(node)

    def _x_RemoteSourceNode(self, node: RemoteSourceNode) -> _Dist:
        return self._remote_as_dist(node)

    def _x_TableScanNode(self, node: P.TableScanNode) -> _Dist:
        from trino_tpu_torch.connectors.api import scan_predicate_triples
        from trino_tpu_torch.ops.scan import ScanOperator
        from trino_tpu_torch.runtime.buffer_pool import POOL, BufferPool

        connector = self.catalogs.get(node.handle.catalog)
        names = [c for _, c in node.assignments]
        types = [s.type for s, _ in node.assignments]
        symbols = [s for s, _ in node.assignments]
        splits = list(
            connector.splits(
                node.handle,
                target_splits=self.wm.n,
                predicate=scan_predicate_triples(node),
            )
        )
        page_rows = self.properties.get("page_rows")
        use_cache = self.properties.get("scan_cache")
        # bucketed layout: shard rows by the exchange hash of the bucket
        # columns instead of round-robin splits, so the scan output IS a
        # repartition-on-those-keys placement (the co-located join feed)
        part = (
            scan_partitioning(node, self.layouts, self.wm.n)
            if self.colocate
            else None
        )
        placements = (part[1],) if part is not None else ()

        # device-resident stacked-scan cache: a warm mesh query reuses the
        # [W, cap] batch already on the device — no host -> device bytes
        version = connector.scan_version(node.handle) if use_cache else None
        cache_key = None
        if version is not None and splits:
            cache_key = (
                "mesh_scan",
                mesh_key(self.wm),
                # layout in the key: the same splits shard differently once
                # a layout is declared (or colocated_join flips)
                None if part is None else ("layout",) + part[1] + part[2],
                tuple(
                    BufferPool.split_key(s, names, page_rows, version)
                    for s in splits
                ),
            )
            cached = POOL.get_device(cache_key)
            if cached is not None:
                self.bump("scan_cache_hit")
                return self._scan_filters(
                    node,
                    self._dist(cached[0], symbols, placements=placements,
                               realigned=part is not None),
                )
            self.bump("scan_cache_miss")

        from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR

        per_worker: list = [[] for _ in range(self.wm.n)]
        for i, split in enumerate(splits):
            # a split read that fails fails its stage, which TASK retries
            FAILURE_INJECTOR.maybe_fail(
                f"scan:{node.handle.schema}.{node.handle.table}:{split.seq}"
            )
            op = ScanOperator(
                connector, split, names, types, torch.device("cpu"),
                page_rows=page_rows, use_cache=use_cache,
            )
            per_worker[0 if part is not None else i % self.wm.n].extend(
                op.host_batches()
            )
        if part is not None and per_worker[0]:
            host_batches = self._bucketize_host(concat_batches(per_worker[0]), part[2])
        else:
            host_batches = [(concat_batches(bs) if bs else None) for bs in per_worker]
        if all(b is None for b in host_batches):
            cols = [
                Column.from_numpy(np.zeros(1, dtype=t.np_dtype), t, np.zeros(1, bool))
                for t in types
            ]
            host_batches[0] = Batch(cols, torch.zeros(1, dtype=torch.bool))
        stacked = self._stack(host_batches)
        if cache_key is not None:
            POOL.put_device(cache_key, [stacked])
        return self._scan_filters(
            node,
            self._dist(stacked, symbols, placements=placements,
                       realigned=part is not None),
        )

    def _bucketize_host(self, host: Batch, key_channels: tuple) -> list:
        """Split one host batch into per-worker shards by the layout hash
        (the numpy mirror of the exchange hash, partitioning/layout.py), so
        the stacked scan output is exactly what a hash repartition on the
        bucket columns would have produced."""
        self.bump("scan_bucketize")
        dest = bucket_rows(host, key_channels, self.wm.n)
        out = []
        for w in range(self.wm.n):
            idx = np.nonzero(dest == w)[0]
            out.append(_take_host(host, idx) if idx.size else None)
        return out

    def _scan_filters(self, node: P.TableScanNode, out: _Dist) -> _Dist:
        """Defer the pushed predicate + dynamic-filter pruning onto the scan
        output (they run in the consumer's chain)."""
        from trino_tpu_torch.runtime.local_planner import _range_expr

        if node.pushed_predicate is not None:
            pred = out.rewrite(node.pushed_predicate)
            step = FilterProjectOperator(
                pred, [InputRef(i, s.type) for i, s in enumerate(out.symbols)]
            )._make_step()
            out = out.defer(("scan_pred", pred.key(), _sig(out.symbols)), step)
        # dynamic filters from already-completed build fragments prune this
        # scan's feed (reference: DynamicFilterService -> split pruning)
        dyn = []
        ranges = []
        for s, _ in node.assignments:
            rng = self.dynamic_filters.get(s.name)
            if rng is not None:
                dyn.append(out.rewrite(_range_expr(s, *rng)))
                ranges.append((s.name, rng))
        if dyn:
            step = FilterProjectOperator(
                and_(*dyn),
                [InputRef(i, s.type) for i, s in enumerate(out.symbols)],
            )._make_step()
            out = out.defer(("dyn_filter", tuple(ranges), _sig(out.symbols)), step)
        return out

    def _x_FilterNode(self, node: P.FilterNode) -> _Dist:
        src = self._exec(node.source)
        pred = src.rewrite(node.predicate)
        step = FilterProjectOperator(
            pred, [InputRef(i, s.type) for i, s in enumerate(src.symbols)]
        )._make_step()
        return src.defer(("filter", pred.key(), _sig(src.symbols)), step)

    def _x_ProjectNode(self, node: P.ProjectNode) -> _Dist:
        from trino_tpu_torch.expr.ir import SymbolRef

        src = self._exec(node.source)
        exprs = [src.rewrite(e) for _, e in node.assignments]
        step = FilterProjectOperator(None, exprs)._make_step()
        # placements rename through identity refs; a placement column the
        # projection drops loses its placement claim
        rename: dict = {}
        for s, e in node.assignments:
            if isinstance(e, SymbolRef):
                rename.setdefault(e.name, s.name)
        placements = tuple(
            tuple(rename[n] for n in t)
            for t in src.placements
            if t and all(n in rename for n in t)
        )
        # an output column is off the split alignment when any column it
        # reads is
        unaligned = frozenset(
            s.name for s, e in node.assignments
            if collect_symbol_names(e, set()) & src.unaligned
        )
        return src.defer(
            ("project", tuple(e.key() for e in exprs), _sig(src.symbols)),
            step,
            symbols=[s for s, _ in node.assignments],
            placements=placements,
            unaligned=unaligned,
        )

    # -- aggregation ----------------------------------------------------------

    def _agg_partial(self, node: P.AggregationNode, src: _Dist):
        """Per-worker PARTIAL step fused onto the source's deferred chain;
        returns (stacked states, specs, op).  The states are then compacted
        to the live-group bucket so the exchange moves states, not dead
        capacity."""
        from trino_tpu_torch.runtime.local_planner import build_agg_inputs

        ngroups = len(node.group_symbols)
        proj, specs, input_types = build_agg_inputs(node, src)
        pre = FilterProjectOperator(None, proj)._make_step()
        partial_op = AggregationOperator(
            list(range(ngroups)), specs, input_types, self.wm.device,
            mode="partial",
        )
        part_cap = next_pow2(src.cap, floor=1) if ngroups else 1

        def partial_step(b: Batch) -> Batch:
            return partial_op._reduce_step(pre(b), out_cap=part_cap)

        key = (
            "agg_partial",
            tuple(e.key() for e in proj),
            _spec_sig(specs),
            part_cap,
            _sig(src.symbols),
        )
        states = self._run_chain(src._stacked, src.pending + [(key, partial_step)])
        if ngroups:
            states = self._compact_live(states, "state_compact")
        return states, specs, partial_op

    def _final_op(self, specs, partial_op, states) -> AggregationOperator:
        state_types = [c.type for c in states.columns]
        merge_specs = [
            AggSpec(
                s.name, partial_op._state_channel(i), s.out_type,
                sum_bound=s.sum_bound, param=s.param,
            )
            for i, s in enumerate(specs)
        ]
        ngroups = len(partial_op.group_channels)
        return AggregationOperator(
            list(range(ngroups)), merge_specs, state_types, self.wm.device,
            mode="final",
        )

    def _x_AggregationNode(self, node: P.AggregationNode) -> _Dist:
        if not isinstance(node.source, RemoteSourceNode):
            # exchange elided by the placer: the child is placed on a subset
            # of the grouping keys, so every group is whole on one worker
            return self._colocated_agg(node, self._exec(node.source))
        src = self._to_stacked(self._raw_remote(node.source))
        ngroups = len(node.group_symbols)
        assert ngroups, "grouped aggregation expected in distributed fragment"
        if any(
            a.distinct or a.function in PARTITIONABLE_HOLISTIC
            for _, a in node.aggregations
        ):
            # repartition the raw rows on the group keys so every group is
            # whole on one worker, then aggregate there in one stage (a
            # uniform DISTINCT dedupes first): no partial/merge states, no
            # coordinator gather
            with decision_scope(node.source.decision_id):
                return self._spmd_single_stage(node, src)
        states, specs, partial_op = self._agg_partial(node, src)
        self.bump("agg_partial_states")
        final_op = self._final_op(specs, partial_op, states)
        # fused exchange: bucketize + all-to-all + the FINAL aggregation
        chans = list(range(ngroups))
        cap_s = trailing_cap(states)
        cert = getattr(node, "capacity_cert", None)
        slot_cap = None
        if self.license_caps and cert is not None and cert.valid_for(self.wm.n):
            # group-count license: the partial agg emits at most one state
            # row per group per worker, so no worker sends more than
            # group_bound rows to any destination — a proven slot cap with
            # no [W, W] counts read, accepted only when it does not inflate
            # the [W, W * slot] final footprint
            licensed = next_pow2(min(int(cert.group_bound), cap_s), floor=64)
            if self.wm.n * licensed <= max(64 * self.wm.n, cap_s):
                slot_cap = licensed
                self.bump("agg_slot_cap_proven")
        if slot_cap is None:
            slot_cap = ex.exchange_slot_cap(states, chans, self.wm)
        fcap = self.wm.n * slot_cap
        # the fused exchange materializes a [W, fcap] output beside the
        # input states: reserve that footprint BEFORE dispatching; over
        # budget the exchange and the final step run in group-hash waves
        from trino_tpu_torch.runtime import spill as _spill
        from trino_tpu_torch.runtime.memory import (
            ExceededMemoryLimitException,
            batch_bytes,
        )

        s_bytes = batch_bytes(states)
        row_bytes = max(1, s_bytes // max(1, self.wm.n * cap_s))
        need = s_bytes + self.wm.n * fcap * row_bytes
        ctx = self.memory.child("agg_final")
        wave_k = 0
        try:
            ctx.add_bytes(need)
        except ExceededMemoryLimitException:
            wave_k = _spill.wave_count(need, self._budget(), self.properties)
        if wave_k:
            wdid = record_decision(
                "wave", "runtime.agg_final", "waves", "direct",
                {"waves": int(wave_k), "need_bytes": int(need),
                 "budget_bytes": int(self._budget() or 0)},
            )
            with decision_scope(wdid):
                out = self._wave_agg_exchange(
                    node, states, chans, final_op, specs, wave_k, ctx
                )
        else:
            def final_step(b: Batch) -> Batch:
                return final_op._reduce_step(b, out_cap=fcap)

            with decision_scope(node.source.decision_id):
                out = ex.fused_repartition(
                    states, chans, self.wm, final_step,
                    ("agg_final", _spec_sig(specs), fcap, _sig(node.outputs)),
                    slot_cap,
                )
                self.profile.add_collective(
                    self._current_fid, batch_bytes(states), "all_to_all", "repartition"
                )
            ctx.close()
        return self._dist(
            out, node.outputs,
            placements=((tuple(s.name for s in node.group_symbols),)),
            realigned=True,
        )

    def _wave_agg_exchange(self, node, states, chans, final_op, specs,
                           n_waves: int, ctx) -> Batch:
        """Group-hash waves of the aggregation's fused exchange
        (HashAggregationOperator.startMemoryRevoke on the mesh): each wave
        keeps the partial states whose exchange row hash lands in it, runs
        the same fused repartition + final step at the wave's (smaller)
        slot bucket, and the wave outputs concatenate.  Hashing the whole
        group key keeps every group inside one wave, so results are exact;
        the exchange output's peak footprint shrinks about k-fold."""
        from trino_tpu_torch.runtime import spill as _spill
        from trino_tpu_torch.runtime.memory import batch_bytes

        _spill.PressureObserver(sink=self).waves("aggregation", n_waves)
        cap_s = trailing_cap(states)
        keys = tuple(chans)

        def build_filter(wave):
            def step(b: Batch) -> Batch:
                h = ex._hash_rows(b, keys)
                return b.filter(
                    torch.logical_and(b.mask(), ex.unsigned_mod(h, n_waves) == wave)
                )

            return step

        outs = []
        for wave in range(n_waves):
            fn = cached_spmd_step(
                self.wm,
                ("agg_wave_filter", n_waves, wave, keys, cap_s, _sig(node.outputs)),
                lambda w=wave: build_filter(w),
            )
            filt = fn(states)
            slot_w = ex.exchange_slot_cap(filt, chans, self.wm)
            fcap_w = self.wm.n * slot_w
            _spill.reserve_wave_working_set(ctx, batch_bytes(filt))

            def final_step(b: Batch, fc=fcap_w) -> Batch:
                return final_op._reduce_step(b, out_cap=fc)

            outs.append(
                ex.fused_repartition(
                    filt, chans, self.wm, final_step,
                    ("agg_final", _spec_sig(specs), fcap_w, _sig(node.outputs)),
                    slot_w,
                )
            )
            self.profile.add_collective(
                self._current_fid, batch_bytes(filt), "all_to_all", "repartition"
            )
        ctx.close()
        return _concat_stacked(outs)

    def _colocated_agg(self, node: P.AggregationNode, src: _Dist) -> _Dist:
        """Single-stage grouped aggregation over an already-placed child (no
        exchange, no partial/final split), deferred onto the child chain."""
        from trino_tpu_torch.runtime.local_planner import build_agg_inputs

        ngroups = len(node.group_symbols)
        assert ngroups, "colocated aggregation needs grouping keys"
        proj, specs, input_types = build_agg_inputs(node, src)
        pre = FilterProjectOperator(None, proj)._make_step()
        op = AggregationOperator(
            list(range(ngroups)), specs, input_types, self.wm.device,
            mode="single",
        )
        out_cap = next_pow2(src.cap, floor=64)

        def step(b: Batch) -> Batch:
            return op._reduce_step(pre(b), out_cap=out_cap)

        self.bump("exchange_elided")
        gnames = {s.name for s in node.group_symbols}
        placements = tuple(t for t in src.placements if t and set(t) <= gnames)
        return src.defer(
            ("agg_colocated", tuple(e.key() for e in proj),
             _spec_sig(specs), out_cap, _sig(src.symbols)),
            step,
            symbols=node.outputs,
            cap=out_cap,
            placements=placements,
        )

    def _spmd_single_stage(self, node: P.AggregationNode, src: _Dist) -> _Dist:
        """Repartition on the group keys, then a per-worker single-stage
        aggregation (the mesh's home of the DISTINCT shapes and of the
        partitionable holistic aggregates; reference: single-step
        aggregation over hash distribution).  The dedupe pre-aggregation (a
        uniform DISTINCT) and the aggregation run as the exchange's
        consumer."""
        from trino_tpu_torch.runtime.local_planner import (
            build_agg_inputs,
            build_distinct_dedupe,
        )

        ngroups = len(node.group_symbols)
        key_channels = [src.channel(s.name) for s in node.group_symbols]
        stacked = src.stacked
        slot_cap = ex.exchange_slot_cap(stacked, key_channels, self.wm)
        fcap = self.wm.n * slot_cap
        agg_src = src
        dd_keys = ()
        dedupe = pre_dd = None
        if any(a.distinct for _, a in node.aggregations):
            dd_proj, dd_symbols = build_distinct_dedupe(node, src)
            dedupe = AggregationOperator(
                list(range(len(dd_proj))), [], [e.type for e in dd_proj],
                self.wm.device, mode="single",
            )
            pre_dd = FilterProjectOperator(None, dd_proj)._make_step()
            agg_src = PhysicalPlan(iter(()), dd_symbols)
            dd_keys = tuple(e.key() for e in dd_proj)
        proj, specs, input_types = build_agg_inputs(node, agg_src)
        op = AggregationOperator(
            list(range(ngroups)), specs, input_types, self.wm.device, mode="single"
        )
        pre_agg = FilterProjectOperator(None, proj)._make_step()

        def single_step(b: Batch) -> Batch:
            if dedupe is not None:
                b = dedupe._reduce_step(pre_dd(b), out_cap=fcap)
            return op._reduce_step(pre_agg(b), out_cap=fcap)

        out = ex.fused_repartition(
            stacked, key_channels, self.wm, single_step,
            ("agg_single", dd_keys, tuple(e.key() for e in proj),
             _spec_sig(specs), fcap, _sig(src.symbols)),
            slot_cap,
        )
        self.bump("repartition_collective")
        self.bump("agg_single_stage")
        self.profile.add_collective(
            self._current_fid, batch_bytes(stacked), "all_to_all", "repartition"
        )
        return self._dist(
            out, node.outputs,
            placements=((tuple(s.name for s in node.group_symbols),)),
            realigned=True,
        )

    def _global_agg(self, node: P.AggregationNode, src: _Dist) -> PhysicalPlan:
        """Global aggregation over a distributed child: partial per worker,
        gather the single state rows, final merge on the coordinator."""
        states, specs, partial_op = self._agg_partial(node, src)
        self.bump("agg_partial_states")
        final_op = self._final_op(specs, partial_op, states)
        gathered = unstack_batch(states)
        cap = next_pow2(gathered.capacity, floor=1)
        final = final_op._reduce_step(_pad_device(gathered, cap), out_cap=1)
        return PhysicalPlan(iter([final]), node.outputs)

    def _x_UnnestNode(self, node: P.UnnestNode) -> _Dist:
        """UNNEST per worker: the expansion is row-local, so it stays in its
        fragment.  Its output capacity (capacity * K) depends on the
        arrays' element width, so it runs at once rather than deferred."""
        from trino_tpu_torch.ops.unnest import UnnestOperator

        src = self._exec(node.source)
        exprs = [src.rewrite(e) for _, e in node.unnest]
        op = UnnestOperator(exprs, with_ordinality=node.ordinality is not None)
        fn = cached_spmd_step(
            self.wm,
            ("unnest", tuple(e.key() for e in exprs), node.ordinality is not None,
             _sig(src.symbols), src.cap),
            lambda: op.step,
        )
        return self._dist(
            fn(src.stacked), node.outputs, placements=src.placements,
            realigned=src.realigned, unaligned=src.unaligned,
        )

    def _x_MarkDistinctNode(self, node: P.MarkDistinctNode) -> _Dist:
        """The mark per worker: the fragmenter placed the source on the
        mark's keys, so every distinct key combination is whole on one
        worker."""
        from trino_tpu_torch.ops.aggregation import MarkDistinctOperator

        src = self._exec(node.source)
        chans = tuple(src.channel(s.name) for s in node.key_symbols)
        op = MarkDistinctOperator(list(chans))
        return src.defer(
            ("mark_distinct", chans, _sig(src.symbols)),
            op.mark_step,
            symbols=node.outputs,
            placements=src.placements,
        )

    def _x_WindowNode(self, node: P.WindowNode) -> _Dist:
        """The window per worker: the fragmenter repartitioned the source on
        the partition keys, so every partition is whole on one worker (a
        window with no PARTITION BY runs in a coordinator fragment).  The
        new columns are computed from their own row's partition, so they
        keep the rows' alignment: `unaligned` stays the source's."""
        from trino_tpu_torch.ops.window import WindowOperator

        src = self._exec(node.source)
        part, order, specs = window_args(node, src)
        op = WindowOperator(part, order, specs)
        return src.defer(
            ("window", tuple(part), tuple(repr(k) for k in order),
             tuple(repr(s) for s in specs), _sig(src.symbols)),
            op.step,
            symbols=node.outputs,
            placements=src.placements,
            unaligned=src.unaligned,
        )

    # -- joins ----------------------------------------------------------------

    def _unify_key_dicts(self, a: _Dist, ak, b: _Dist, bk):
        """Key columns compared across the two sides must share a dictionary
        (codes are ranks).  The host unions the dictionaries; a deferred
        gather recodes each side."""
        from trino_tpu_torch.columnar.dictionary import union_dictionaries

        def recode(dist: _Dist, ch: int, table, merged, dkey):
            tbl = torch.from_numpy(np.asarray(table, dtype=np.int32)).to(self.wm.device)

            def step(batch: Batch) -> Batch:
                cols = list(batch.columns)
                c = cols[ch]
                codes = c.data.to(torch.int64).clamp(0, tbl.shape[0] - 1)
                cols[ch] = Column(tbl[codes], c.type, c.valid, merged)
                return Batch(cols, batch.row_mask)

            return dist.defer(("recode", ch, dkey), step)

        for ca, cb in zip(ak, bk):
            # .stacked (not ._stacked): deferred steps may change dictionaries
            da = a.stacked.columns[ca].dictionary
            db = b.stacked.columns[cb].dictionary
            if da is None and db is None:
                continue
            if da is db or da == db:
                continue
            if da is None or db is None:
                raise NotImplementedError(
                    "join key mixes dictionary and plain strings"
                )
            merged, ta, tb = union_dictionaries(da, db)
            # key = (OWN dictionary, other): the two sides bake DIFFERENT
            # translation tables
            a = recode(a, ca, ta, merged, (hash(da), hash(db)))
            b = recode(b, cb, tb, merged, (hash(db), hash(da)))
        return a, b

    def _join_side(self, side_node):
        """One join input: a child-fragment result (exchange NOT applied)
        or an inline already-placed subtree (elided exchange)."""
        if isinstance(side_node, RemoteSourceNode):
            return self._to_stacked(self._raw_remote(side_node))
        return self._exec(side_node)

    def _place_join_side(self, side_node, side: _Dist, keys):
        """Apply (or elide) the partitioned-join repartition of one side."""
        if (
            isinstance(side_node, RemoteSourceNode)
            and side_node.exchange_kind == "repartition"
        ):
            syms = side_node.partition_symbols or keys
            return self._repartition_side(side, [side.channel(s.name) for s in syms])
        self.bump("exchange_elided")
        return side

    def _x_JoinNode(self, node: P.JoinNode) -> _Dist:
        assert node.distribution in ("broadcast", "partitioned", "colocated"), node
        probe_node, build_node = node.left, node.right
        # BUILD side first: its fragment completes before the probe side is
        # pulled, so build-key ranges can prune probe-side scans
        build = self._join_side(build_node)
        if node.kind == "inner":
            self._register_dynamic_filters(node.criteria, build)
        probe = self._join_side(probe_node)
        pk = [probe.channel(l.name) for l, _ in node.criteria]
        bk = [build.channel(r.name) for _, r in node.criteria]
        probe, build = self._unify_key_dicts(probe, pk, build, bk)
        out_symbols = probe.symbols + build.symbols
        residual = None
        residual_key = None
        if node.filter is not None:
            expr = PhysicalPlan(iter(()), out_symbols).rewrite(node.filter)
            residual_key = expr.key()

            def residual(batch: Batch, _e=expr):
                return ExprCompiler(batch).filter_mask(_e)

        did = node.decision_id
        if node.distribution == "broadcast":
            # compact to the live bucket before the all-gather (stable, so
            # the build-row order and the search's tie order are unchanged)
            bs = build.stacked
            with decision_scope(did):
                if trailing_cap(bs) > 64:
                    bs = self._compact_live(bs, "broadcast_compact")
                build_stacked = self._broadcast(bs)
        else:
            with decision_scope(did):
                build = self._place_join_side(
                    build_node, build, [r for _, r in node.criteria]
                )
                probe = self._place_join_side(
                    probe_node, probe, [l for l, _ in node.criteria]
                )
            build_stacked = build.stacked

        op = HashJoinOperator(
            node.kind, pk, bk,
            [s.type for s in build.symbols],
            probe_types=[s.type for s in probe.symbols],
            residual=residual,
        )
        cap_b = trailing_cap(build_stacked)
        search, use_kernel = self._probe_search()
        jkey = (
            node.kind, tuple(pk), tuple(bk), cap_b,
            _sig(probe.symbols), _sig(build.symbols), residual_key, use_kernel,
        )
        # capacity-history discriminator: two queries can share the join
        # signature while filtering the probe differently
        probe_fp = tuple(k for k, _ in probe.pending)
        probe_stacked = probe.stacked
        probe_types = [s.type for s in probe.symbols]
        if did is not None:
            # outcome inputs for the hindsight join (telemetry/decisions):
            # static-shape byte math only, no device sync.  build_bytes is
            # ONE logical build copy (a broadcast's stacked batch holds W
            # replicas); probe_move_bytes is what the rejected partitioned
            # plan would have moved for an unplaced probe
            bb = int(batch_bytes(build_stacked))
            observe_decision(
                did,
                build_bytes=(
                    bb // max(1, self.wm.n)
                    if node.distribution == "broadcast" else bb
                ),
                probe_move_bytes=(
                    0 if (node.distribution == "broadcast" and probe.placements)
                    else int(batch_bytes(probe_stacked))
                ),
            )
        # reserve the build's footprint (raw + sorted copy) BEFORE the
        # expansion materializes; over budget the join degrades to
        # hash-partition waves with spill instead of dying
        from trino_tpu_torch.runtime import spill as _spill
        from trino_tpu_torch.runtime.memory import ExceededMemoryLimitException

        ctx = self.memory.child("join_build")
        need = 2 * batch_bytes(build_stacked)
        wave_k = 0
        try:
            ctx.add_bytes(need)
        except ExceededMemoryLimitException:
            wave_k = _spill.wave_count(need, self._budget(), self.properties)
        if wave_k:
            wdid = record_decision(
                "wave", "runtime.join_build", "waves", "direct",
                {"waves": int(wave_k), "need_bytes": int(need),
                 "budget_bytes": int(self._budget() or 0)},
            )
            with decision_scope(wdid):
                out = self._wave_join(
                    node, op, probe_stacked, build_stacked, pk, bk, jkey,
                    probe_types, search, wave_k, ctx,
                )
        else:
            locate, device_emit_total, expand = self._join_step_fns(
                node, op, pk, bk, cap_b, probe_types, search
            )
            # proof-licensed capacity: a certificate sealed for THIS mesh
            # width licenses a fixed expand capacity; anything else (a
            # mesh shrink, the knob off, the waves above) takes the runtime
            # sizing path
            cert = getattr(node, "capacity_cert", None)
            if not (self.license_caps and cert is not None and cert.valid_for(self.wm.n)):
                cert = None
            out = self._sized_expansion(
                ("join",) + jkey, probe_stacked, build_stacked,
                locate, device_emit_total, expand, compact_probe=True,
                stats_key=("join",) + jkey + (probe_fp,),
                cert=cert,
            )
            ctx.close()
        return self._dist(
            out, out_symbols,
            placements=join_output_placements(
                probe.placements, node.criteria, node.kind
            ),
            realigned=probe.realigned or node.distribution != "broadcast",
            # a broadcast build's rows join wherever their probe matches sit
            unaligned=probe.unaligned | frozenset(s.name for s in build.symbols),
        )

    def _probe_search(self):
        """(search, use_kernel): the mesh's probe search over one worker's
        sorted build shard, fn(build canon, n_match, probe canon, probe
        nomatch, cap_b) -> (start, count), and the `pallas_probe` value it
        captured.  A single integer key plane per side takes the
        sorted-probe kernel (ops/locate_sorted.py): on the card the
        hand-written CUDA kernel, always; on the CPU its plain version, under
        `pallas_probe`.  Other keys take `_locate_sorted`.  Every closure
        that captures `search` keys its step cache on `use_kernel`."""
        use_kernel = bool(self.properties.get("pallas_probe"))

        def search(canon, n_match, pc, pn, cap_b: int):
            if (use_kernel or pn.is_cuda) and probe_kernel_eligible(canon, pc):
                return locate_sorted(canon[0], n_match, pc[0], pn, cap_b=cap_b)
            return _locate_sorted(canon, n_match, pc, pn, cap_b=cap_b)

        return search, use_kernel

    def _join_step_fns(self, node, op, pk, bk, cap_b: int, probe_types, search):
        """(locate, device_emit_total, expand) per-worker closures for one
        build capacity; `search` is `_probe_search`'s."""

        def device_emit_total(pb: Batch, count):
            """Per-worker emitted-row total, on the device."""
            live = pb.mask()
            emit = (
                torch.where(live, torch.clamp(count, min=1), 0)
                if node.kind in ("left", "full")
                else torch.where(live, count, 0)
            )
            return emit.sum(dtype=torch.int64)

        def locate(pb: Batch, bb: Batch):
            # per-shard PagesHash analog: sort THIS shard's build once, then
            # binary-search the probe keys against it
            sb, canon, n_match = _sort_build_device(bb, bk)
            pc, pn = _canon_probe_device(pb, pk, canon)
            start, count = search(canon, n_match, pc, pn, cap_b)
            return sb, start, count

        def expand(pb: Batch, sb: Batch, start, count, total, out_cap: int):
            matched0 = (
                torch.zeros(cap_b, dtype=torch.bool, device=start.device)
                if node.kind == "full" else None
            )
            out, matched = op._expand_step(
                pb, sb, start, count, matched0, out_cap=out_cap,
                cap_b=cap_b, total_emit=total,
            )
            if node.kind == "full":
                # per-shard unmatched-build tail: with PARTITIONED inputs
                # every build row lives on exactly one shard.  Its probe
                # columns are NULLs of the probe's shapes: a long decimal
                # takes both limb planes (the JAX mesh gives it one, and
                # its concatenation fails there)
                tail_live = torch.logical_and(sb.mask(), torch.logical_not(matched))
                ncols = []
                for t in probe_types:
                    nc = null_column(t, cap_b, start.device)
                    ncols.append(Column(nc.data, t, nc.valid, None))
                out = concat_batches([out, Batch(ncols + list(sb.columns), tail_live)])
            return out

        return locate, device_emit_total, expand

    def _wave_join(self, node, op, probe_stacked, build_stacked, pk, bk, jkey,
                   probe_types, search, n_waves: int, ctx) -> Batch:
        """Partition-wave join on the mesh (SpillingJoinProcessor): both
        stacked sides cross to the host, each worker shard hash-partitions
        by the row value hash into `n_waves` partitions (spilled through
        the filesystem under `spill_enabled`), and the join runs wave by
        wave at ONE shape bucket per side, so the same locate/expand steps
        serve every wave.  Worker-shard identity survives the spill, so
        each wave restacks onto the same alignment (a broadcast build's W
        copies stay W copies)."""
        from trino_tpu_torch.parallel.serde import partition_batches
        from trino_tpu_torch.runtime import spill as _spill
        from trino_tpu_torch.runtime.memory import batch_bytes

        observer = _spill.PressureObserver(sink=self)
        spiller = (
            _spill.SpillManager(observer=observer)
            if _spill.spill_to_disk(self.properties)
            else None
        )
        observer.waves("join", n_waves)
        W = self.wm.n
        try:
            # the spill tier's declared host boundary
            bh, ph = _spill.pull_host(build_stacked, probe_stacked)

            def shard_parts(host, keys):
                """([wave][worker] -> host Batch or None, dead template);
                partitioned PER worker shard."""
                shards = [shard(host, w) for w in range(W)]
                template = _dead_batch_like(shards[0])
                per_shard = [partition_batches([sh], list(keys), n_waves) for sh in shards]
                parts = [
                    [(per_shard[w][wave][0] if per_shard[w][wave] else None) for w in range(W)]
                    for wave in range(n_waves)
                ]
                return parts, template

            b_parts, b_dead = shard_parts(bh, bk)
            p_parts, p_dead = shard_parts(ph, pk)
            del bh, ph

            def side_cap(parts) -> int:
                rows = max(
                    (b.capacity for wave in parts for b in wave if b is not None),
                    default=1,
                )
                return next_pow2(max(rows, 1), floor=64)

            # one shape bucket per side for every wave
            cap_b = side_cap(b_parts)
            cap_p = side_cap(p_parts)

            def store(tag, parts):
                """Spill each wave's present shards; returns a loader of
                [worker] -> Batch or None."""
                if spiller is None:
                    return lambda wave: parts[wave]
                present: dict = {}
                for wave in range(n_waves):
                    real = [(w, b) for w, b in enumerate(parts[wave]) if b is not None]
                    present[wave] = [w for w, _ in real]
                    if real:
                        spiller.save(tag, wave, [b for _, b in real])
                    parts[wave] = None  # free RAM as waves land on disk

                def load(wave):
                    cells: list = [None] * W
                    for w, b in zip(present[wave], spiller.load(tag, wave)):
                        cells[w] = b
                    return cells

                return load

            b_load = store("jb", b_parts)
            p_load = store("jp", p_parts)

            locate, emit_total, expand = self._join_step_fns(
                node, op, pk, bk, cap_b, probe_types, search
            )
            wkey = ("join_wave", n_waves, cap_b, cap_p) + jkey

            def run_wave(b_cells, p_cells):
                build_w = self._stack(b_cells, cap=cap_b)
                probe_w = self._stack(p_cells, cap=cap_p)
                _spill.reserve_wave_working_set(ctx, 2 * batch_bytes(build_w))
                return self._sized_expansion(
                    wkey, probe_w, build_w, locate, emit_total, expand,
                    compact_probe=False, stats_key=wkey,
                )

            outs = []
            for wave in range(n_waves):
                b_cells = b_load(wave)
                p_cells = p_load(wave)
                if all(c is None for c in p_cells) and node.kind != "full":
                    continue  # no probe rows and no build tail: no output
                if all(c is None for c in b_cells):
                    b_cells[0] = b_dead  # an empty build wave still probes
                if all(c is None for c in p_cells):
                    p_cells[0] = p_dead  # full outer: a tail-only wave
                outs.append(run_wave(b_cells, p_cells))
            if not outs:
                # every wave empty: one dead wave gives the output its shape
                outs.append(
                    run_wave([b_dead] + [None] * (W - 1), [p_dead] + [None] * (W - 1))
                )
            ctx.close()
            return _concat_stacked(outs)
        finally:
            if spiller is not None:
                spiller.close()

    # -- capacity-sized expansions --------------------------------------------

    def _sized_expansion(self, key, probe_stacked, build_stacked,
                         locate, device_total, expand,
                         compact_probe: bool = False,
                         stats_key=None, cert=None) -> Batch:
        """Run a locate+expand pair whose output capacity depends on the
        data, under the `join_speculative_capacity` policy:

          * warm (capacity history holds the tight pow2 buckets measured
            before): ONE fused locate+expand pass at the recorded capacity
            with an on-device overflow flag, read after the fact; an
            overflow (changed data) retries at the next bucket.  With
            `compact_probe`, the pass first compacts the probe to its
            recorded live-row bucket, guarded by the same flag;
          * cold (no history) or speculation off: a sizing pass — locate,
            then one small [W, 2] read of the per-worker emitted total and
            live count picks the exact bucket for the expand.

        A capacity certificate (`cert`) supersedes the protocol: the proven
        per-probe-row fanout bounds the emitted total by the probe's static
        capacity, so the expand runs at the certified capacity with no
        sizing read, no overflow flag and no retry."""
        cap_p = trailing_cap(probe_stacked)
        spec = speculation_mode(self.properties)
        hist_key = ("cap",) + (stats_key if stats_key is not None else key)
        pkey = ("pcap",) + (stats_key if stats_key is not None else key)

        if cert is not None:  # proof-licensed fixed capacity
            if compact_probe and cap_p > 1024:
                # probe compaction at the host boundary: the certified cap
                # scales with the probe's STATIC width
                probe_stacked = self._compact_live(
                    probe_stacked, ("licensed_probe_compact",) + key,
                    history_key=pkey,
                )
                cap_p = trailing_cap(probe_stacked)
            oc = next_pow2(
                cert.licensed_out_cap(cap_p),
                floor=min(1024, next_pow2(cap_p, floor=1)),
            )
            # economy policy: hold a license only when its certified width
            # is near the widths the runtime path would span
            learned = max(
                CAP_HISTORY.guess(hist_key, 0), CAP_HISTORY.guess(pkey, 0)
            )
            declined = None
            if learned and oc > _LICENSE_WIDTH_FACTOR * learned:
                declined = f"width {oc} > {_LICENSE_WIDTH_FACTOR}x learned {learned}"
            elif not learned and oc > next_pow2(cap_p, floor=1024):
                # cold guard: with no history, accept only widths bounded
                # by the probe's own static capacity
                declined = f"cold width {oc} > probe capacity {cap_p}"
            cap_inputs = {
                "cert_kind": type(cert).__name__,
                "licensed_cap": int(oc),
                "learned_cap": int(learned),
                "probe_cap": int(cap_p),
            }
            if declined is None:
                did = record_decision(
                    "join_capacity", "runtime.sized_expansion", "licensed",
                    "runtime_check", cap_inputs,
                )

                def build_licensed(_oc=oc):
                    def step(pb: Batch, bb: Batch):
                        sb, start, count = locate(pb, bb)
                        total = device_total(pb, count)
                        return expand(pb, sb, start, count, total, _oc)

                    return step

                fn = cached_spmd_step(
                    self.wm, ("licensed_expand", oc, cap_p) + key, build_licensed
                )
                with decision_scope(did):
                    out = fn(probe_stacked, build_stacked)
                    self.bump("join_capacity_proven")
                    if oc > 1024:
                        # compact the licensed output to its live bucket and
                        # record the tight width for the next run's economy
                        # check
                        out = self._compact_live(
                            out, ("licensed_compact",) + key, history_key=hist_key
                        )
                observe_decision(
                    did, executed=1, live_cap=int(CAP_HISTORY.guess(hist_key, 0))
                )
                return out
            self.bump("join_license_declined")
            did = record_decision(
                "join_capacity", "runtime.sized_expansion", "declined",
                "licensed", {**cap_inputs, "declined_reason": declined},
            )
        else:
            did = record_decision(
                "join_capacity", "runtime.sized_expansion", "runtime_check",
                "", {"probe_cap": int(cap_p)},
            )

        out_cap = initial_cap(hist_key, spec) if spec is not None else None

        while out_cap is not None:  # speculative fused path
            pcap = CAP_HISTORY.guess(pkey, cap_p) if compact_probe else cap_p
            pcap = min(pcap, cap_p)

            def build_fused(oc=out_cap, pc=pcap):
                def step(pb: Batch, bb: Batch):
                    live = pb.mask().sum(dtype=torch.int64)
                    over = live > pc
                    if pc < cap_p:
                        pb = pb.compact_device(out_capacity=pc)
                    sb, start, count = locate(pb, bb)
                    total = device_total(pb, count)
                    over = torch.logical_or(over, total > oc)
                    return (
                        expand(pb, sb, start, count, total, oc),
                        total,
                        live,
                        over,
                    )

                return step

            fn = cached_spmd_step(
                self.wm, ("fused_expand", out_cap, pcap) + key, build_fused
            )
            with decision_scope(did):
                out, total, live, over = fn(probe_stacked, build_stacked)
                over_h, total_h, live_h = self._host_pull(over, total, live)
            self.bump("join_overflow_check")
            if not over_h.any():
                CAP_HISTORY.record(hist_key, out_cap)
                if compact_probe:
                    CAP_HISTORY.record(pkey, pcap)
                observe_decision(did, executed=1, runtime_cap=int(out_cap))
                return out
            self.bump("join_speculative_retry")
            if int(live_h.max()) > pcap:
                CAP_HISTORY.record(pkey, next_pow2(int(live_h.max()), floor=1024))
            if int(total_h.max()) > out_cap:
                out_cap = next_cap(int(total_h.max()), out_cap)

        # sizing pass: locate + one [W] totals read + exactly-sized expand
        def build_locate():
            def step(pb: Batch, bb: Batch):
                sb, start, count = locate(pb, bb)
                live = pb.mask().sum(dtype=torch.int64)
                return sb, start, count, device_total(pb, count), live

            return step

        loc = cached_spmd_step(self.wm, ("locate",) + key, build_locate)
        with decision_scope(did):
            sb, start, count, total_dev, live_dev = loc(probe_stacked, build_stacked)
            totals, lives = self._host_pull(total_dev, live_dev)
        self.bump("join_capacity_sync")
        cap = next_pow2(max(1, int(totals.max())), floor=1024)

        def build_expand(oc=cap):
            def step(pb: Batch, sb: Batch, start, count, total):
                return expand(pb, sb, start, count, total, oc)

            return step

        fn = cached_spmd_step(self.wm, ("expand", cap) + key, build_expand)
        with decision_scope(did):
            out = fn(probe_stacked, sb, start, count, total_dev)
        observe_decision(did, executed=1, runtime_cap=int(cap))
        if spec is not None:
            CAP_HISTORY.record(hist_key, cap)
            if compact_probe:
                CAP_HISTORY.record(
                    pkey,
                    min(cap_p, next_pow2(max(1, int(lives.max())), floor=1024)),
                )
        return out

    def _x_SemiJoinNode(self, node: P.SemiJoinNode) -> _Dist:
        """IN / EXISTS marks on the mesh.  Without a residual the filtering
        side is broadcast and every worker marks its source shard against
        the whole build; with one (correlated EXISTS) the candidate pairs
        are expanded per shard, which needs key-matching rows co-located."""
        if isinstance(node.source, RemoteSourceNode):
            src = self._to_stacked(self._raw_remote(node.source))
        else:
            src = self._exec(node.source)
        assert isinstance(node.filtering, RemoteSourceNode)
        filt = self._to_stacked(self._raw_remote(node.filtering))
        fk = [filt.channel(node.filtering_key.name)]
        sk = [src.channel(node.source_key.name)]
        src, filt = self._unify_key_dicts(src, sk, filt, fk)
        sk, fk = sk[0], fk[0]
        search, use_kernel = self._probe_search()
        filtering_types = [s.type for s in filt.symbols]

        def global_has_null(stacked: Batch) -> bool:
            """Whether any worker's live filtering rows hold a NULL key: one
            host read per semi join."""
            fcol = stacked.columns[fk]
            if fcol.valid is None:
                return False
            return bool(
                self._host_pull(
                    torch.logical_and(stacked.mask(), torch.logical_not(fcol.valid)).any()
                )
            )

        if node.filter is not None:
            expr = PhysicalPlan(iter(()), src.symbols + filt.symbols).rewrite(node.filter)

            def residual(batch: Batch, _e=expr):
                return ExprCompiler(batch).filter_mask(_e)

            op = SemiJoinOperator(
                sk, fk, filtering_types, null_aware=node.null_aware, residual=residual
            )
            # per-shard marking needs key-matching pairs co-located.  With
            # no placements both sides keep the connector's aligned range
            # splits (the JAX package's contract); once either side is
            # hash-placed or has moved, every side that is not placed on
            # exactly the key is hash-placed on it too
            src_placed = any(t == (node.source_key.name,) for t in src.placements)
            filt_placed = any(t == (node.filtering_key.name,) for t in filt.placements)
            moved = (
                src.realigned or filt.realigned
                or node.source_key.name in src.unaligned
                or node.filtering_key.name in filt.unaligned
            )
            if self.colocate and (src_placed or filt_placed or moved):
                with decision_scope(node.decision_id):
                    if src_placed:
                        self.bump("exchange_elided")
                        observe_decision(node.decision_id, elided=1)
                    else:
                        src = self._repartition_side(src, [sk])
                    if filt_placed:
                        self.bump("exchange_elided")
                        observe_decision(node.decision_id, elided=1)
                    else:
                        filt = self._repartition_side(filt, [fk])
            filt_stacked = filt.stacked
            has_null = global_has_null(filt_stacked)
            cap_b = trailing_cap(filt_stacked)
            skey = (
                sk, fk, cap_b, node.null_aware, has_null, expr.key(),
                _sig(src.symbols), _sig(filt.symbols), use_kernel,
            )
            src_fp = tuple(k for k, _ in src.pending)
            src_stacked = src.stacked

            def locate(pb: Batch, bb: Batch):
                sb, canon, n_match = _sort_build_device(bb, [fk])
                pc, pn = _canon_probe_device(pb, [sk], canon)
                start, count = search(canon, n_match, pc, pn, cap_b)
                return sb, start, count

            def device_total(pb: Batch, count):
                return count.sum(dtype=torch.int64)

            def mark(pb: Batch, sb: Batch, start, count, total, out_cap: int):
                return op._mark_residual_step(
                    pb, sb, start, count, cap_b=cap_b, out_cap=out_cap,
                    total_emit=total, has_null=has_null,
                )

            out = self._sized_expansion(
                ("semi",) + skey, src_stacked, filt_stacked, locate,
                device_total, mark, stats_key=("semi",) + skey + (src_fp,),
            )
            return self._dist(
                out, src.symbols + [node.mark], placements=src.placements,
                realigned=src.realigned, unaligned=src.unaligned,
            )

        op = SemiJoinOperator(sk, fk, filtering_types, null_aware=node.null_aware)
        with decision_scope(node.decision_id):
            bcast = self._broadcast(filt.stacked)
        self.bump("broadcast")
        if node.decision_id is not None:
            observe_decision(
                node.decision_id,
                build_bytes=int(batch_bytes(bcast)) // max(1, self.wm.n),
                probe_move_bytes=(
                    0 if src.placements else int(batch_bytes(src.stacked))
                ),
            )
        cap_b = trailing_cap(bcast)
        has_null = global_has_null(bcast)

        def build_mark():
            def mark_step(pb: Batch, bb: Batch) -> Batch:
                _, canon, n_match = _sort_build_device(bb, [fk])
                pc, pn = _canon_probe_device(pb, [sk], canon)
                _, count = search(canon, n_match, pc, pn, cap_b)
                return op._mark_step(pb, count, has_null)

            return mark_step

        mark = cached_spmd_step(
            self.wm,
            ("semi_mark", sk, fk, cap_b, node.null_aware, has_null,
             _sig(src.symbols), _sig(filt.symbols), use_kernel),
            build_mark,
        )
        out = mark(src.stacked, bcast)
        return self._dist(
            out, src.symbols + [node.mark], placements=src.placements,
            realigned=src.realigned, unaligned=src.unaligned,
        )

    def _repartition_side(self, side: _Dist, chans: list) -> _Dist:
        """Hash-place one operand on `chans`."""
        stacked = ex.repartition(side.stacked, chans, self.wm)
        self.bump("repartition_collective")
        self.profile.add_collective(
            self._current_fid, batch_bytes(stacked), "all_to_all", "repartition"
        )
        return self._dist(
            stacked, side.symbols,
            placements=((tuple(side.symbols[c].name for c in chans),)),
            realigned=True,
        )

    # -- ordering / limiting (partial steps; merge happens at the exchange) ---

    def _x_SortNode(self, node: P.SortNode) -> _Dist:
        src = self._exec(node.source)
        keys = [
            SortKey(src.channel(s.name), asc, nf) for s, asc, nf in node.orderings
        ]

        def step(b: Batch) -> Batch:
            return _sorted(b, keys)

        return src.defer(
            ("sort", tuple(repr(k) for k in keys), _sig(src.symbols)), step
        )

    def _x_TopNNode(self, node: P.TopNNode) -> _Dist:
        src = self._exec(node.source)
        keys = [
            SortKey(src.channel(s.name), asc, nf) for s, asc, nf in node.orderings
        ]
        op = TopNOperator(keys, node.count)
        out_cap = next_pow2(node.count, floor=1)

        def step(b: Batch) -> Batch:
            return op._merge_step(b, out_cap=out_cap)

        return src.defer(
            ("topn", tuple(repr(k) for k in keys), node.count, out_cap,
             _sig(src.symbols)),
            step,
            cap=out_cap,
        )

    def _x_LimitNode(self, node: P.LimitNode) -> _Dist:
        src = self._exec(node.source)
        n = node.count

        def step(b: Batch) -> Batch:
            live = b.mask()
            rank = torch.cumsum(live.to(torch.int64), 0) - 1
            return b.filter(torch.logical_and(live, rank < n))

        return src.defer(("limit", n, _sig(src.symbols)), step)


def _dead_batch_like(b: Batch) -> Batch:
    """Capacity-1 all-dead host batch with `b`'s schema (the placeholder of
    an empty wave partition)."""
    cols = [
        Column(
            torch.zeros((1,) + tuple(c.data.shape[1:]), dtype=c.data.dtype),
            c.type,
            torch.zeros(1, dtype=torch.bool) if c.valid is not None else None,
            c.dictionary,
            None if c.lengths is None else torch.zeros(1, dtype=c.lengths.dtype),
        )
        for c in b.columns
    ]
    return Batch(cols, torch.zeros(1, dtype=torch.bool))


def _concat_stacked(batches: list) -> Batch:
    """Concatenate stacked [W, cap_i] batches along the per-worker row axis
    (wave outputs -> one distributed intermediate).  Every wave of one
    source shares its schema and, column by column, its dictionary."""
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    cols = []
    for ci, c0 in enumerate(first.columns):
        cs = [b.columns[ci] for b in batches]
        for c in cs[1:]:
            if c.dictionary is not c0.dictionary and c.dictionary != c0.dictionary:
                raise AssertionError("wave outputs diverged dictionaries; cannot concat")
        lengths = None
        if any(c.lengths is not None for c in cs):
            # array/map columns: every wave padded to the widest elements
            k = max(c.data.shape[2] for c in cs)
            cs = [
                Column(pad_slots(c.data, k - c.data.shape[2]), c.type, c.valid,
                       c.dictionary, c.lengths)
                for c in cs
            ]
            lengths = torch.cat([c.lengths for c in cs], dim=1)
        data = torch.cat([c.data for c in cs], dim=1)
        valid = None
        if any(c.valid is not None for c in cs):
            valid = torch.cat(
                [
                    c.valid if c.valid is not None
                    else torch.ones(c.data.shape[:2], dtype=torch.bool, device=c.data.device)
                    for c in cs
                ],
                dim=1,
            )
        cols.append(Column(data, c0.type, valid, c0.dictionary, lengths))
    mask = torch.cat([b.mask() for b in batches], dim=1)
    return Batch(cols, mask)


def _take_host(batch: Batch, idx: np.ndarray) -> Batch:
    """Row-gather of a host batch (the bucketized scan's sharding)."""
    ix = torch.from_numpy(idx)
    cols = [c.map_rows(lambda t: t[ix]) for c in batch.columns]
    return Batch(cols, batch.mask()[ix])


def _slice_host(stacked: Batch, w: int, n: int) -> Batch:
    """Worker w's first n rows of a stacked batch, on the host."""
    cols = [c.map_rows(lambda t: t[w, :n].cpu()) for c in stacked.columns]
    return Batch(cols, stacked.row_mask[w, :n].cpu())

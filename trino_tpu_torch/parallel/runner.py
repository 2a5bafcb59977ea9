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
a source the fragmenter placed on the mark's keys.

Not ported (each raises NotImplementedError when a session asks for it):
fault tolerance and task retries, memory-budget waves, bucketed table
layouts, window and unnest nodes, holistic aggregates on the mesh,
`resize_mesh`, membership heartbeats,
prewarm, the per-fragment profile and the compile observatory.  The
collective-schedule license (verify/schedule.py) is not ported either: the
executor dispatches strictly lazily, which the JAX package defines as the
same results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
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
    WorkerMesh,
    bucket_cap,
    cached_spmd_step,
    mesh_key,
    stack_batches,
    trailing_cap,
    unstack_batch,
)
from trino_tpu_torch.partitioning import (
    CAP_HISTORY,
    LayoutResolver,
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
)
from trino_tpu_torch.runtime.runner import LocalQueryRunner, MaterializedResult

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
    return tuple((s.name, s.arg, s.out_type.name, s.sum_bound) for s in specs)


def _check_ported_knobs(properties) -> None:
    """Raise for the session settings whose mesh paths are not ported."""
    from trino_tpu_torch.runtime.local_planner import session_budget

    if properties.get("fault_tolerant_execution") or (
        str(properties.get("retry_policy")).upper() == "TASK"
    ):
        raise NotImplementedError(
            "fault-tolerant execution and task retries on the mesh: not ported yet"
        )
    if session_budget(properties):
        raise NotImplementedError("memory-budget waves on the mesh: not ported yet")
    if str(properties.get("table_layouts")).strip():
        raise NotImplementedError("bucketed table layouts: not ported yet")


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
        super().__init__(catalogs, catalog=catalog, schema=schema, device=device)
        self.wm = WorkerMesh(n_workers, self.device)
        #: the last query's executor (its dynamic filters and event counts)
        self.last_stage_executor = None

    def resize_mesh(self, n_workers: int) -> None:
        raise NotImplementedError("resize_mesh (elastic membership): not ported yet")

    # -- planning -------------------------------------------------------------

    def create_subplan(self, plan: P.OutputNode) -> SubPlan:
        from trino_tpu_torch.verify.capacity import seal_licenses

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
        return sub

    def explain_distributed(self, sql: str) -> str:
        return fragment_text(self.create_subplan(self.create_plan(sql)))

    # -- execution ------------------------------------------------------------

    def _run_query(self, query) -> MaterializedResult:
        _check_ported_knobs(self.properties)
        plan = self.plan_query(query)
        sub = self.create_subplan(plan)
        executor = StageExecutor(self.catalogs, self.wm, self.properties)
        self.last_stage_executor = executor
        host = executor.run(sub)
        rows = []
        for batch in host.stream:
            rows.extend(tuple(r) for r in batch.to_pylist())
        return MaterializedResult(
            list(plan.column_names), rows, [s.type for s in plan.symbols]
        )


class StageExecutor:
    """Executes a SubPlan tree bottom-up (reference role: StageManager +
    SqlStage inside PipelinedQueryScheduler, with on-device collectives as
    the data plane)."""

    def __init__(self, catalogs, wm: WorkerMesh, properties):
        self.catalogs = catalogs
        self.wm = wm
        self.properties = properties
        self._subplans: dict = {}
        self._results: dict = {}
        #: cross-fragment dynamic filters: probe symbol name -> (lo, hi)
        #: build-side key range, registered when a build side completes and
        #: consumed by later probe-side scans
        self.dynamic_filters: dict = {}
        #: named event counts (exchange elisions, capacity paths, ...)
        self.counters: dict = {}
        self.layouts = LayoutResolver(catalogs, properties)
        self.colocate = bool(properties.get("colocated_join"))
        self.license_caps = bool(properties.get("join_capacity_license"))

    def bump(self, name: str) -> None:
        self.counters[name] = self.counters.get(name, 0) + 1

    def _host_pull(self, *vals):
        """The runner's small device -> host reads, in one transfer."""
        out = [v.cpu().numpy() for v in vals]
        return out if len(out) > 1 else out[0]

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
        self._register(sub)
        try:
            out = self._fragment_result(sub.fragment.id)
            if isinstance(out, _Dist):  # defensive: the root should be SINGLE
                host = unstack_batch(self._gather_compact(out.stacked))
                return PhysicalPlan(iter([host]), out.symbols)
            return out
        finally:
            # every _Dist points back at this executor: drop the stage
            # outputs now, or the cycles keep their device tensors alive
            # until the garbage collector next runs
            self._results.clear()

    # -- stage orchestration --------------------------------------------------

    def _register(self, sub: SubPlan) -> None:
        self._subplans[sub.fragment.id] = sub
        for c in sub.children:
            self._register(c)

    def _fragment_result(self, fid: int):
        """Stage output: a _Dist, or ('host', batches, symbols) for SINGLE
        fragments (materialized so several consumers can re-read it)."""
        if fid not in self._results:
            self._results[fid] = self._run_stage(fid)
        res = self._results[fid]
        if isinstance(res, tuple):
            return PhysicalPlan(iter(res[1]), res[2])
        return res

    def _run_stage(self, fid: int):
        sub = self._subplans[fid]
        if sub.fragment.partitioning.kind in _DIST_KINDS:
            return self._exec(sub.fragment.root)
        out = self._local_fragment(sub)
        return ("host", list(out.stream), out.symbols)

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
            batch = unstack_batch(self._gather_compact(child.stacked))
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
        for w in range(self.wm.n):
            # partial sorts put dead rows last: the live prefix is the shard
            shards.append(_slice_host(stacked, w, int(n_live[w])))
        return merge_sorted_shards(shards, keys).to(self.wm.device)

    def _remote_as_dist(self, node: RemoteSourceNode) -> _Dist:
        """Apply a repartition/broadcast exchange into a stacked batch."""
        stacked = self._to_stacked(self._raw_remote(node))
        return self._apply_dist_exchange(node, stacked)

    def _apply_dist_exchange(self, node: RemoteSourceNode, stacked: _Dist) -> _Dist:
        if node.exchange_kind == "broadcast":
            # ship live rows, not static capacity: compaction is stable, so
            # row order is preserved
            bs = stacked.stacked
            if trailing_cap(bs) > 64:
                bs = self._compact_live(bs, "broadcast_compact")
            return self._dist(ex.broadcast(bs, self.wm), stacked.symbols, realigned=True)
        if node.exchange_kind == "repartition":
            names = tuple(s.name for s in node.partition_symbols)
            # runtime exchange elision: the producing fragment's output is
            # already placed on (a subset of) the requested keys
            if self.colocate and any(
                t and set(t) <= set(names) for t in stacked.placements
            ):
                self.bump("exchange_elided")
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
        stacked = stack_batches([host] + [None] * (self.wm.n - 1), self.wm)
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

        if self.colocate and scan_partitioning(node, self.layouts, self.wm.n):
            raise NotImplementedError("bucketed table layouts: not ported yet")
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

        # device-resident stacked-scan cache: a warm mesh query reuses the
        # [W, cap] batch already on the device — no host -> device bytes
        version = connector.scan_version(node.handle) if use_cache else None
        cache_key = None
        if version is not None and splits:
            cache_key = (
                "mesh_scan",
                mesh_key(self.wm),
                tuple(
                    BufferPool.split_key(s, names, page_rows, version)
                    for s in splits
                ),
            )
            cached = POOL.get_device(cache_key)
            if cached is not None:
                self.bump("scan_cache_hit")
                return self._scan_filters(node, self._dist(cached[0], symbols))
            self.bump("scan_cache_miss")

        per_worker: list = [[] for _ in range(self.wm.n)]
        for i, split in enumerate(splits):
            op = ScanOperator(
                connector, split, names, types, torch.device("cpu"),
                page_rows=page_rows, use_cache=use_cache,
            )
            per_worker[i % self.wm.n].extend(op.host_batches())
        host_batches = [(concat_batches(bs) if bs else None) for bs in per_worker]
        if all(b is None for b in host_batches):
            cols = [
                Column.from_numpy(np.zeros(1, dtype=t.np_dtype), t, np.zeros(1, bool))
                for t in types
            ]
            host_batches[0] = Batch(cols, torch.zeros(1, dtype=torch.bool))
        stacked = stack_batches(host_batches, self.wm)
        if cache_key is not None:
            POOL.put_device(cache_key, [stacked])
        return self._scan_filters(node, self._dist(stacked, symbols))

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
                sum_bound=s.sum_bound,
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
        holistic = [
            a.function for _, a in node.aggregations
            if a.function in PARTITIONABLE_HOLISTIC
        ]
        if holistic:
            raise NotImplementedError(
                f"holistic aggregates on the mesh ({', '.join(holistic)}): not ported yet"
            )
        if any(a.distinct for _, a in node.aggregations):
            # repartition the raw rows on the group keys so every group is
            # whole on one worker, then dedupe and aggregate there in one
            # stage: no partial/merge states, no coordinator gather
            return self._spmd_single_stage(node, src)
        states, specs, partial_op = self._agg_partial(node, src)
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

        def final_step(b: Batch) -> Batch:
            return final_op._reduce_step(b, out_cap=fcap)

        out = ex.fused_repartition(
            states, chans, self.wm, final_step,
            ("agg_final", _spec_sig(specs), fcap, _sig(node.outputs)),
            slot_cap,
        )
        return self._dist(
            out, node.outputs,
            placements=((tuple(s.name for s in node.group_symbols),)),
            realigned=True,
        )

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
        aggregation (the mesh's home of the DISTINCT shapes; reference:
        single-step aggregation over hash distribution).  The dedupe
        pre-aggregation and the aggregation run as the exchange's consumer."""
        from trino_tpu_torch.runtime.local_planner import (
            build_agg_inputs,
            build_distinct_dedupe,
        )

        ngroups = len(node.group_symbols)
        key_channels = [src.channel(s.name) for s in node.group_symbols]
        stacked = src.stacked
        slot_cap = ex.exchange_slot_cap(stacked, key_channels, self.wm)
        fcap = self.wm.n * slot_cap
        dd_proj, dd_symbols = build_distinct_dedupe(node, src)
        dedupe = AggregationOperator(
            list(range(len(dd_proj))), [], [e.type for e in dd_proj],
            self.wm.device, mode="single",
        )
        pre_dd = FilterProjectOperator(None, dd_proj)._make_step()
        proj, specs, input_types = build_agg_inputs(
            node, PhysicalPlan(iter(()), dd_symbols)
        )
        op = AggregationOperator(
            list(range(ngroups)), specs, input_types, self.wm.device, mode="single"
        )
        pre_agg = FilterProjectOperator(None, proj)._make_step()

        def single_step(b: Batch) -> Batch:
            b = dedupe._reduce_step(pre_dd(b), out_cap=fcap)
            return op._reduce_step(pre_agg(b), out_cap=fcap)

        out = ex.fused_repartition(
            stacked, key_channels, self.wm, single_step,
            ("agg_single", tuple(e.key() for e in dd_proj),
             tuple(e.key() for e in proj), _spec_sig(specs), fcap,
             _sig(src.symbols)),
            slot_cap,
        )
        self.bump("repartition_collective")
        return self._dist(
            out, node.outputs,
            placements=((tuple(s.name for s in node.group_symbols),)),
            realigned=True,
        )

    def _global_agg(self, node: P.AggregationNode, src: _Dist) -> PhysicalPlan:
        """Global aggregation over a distributed child: partial per worker,
        gather the single state rows, final merge on the coordinator."""
        states, specs, partial_op = self._agg_partial(node, src)
        final_op = self._final_op(specs, partial_op, states)
        gathered = unstack_batch(states)
        cap = next_pow2(gathered.capacity, floor=1)
        final = final_op._reduce_step(_pad_device(gathered, cap), out_cap=1)
        return PhysicalPlan(iter([final]), node.outputs)

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

        if node.distribution == "broadcast":
            # compact to the live bucket before the all-gather (stable, so
            # the build-row order and the search's tie order are unchanged)
            bs = build.stacked
            if trailing_cap(bs) > 64:
                bs = self._compact_live(bs, "broadcast_compact")
            build_stacked = ex.broadcast(bs, self.wm)
        else:
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
        locate, device_emit_total, expand = self._join_step_fns(
            node, op, pk, bk, cap_b, probe_types, search
        )
        # proof-licensed capacity: a certificate sealed for THIS mesh width
        # licenses a fixed expand capacity; anything else takes the runtime
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
                # every build row lives on exactly one shard
                from trino_tpu_torch.columnar.column import torch_dtype

                dev = start.device
                tail_live = torch.logical_and(sb.mask(), torch.logical_not(matched))
                ncols = [
                    Column(
                        torch.zeros(cap_b, dtype=torch_dtype(t.np_dtype), device=dev),
                        t,
                        torch.zeros(cap_b, dtype=torch.bool, device=dev),
                        None,
                    )
                    for t in probe_types
                ]
                out = concat_batches([out, Batch(ncols + list(sb.columns), tail_live)])
            return out

        return locate, device_emit_total, expand

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
            declined = (learned and oc > _LICENSE_WIDTH_FACTOR * learned) or (
                not learned and oc > next_pow2(cap_p, floor=1024)
            )
            if not declined:

                def build_licensed(_oc=oc):
                    def step(pb: Batch, bb: Batch):
                        sb, start, count = locate(pb, bb)
                        total = device_total(pb, count)
                        return expand(pb, sb, start, count, total, _oc)

                    return step

                fn = cached_spmd_step(
                    self.wm, ("licensed_expand", oc, cap_p) + key, build_licensed
                )
                out = fn(probe_stacked, build_stacked)
                self.bump("join_capacity_proven")
                if oc > 1024:
                    # compact the licensed output to its live bucket and
                    # record the tight width for the next run's economy check
                    out = self._compact_live(
                        out, ("licensed_compact",) + key, history_key=hist_key
                    )
                return out
            self.bump("join_license_declined")

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
            out, total, live, over = fn(probe_stacked, build_stacked)
            over_h, total_h, live_h = self._host_pull(over, total, live)
            self.bump("join_overflow_check")
            if not over_h.any():
                CAP_HISTORY.record(hist_key, out_cap)
                if compact_probe:
                    CAP_HISTORY.record(pkey, pcap)
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
        sb, start, count, total_dev, live_dev = loc(probe_stacked, build_stacked)
        totals, lives = self._host_pull(total_dev, live_dev)
        self.bump("join_capacity_sync")
        cap = next_pow2(max(1, int(totals.max())), floor=1024)

        def build_expand(oc=cap):
            def step(pb: Batch, sb: Batch, start, count, total):
                return expand(pb, sb, start, count, total, oc)

            return step

        fn = cached_spmd_step(self.wm, ("expand", cap) + key, build_expand)
        out = fn(probe_stacked, sb, start, count, total_dev)
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
                if src_placed:
                    self.bump("exchange_elided")
                else:
                    src = self._repartition_side(src, [sk])
                if filt_placed:
                    self.bump("exchange_elided")
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
        bcast = ex.broadcast(filt.stacked, self.wm)
        self.bump("broadcast")
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


def _slice_host(stacked: Batch, w: int, n: int) -> Batch:
    """Worker w's first n rows of a stacked batch, on the host."""
    cols = [
        Column(
            c.data[w, :n].cpu(),
            c.type,
            None if c.valid is None else c.valid[w, :n].cpu(),
            c.dictionary,
        )
        for c in stacked.columns
    ]
    return Batch(cols, stacked.row_mask[w, :n].cpu())

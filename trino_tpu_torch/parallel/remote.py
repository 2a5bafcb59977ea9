"""Multi-host query runner: fragments scheduled onto worker servers.

Reference roles: server/remotetask/HttpRemoteTask.java (the coordinator's
handle on a worker task), execution/scheduler/NodeScheduler + StageManager
(stage-by-stage scheduling over the worker set), and ExchangeClient's pull
data plane.  The same PlanFragmenter output that drives the in-mesh SPMD
executor (parallel/runner.py) is executed here across PROCESSES: source
fragments split-partition the scan, FIXED_HASH fragments consume hash
buckets of their children's outputs, SINGLE fragments run on the
coordinator over gathered (or merge-ordered) inputs.

Division of labor with the mesh runner: the mesh is the ICI tier (XLA
collectives between devices in one host); this is the DCN tier (HTTP
exchanges between hosts).  A deployment nests them: one WorkerServer per
host, each running mesh-SPMD fragments over its local devices.

Port of trino_tpu/parallel/remote.py.  `MultiHostQueryRunner(...,
device=None)` runs its coordinator fragments on the card (it raises where
there is none unless `device="cpu"` is passed).  Page sets pulled from
workers arrive as CPU batches (parallel/serde.py) and move to the
coordinator's device where a fragment reads them (`_coordinator_fragment`,
`_merge`, `_LocalResult`); the FTE spool keeps the pulled CPU batches.
With `query_trace` on, each stage's `fragment` span carries the bytes the
coordinator pulled from it and their decode seconds, and the workers'
task spans (output bytes, encode seconds, input pulls) graft under it.
`add_worker` kicks the attached prewarm executor's grow replay
(runtime/prewarm.kick_grow_prewarm; off under `prewarm.on-grow=false`).
"""

from __future__ import annotations

import itertools
import pickle
import time
import urllib.request
from typing import Optional, Sequence

from trino_tpu_torch.config import get_config
from trino_tpu_torch.connectors.api import CatalogManager
from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.planner.fragmenter import (
    COORDINATOR_ONLY,
    FIXED_ARBITRARY,
    FIXED_HASH,
    SINGLE,
    SOURCE,
    RemoteSourceNode,
    SubPlan,
    add_exchanges,
    create_subplans,
)
from trino_tpu_torch.runtime import lifecycle
from trino_tpu_torch.runtime.lifecycle import QueryAbortedException, check_current
from trino_tpu_torch.runtime.local_planner import LocalExecutionPlanner, PhysicalPlan
from trino_tpu_torch.runtime.membership import (
    ClusterMembership,
    HeartbeatDetector,
    MeshChangedError,
    WorkerDrainingError,
    invalidate_mesh_scans,
)
from trino_tpu_torch.runtime.retry import BREAKERS, FAILURE_INJECTOR, RETRYABLE, Backoff
from trino_tpu_torch.runtime.runner import LocalQueryRunner, MaterializedResult
from trino_tpu_torch.server.worker import TaskDescriptor, _http_get
from trino_tpu_torch.telemetry import now

_DIST = (SOURCE, FIXED_HASH, FIXED_ARBITRARY)

# NOTE: this module deliberately holds NO module-level numeric knobs — the
# transient submit/fetch retry budgets, probe-verdict TTL, and backoff
# bounds all live in the typed config (trino_tpu/config: remote.*), and the
# `module-level-knob` lint rule (tools/lint_tpu.py) keeps it that way.


def _is_refused(exc: BaseException) -> bool:
    """REFUSED = nothing is listening on the socket — the one failure shape
    where retrying the same worker is pointless (vs RESET/timeouts, which
    flaky networks produce on perfectly healthy workers)."""
    if isinstance(exc, ConnectionRefusedError):
        return True
    return isinstance(exc, urllib.error.URLError) and isinstance(
        exc.reason, ConnectionRefusedError
    )


def _is_transient(exc: BaseException) -> bool:
    """Connection-shaped failures worth a backed-off retry against the SAME
    worker (vs HTTPError = the worker answered; its task failed)."""
    if isinstance(exc, urllib.error.HTTPError):
        return False
    if isinstance(exc, RETRYABLE):
        return True
    if isinstance(exc, urllib.error.URLError):
        return isinstance(exc.reason, (ConnectionError, TimeoutError, OSError))
    return isinstance(exc, OSError)


class RemoteTaskClient:
    """Coordinator handle on one worker task (HttpRemoteTask role)."""

    def __init__(self, worker_url: str, task_id: str):
        self.worker_url = worker_url
        self.task_id = task_id

    def submit(self, desc: TaskDescriptor) -> None:
        from trino_tpu_torch.server.worker import cluster_secret, sign_body

        FAILURE_INJECTOR.maybe_fail(f"submit:{self.worker_url}")
        body = pickle.dumps(desc, protocol=pickle.HIGHEST_PROTOCOL)
        headers = {}
        secret = cluster_secret()
        if secret is not None:
            headers["X-Cluster-Auth"] = sign_body(secret, body)
        req = urllib.request.Request(
            f"{self.worker_url}/v1/task", data=body, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(
                req,
                timeout=lifecycle.request_timeout(
                    get_config().lifecycle.submit_timeout_s
                ),
            ) as r:
                r.read()
        except urllib.error.HTTPError as e:
            if e.code == 503:
                # graceful drain: the worker is healthy but leaving — the
                # REFUSED classification (skip retries against it) without
                # a breaker vote
                raise WorkerDrainingError(
                    f"{self.worker_url} is draining"
                ) from None
            raise

    def state(self) -> str:
        body = _http_get(f"{self.worker_url}/v1/task/{self.task_id}").decode()
        return body.splitlines()[0] if body else "UNKNOWN"

    def error(self) -> str:
        body = _http_get(f"{self.worker_url}/v1/task/{self.task_id}").decode()
        return body.partition("\n")[2]

    def result_url(self, bucket: int) -> str:
        return f"{self.worker_url}/v1/task/{self.task_id}/results/{bucket}"

    def spans(self) -> Optional[dict]:
        """The finished task's span tree (worker-local clock), or None —
        tracing is an observability surface, never a correctness
        dependency, so ANY failure degrades to 'no worker spans'.  That
        includes abort signals: this runs after every result batch has
        been materialized, and a deadline expiring during span collection
        must not fail a query whose rows are already complete (cancel and
        deadline still fire at the execution's own cooperative checks)."""
        import json as _json

        try:
            body = _http_get(f"{self.worker_url}/v1/task/{self.task_id}/spans")
            return _json.loads(body.decode()) or None
        except Exception:
            return None

    def cancel(self) -> None:
        req = urllib.request.Request(
            f"{self.worker_url}/v1/task/{self.task_id}", method="DELETE"
        )
        try:
            with urllib.request.urlopen(
                req, timeout=get_config().lifecycle.cancel_timeout_s
            ) as r:
                r.read()
        except Exception:
            pass


class MultiHostQueryRunner(LocalQueryRunner):
    """Executes queries across worker servers (urls).  The workers must be
    able to reconstruct catalog data from configuration (generator/file
    connectors) — coordinator-resident state (memory tables) stays local.

    Cluster membership (runtime/membership) makes the worker set MUTABLE:
    `add_worker` registers a new worker that joins the NEXT query's mesh
    (never a running one), `drain_worker` gracefully retires one, and a
    worker discovered dead or draining mid-query triggers mesh-shrink
    re-planning — the query's fragments re-plan against the shrunk set
    (W-1) and replay (pull exchanges re-read deterministically) instead of
    retrying forever against a corpse."""

    def __init__(
        self,
        worker_urls: Sequence[str],
        catalogs: Optional[CatalogManager] = None,
        catalog: str = "tpch",
        schema: str = "tiny",
        device=None,
    ):
        super().__init__(catalogs, catalog=catalog, schema=schema, device=device)
        self.worker_urls = list(worker_urls)
        self._task_seq = itertools.count(1)
        #: url -> (monotonic ts, alive) probe cache shared across queries so
        #: per-query scheduling doesn't pay serial HTTP probes (reference:
        #: the background HeartbeatFailureDetector, polled not per-query)
        self._worker_health: dict = {}
        #: coordinator-side membership registry: every query's mesh is the
        #: ACTIVE set at ITS start (grow/drain/death visible to the next
        #: query; a running one re-plans on MeshChangedError)
        self.membership = ClusterMembership(self.worker_urls)
        #: heartbeat failure detector over the registry; `tick()` manually
        #: or `start()` a background probe loop (heartbeat.interval)
        self.failure_detector = HeartbeatDetector(self.membership)
        #: mesh-shrink re-plans performed by the LAST statement (evidence)
        self.last_replans = 0
        #: worker set the LAST statement's plan was fragmented against
        self.last_plan_workers: list = []
        #: fault-tolerant recovery evidence for the LAST statement
        self.last_task_retries = 0
        self.last_spool_hits = 0
        #: spool + completed-fragment map, live only while a
        #: fault_tolerant_execution query is executing
        self._fte_spool = None
        self._fte_completed: dict = {}
        self._fte_qid = "q"
        self._fte_attempt = 0

    # -- membership (grow / drain) --------------------------------------------

    def add_worker(self, url: str) -> None:
        """Grow path: register a worker; it serves from the next query on
        (reference: DiscoveryNodeManager announcement).  The attached
        prewarm executor (runtime/prewarm) then replays the workload
        manifest in the background at the GROWN worker set — the next
        query plans at the new W against warm plan and step state instead
        of paying the re-fragmentation cold."""
        from trino_tpu_torch.runtime.prewarm import kick_grow_prewarm

        if url not in self.worker_urls:
            self.worker_urls.append(url)
        self.membership.register(url)
        self._worker_health.pop(url, None)
        kick_grow_prewarm(self)

    def drain_worker(self, url: str) -> None:
        """Gracefully retire a worker: PUT /v1/worker/shutdown (it finishes
        running tasks, refuses new ones, exits) and mark it DRAINING so the
        next query's mesh excludes it."""
        from trino_tpu_torch.server.worker import cluster_secret, sign_body

        headers = {}
        secret = cluster_secret()
        if secret is not None:
            headers["X-Cluster-Auth"] = sign_body(secret, b"")
        req = urllib.request.Request(
            f"{url}/v1/worker/shutdown", headers=headers, method="PUT"
        )
        try:
            with urllib.request.urlopen(
                req, timeout=get_config().lifecycle.cancel_timeout_s
            ) as r:
                r.read()
        except Exception:
            pass  # already gone: membership still records the intent
        self.membership.drain(url)

    # -- execution ------------------------------------------------------------

    def _run_query(self, query, stats=None) -> MaterializedResult:
        if stats is not None:
            return super()._run_query(query, stats=stats)
        plan = self.plan_query(query)
        if self._system_only(plan):
            # system tables are coordinator-resident (the reference's
            # GlobalSystemConnector): membership/metrics/query state live in
            # THIS process, and workers don't even mount the catalog —
            # execute locally instead of distributing the scan
            return self._execute_local(plan)
        self.last_replans = 0
        self.last_task_retries = 0
        self.last_spool_hits = 0
        max_replans = get_config().remote.max_replans
        # fault-tolerant execution: fragment outputs fetched by the
        # coordinator spool through the filesystem SPI keyed by
        # (query_id, fragment_id, attempt_id); a mid-query worker death
        # RETRIES the same plan on the survivors, resuming finished
        # fragments from the spool — only lost outputs re-run.  Off (the
        # default) keeps today's behavior: every mesh change re-plans.
        try:
            fte = bool(self.properties.get("fault_tolerant_execution"))
        except KeyError:  # pragma: no cover - older property sets
            fte = False
        retries_left = get_config().remote.max_task_retries if fte else 0
        plan_w: Optional[int] = None
        if fte:
            from trino_tpu_torch.runtime.fte import SpoolManager

            self._fte_spool = SpoolManager()
            self._fte_completed = {}
            self._fte_qid = f"q{next(self._task_seq)}"
            self._fte_attempt = 0
        try:
            while True:
                check_current()  # canceled queries stop re-planning too
                workers = self.membership.active_workers()
                if not workers:
                    raise RuntimeError("no live workers")
                if plan_w is None:
                    plan_w = len(workers)
                try:
                    return self._execute_on(plan, workers, plan_w=plan_w)
                except MeshChangedError as e:
                    for w in e.dead:
                        # mark_dead itself skips the breaker trip for
                        # DRAINING workers (their exit is the drain
                        # completing by choice)
                        self.membership.mark_dead(w)
                        self._worker_health[w] = (_monotonic(), False)
                    for w in e.drained:
                        self.membership.drain(w)
                    if fte and retries_left > 0:
                        # RETRY: same plan (same fragment ids, same bucket
                        # counts), lost tasks re-run round-robin on the
                        # survivors, finished coordinator-consumed
                        # fragments resume from the spool.  Classification
                        # comes from the per-error-code table — a
                        # user/semantic error never lands here (it is not
                        # a MeshChangedError to begin with).
                        retries_left -= 1
                        self.last_task_retries += 1
                        self._fte_attempt += 1
                        self._record_recovery(e, "retry", "replan")
                        continue
                    if fte:
                        # the mesh kept changing past the retry budget:
                        # the plan's worker requirement is no longer
                        # hostable — classify as a true mesh shrink and
                        # re-fragment at the surviving W
                        self._record_recovery(
                            e, "replan", "retry",
                            code="MESH_SHRINK_BELOW_REQUIREMENT",
                        )
                        self._fte_completed.clear()  # fragment ids change
                        self._fte_spool.dedup.clear(self._fte_qid)
                    # mesh-shrink re-planning: record the membership
                    # change, drop caches keyed by the old mesh, and
                    # re-fragment the query against the survivors (W-1).
                    # Spooled/pull exchanges make the replay
                    # deterministic; layouts whose bucket_count no longer
                    # divides the new W lose their placement claims at
                    # re-plan time (scan_partitioning).
                    if self.last_replans >= max_replans:
                        raise RuntimeError(
                            f"query re-planned {self.last_replans} times "
                            f"without a stable mesh (last change: {e})"
                        ) from e
                    self.last_replans += 1
                    plan_w = None  # re-fragment at the shrunk worker set
                    invalidate_mesh_scans()
                    from trino_tpu_torch.telemetry.metrics import (
                        membership_events_counter,
                    )

                    membership_events_counter().labels("shrink_replan").inc()
        finally:
            if fte:
                self._fte_spool.close()
                self._fte_spool = None
                self._fte_completed = {}

    def _record_recovery(self, exc: BaseException, outcome: str,
                         alternative: str, code: Optional[str] = None) -> None:
        """Book one recovery decision: the {outcome}-labeled retry metric
        plus a `recovery` entry in the plan-decision ledger."""
        from trino_tpu_torch.runtime.lifecycle import error_code_of
        from trino_tpu_torch.telemetry.decisions import record_decision
        from trino_tpu_torch.telemetry.metrics import task_retries_counter

        task_retries_counter().labels(outcome).inc()
        record_decision(
            "recovery", "remote:mesh", outcome, alternative,
            {"error_code": code or error_code_of(exc),
             "spooled_fragments": len(self._fte_completed)},
        )

    # -- fault-tolerant spool (coordinator side) ------------------------------

    def _spool_fragment(self, fid: int, batches: list, symbols) -> None:
        """Record one fully-fetched fragment output: spooled through the
        filesystem SPI keyed by (query_id, fragment_id, attempt_id), so a
        recovery pass serves it from disk instead of re-executing the
        fragment."""
        if self._fte_spool is None or fid in self._fte_completed:
            return
        from trino_tpu_torch.telemetry.metrics import spooled_fragments_counter

        dicts = (
            [c.dictionary for c in batches[0].columns]
            if batches else [None] * len(symbols)
        )
        self._fte_spool.save(
            self._fte_qid, fid, batches, symbols,
            attempt_id=self._fte_attempt,
        )
        self._fte_completed[fid] = (symbols, dicts)
        spooled_fragments_counter().inc()

    def _load_spooled_fragment(self, fid: int) -> PhysicalPlan:
        """Rehydrate a completed fragment for a recovery pass; the FIRST
        committed attempt wins for every consumer, duplicates are deleted
        unread (the DeduplicatingDirectExchangeBuffer contract)."""
        symbols, dicts = self._fte_completed[fid]
        spool = self._fte_spool
        att = spool.dedup.committed(self._fte_qid, fid)
        if att is None:
            atts = spool.attempts(self._fte_qid, fid)
            att = spool.dedup.commit(
                self._fte_qid, fid, atts[0] if atts else 0
            )
            spool.discard_duplicates(self._fte_qid, fid, att)
        batches = spool.load(
            self._fte_qid, fid, symbols, dicts, attempt_id=att
        )
        if batches is None:
            # the spool file itself was lost: this fragment's output is
            # gone, so it re-runs like any other lost task
            del self._fte_completed[fid]
            return None
        self.last_spool_hits += 1
        # the spool holds CPU batches: the coordinator reads them on its
        # device (_LocalResult moves them)
        return PhysicalPlan(iter(batches), symbols)

    @staticmethod
    def _system_only(plan) -> bool:
        """True when every table the plan scans is a system catalog table
        (then there is at least one scan — pure-values plans distribute
        fine and stay on the normal path)."""
        from trino_tpu_torch.planner.plan import TableScanNode, walk

        catalogs = {
            n.handle.catalog
            for n in walk(plan)
            if isinstance(n, TableScanNode)
        }
        return catalogs == {"system"}

    def _execute_local(self, plan) -> MaterializedResult:
        """Run an already-planned query in-process on the coordinator."""
        self._check_table_access(plan)
        return self._execute_plan(plan)

    def _execute_on(self, plan, workers: list,
                    plan_w: Optional[int] = None) -> MaterializedResult:
        """One scheduling attempt against a FIXED worker set (the mesh a
        membership change never mutates — it re-plans instead).  Under
        fault-tolerant recovery `plan_w` keeps the ORIGINAL fragmentation
        width: the same plan (same fragment ids, same bucket counts)
        re-executes with its plan_w task slots placed round-robin on the
        survivors, so spooled fragment outputs stay addressable."""
        self.last_plan_workers = list(workers)
        w = plan_w or len(workers)
        # colocate=False: HTTP workers shard scans by split_mod, not by the
        # exchange hash — layout placements would be claims the data plane
        # does not realize (the in-process mesh runner is the elision home)
        dplan = add_exchanges(
            plan, self.catalogs, self.properties,
            n_workers=w, colocate=False,
        )
        sub = create_subplans(dplan, properties=self.properties)
        sched = _StageScheduler(self, workers, plan_w=w)
        try:
            with self._tracer.span("execute"):
                out = sched.run(sub)
                # cancel/deadline are checked between result batches
                rows = self._collect_rows(out.stream)
                # tasks are complete (results are pulled eagerly): merge
                # their span trees so GET /v1/query/{id}/trace renders ONE
                # cross-host timeline with coordinator AND worker spans
                sched.collect_spans()
        except MeshChangedError:
            # abandon this attempt cleanly: live tasks of the old mesh are
            # canceled so surviving workers free their slots for the replay
            sched.cancel_all()
            raise
        return MaterializedResult(
            list(plan.column_names), rows, [s.type for s in plan.symbols]
        )


def _monotonic() -> float:
    import time as _time

    return _time.monotonic()


class _StageScheduler:
    """Bottom-up stage execution (StageManager/PipelinedQueryScheduler role,
    with every stage ALL_AT_ONCE since exchanges are pull-based).

    Node scheduling (reference: execution/scheduler/NodeScheduler.java:54 +
    UniformNodeSelector): fragments are only assigned to workers that answer
    a liveness probe, and a task whose worker dies is REASSIGNED to a live
    worker (the task re-reads its splits/inputs — deterministic replay, the
    EventDrivenFaultTolerantQueryScheduler retry property)."""

    def __init__(self, runner: MultiHostQueryRunner, workers=None,
                 plan_w: Optional[int] = None):
        self.runner = runner
        candidates = list(
            runner.worker_urls if workers is None else workers
        )
        # a worker in the planned mesh that a fresh probe CONFIRMS dead:
        # don't schedule a W-wide plan on W-k workers — re-plan at the
        # smaller W.  A worker whose breaker is merely OPEN (cooling down
        # from transient flaps) stays in the mesh: it is alive, just not
        # preferred — _submit_on_live routes around it per task.
        confirmed = [u for u in candidates if self._confirmed_dead(u)]
        if confirmed:
            raise MeshChangedError(dead=confirmed)
        self.workers = candidates
        if not self.workers:
            raise RuntimeError("no live workers")
        #: the plan's fragmentation width (task slots per distributed
        #: stage, output bucket counts).  Equals len(workers) on a fresh
        #: plan; a fault-tolerant RECOVERY pass keeps the original width
        #: and places slots round-robin on the survivors.
        self.plan_w = plan_w or len(self.workers)
        #: fragment_id -> list[RemoteTaskClient] (producing tasks)
        self._stage_tasks: dict[int, list] = {}
        #: fragment_id -> {probe symbol name: (lo, hi)} awaiting delivery
        self._pending_ranges: dict[int, dict] = {}
        #: fragment ids whose dynamic-filter summaries WILL be fetched
        self._want_ranges: set = set()
        self._subplans: dict[int, SubPlan] = {}
        #: task_id -> TaskDescriptor (for replacement resubmission)
        self._descs: dict[str, TaskDescriptor] = {}
        #: cross-host tracing (query_trace on): per-fragment coordinator
        #: spans the workers' task span trees merge under, and the
        #: coordinator-clock submission instant each worker tree anchors to
        self.tracer = runner._tracer
        self._fragment_spans: dict = {}
        self._submit_t: dict = {}

    @staticmethod
    def _is_conn_dead(exc: Exception) -> bool:
        if isinstance(exc, (ConnectionRefusedError, ConnectionResetError)):
            return True
        if isinstance(exc, urllib.error.URLError):
            return isinstance(
                exc.reason, (ConnectionRefusedError, ConnectionResetError)
            )
        return False

    def _confirmed_dead(self, url: str) -> bool:
        """Death needs SOCKET evidence: a fresh/cached
        probe fails (only REFUSED/RESET — a slow probe is BUSY, a worker
        thread holding the GIL inside an XLA compile, not dead; treating
        it as dead cascades into blacklisting the whole cluster).  A
        breaker that is merely OPEN is NOT death — it is a live worker
        cooling down from transient flaps, and declaring it dead would
        stickily evict it from membership (only an explicit re-register
        resurrects a DEAD worker).  Failed probes vote on the breaker;
        probe successes never vote, so a probe cannot short-circuit an
        open breaker's cooldown.  Verdicts cache on the runner
        (remote.probe-ttl) so healthy clusters pay no per-query probes."""
        import time as _time

        now = _time.monotonic()
        cached = self.runner._worker_health.get(url)
        if (
            cached is not None
            and now - cached[0] < get_config().remote.probe_ttl_s
        ):
            return not cached[1]
        ok = self._probe(url)
        self.runner._worker_health[url] = (now, ok)
        if not ok:
            BREAKERS.get(url).record_failure()
        return not ok

    def _confirmed_draining(self, url: str) -> bool:
        """A 503 submit refusal CLAIMS the worker is draining — verify
        against its own /v1/info state before stickily excluding it from
        future meshes (a reverse-proxy or overload 503 is not a drain)."""
        try:
            with urllib.request.urlopen(
                f"{url}/v1/info",
                timeout=get_config().lifecycle.probe_timeout_s,
            ) as r:
                import json

                return json.loads(r.read()).get("state") == "DRAINING"
        except Exception:
            return False  # unreachable: the death path owns that verdict

    @staticmethod
    def _probe(url: str) -> bool:
        # DELIBERATELY stricter than membership.http_probe: the scheduler
        # acts on ONE probe, so only REFUSED/RESET (nobody listening) is
        # death — the detector can afford to count timeouts as misses
        # because it requires miss-threshold CONSECUTIVE ones.
        try:
            with urllib.request.urlopen(
                f"{url}/v1/info",
                timeout=get_config().lifecycle.probe_timeout_s,
            ) as r:
                r.read()
            return True
        except Exception as exc:
            if _StageScheduler._is_conn_dead(exc):
                return False
            return True  # slow or transient: assume alive

    def _least_loaded_worker(self) -> str:
        """Replacement placement: the live worker with the fewest tasks this
        scheduler has placed on it (reference: UniformNodeSelector.java:67's
        queue-length weighting; here load = submitted-task count)."""
        from collections import Counter

        load: Counter = Counter()
        for tasks in self._stage_tasks.values():
            if isinstance(tasks, list):
                for t in tasks:
                    url = getattr(t, "base_url", None) or getattr(
                        t, "worker_url", None
                    )
                    if url:
                        load[url] += 1
        return min(self.workers, key=lambda u: load[u])

    def _submit_on_live(self, desc: TaskDescriptor, preferred: str):
        """Submit to the preferred worker, absorbing transient flaps with
        backed-off retries.  A worker discovered DEAD (refused/exhausted)
        or DRAINING raises MeshChangedError: the mesh this plan was
        fragmented for no longer exists, and the runner re-plans at the
        smaller W instead of cramming a W-wide plan onto W-1 workers."""
        cfg = get_config().remote
        urls = [preferred] + [u for u in self.workers if u != preferred]
        last: Optional[Exception] = None
        for url in urls:
            check_current()  # canceled queries stop scheduling work
            breaker = BREAKERS.get(url)
            if not breaker.allow():
                continue  # breaker open: this worker is cooling down
            client = RemoteTaskClient(url, desc.task_id)
            backoff = Backoff(base_s=cfg.backoff_base_s, cap_s=cfg.backoff_cap_s)
            submitted = False
            for attempt in range(cfg.submit_attempts):
                if attempt:
                    backoff.wait(attempt - 1)
                try:
                    client.submit(desc)
                    submitted = True
                    break
                except QueryAbortedException:
                    raise  # lifecycle abort: stop scheduling entirely
                except WorkerDrainingError:
                    # 503 CLAIMS a graceful drain — confirm against
                    # /v1/info before the sticky exclusion (a proxy or
                    # overload 503 must not silently retire a healthy
                    # worker).  Confirmed: the mesh shrank by choice, no
                    # breaker vote, re-plan without it.  Unconfirmed:
                    # another worker takes this task, the mesh stays.
                    if self._confirmed_draining(url):
                        raise MeshChangedError(drained=[url])
                    break
                except Exception as exc:
                    last = exc
                    if _is_refused(exc):
                        breaker.record_failure()
                        break  # REFUSED: nobody listening, don't retry
                    if _is_transient(exc) or self._is_conn_dead(exc):
                        # flaky connection (RESET included): a backed-off
                        # retry against the SAME worker absorbs it — one
                        # flap must not blacklist a healthy worker
                        breaker.record_failure()
                        continue
                    raise  # a real error must not masquerade as dead
            if not submitted:
                # refused/exhausted submits are strong but not sufficient
                # evidence (a restart blip or backlog overflow refuses one
                # connection on a healthy worker): confirm with a fresh
                # probe before the sticky eviction.  Confirmed dead →
                # shrink the mesh; still answering → another worker takes
                # this task and the mesh stays W-wide.
                self.runner._worker_health.pop(url, None)
                if self._confirmed_dead(url):
                    raise MeshChangedError(dead=[url])
                continue
            breaker.record_success()
            self._descs[desc.task_id] = desc
            self._submit_t[desc.task_id] = now()
            # abort propagation: the executing query cancels this task if
            # it is killed (RemoteTaskClient.cancel fan-out)
            lifecycle.register_task(client)
            return client
        raise RuntimeError(f"no live worker accepted {desc.task_id}: {last}")

    def _replace_task(self, fid: int, idx: int):
        """Reassign task `idx` of stage `fid` after it failed.  Producers
        below are repaired first so the refreshed input URLs resolve.  A
        FAILED task does not imply a dead worker (it may have failed
        pulling inputs from one that died): the old worker is probed on
        fresh evidence — alive means the task re-runs on a live worker at
        the SAME W; dead means the mesh shrank and the whole query
        re-plans (MeshChangedError)."""
        import dataclasses

        sub = self._subplans[fid]
        for child in sub.children:
            self._repair_stage(child.fragment.id)
        old = self._stage_tasks[fid][idx]
        # the failure is fresh evidence: bypass the cached verdict.  Only a
        # CONFIRMED-dead worker shrinks the mesh — an alive one (including
        # breaker-open cooling) just gets the task re-run elsewhere.
        self.runner._worker_health.pop(old.worker_url, None)
        if self._confirmed_dead(old.worker_url):
            raise MeshChangedError(dead=[old.worker_url])
        desc = self._descs[old.task_id]
        desc = dataclasses.replace(
            desc,
            task_id=f"{desc.task_id}r{next(self.runner._task_seq)}",
            inputs=self._input_urls(sub, consumer_index=idx),
        )
        new = self._submit_on_live(desc, self._least_loaded_worker())
        self._stage_tasks[fid][idx] = new
        return new

    def _repair_stage(self, fid: int) -> None:
        tasks = self._stage_tasks.get(fid)
        if tasks is None or isinstance(tasks, _LocalResult):
            return
        sub = self._subplans[fid]
        for child in sub.children:
            self._repair_stage(child.fragment.id)
        for i, t in enumerate(list(tasks)):
            # repairs run on failure evidence: cached health is stale by
            # definition here, probe fresh — and only CONFIRMED death (a
            # failed socket probe, not an open breaker) shrinks the mesh
            self.runner._worker_health.pop(t.worker_url, None)
            if self._confirmed_dead(t.worker_url):
                raise MeshChangedError(dead=[t.worker_url])

    def cancel_all(self) -> None:
        """Best-effort cancel of every submitted task (an abandoned
        scheduling attempt must not pin worker slots through the replay)."""
        for tasks in self._stage_tasks.values():
            if isinstance(tasks, _LocalResult):
                continue
            for t in tasks:
                try:
                    t.cancel()
                except Exception:
                    pass

    def run(self, root: SubPlan) -> PhysicalPlan:
        self._register(root)
        for child in root.children:
            self._ensure_stage(child)
        return self._coordinator_fragment(root)

    def collect_spans(self) -> None:
        """Pull every completed task's span tree and graft it under its
        stage's coordinator fragment span, producing ONE merged cross-host
        trace (reference: the coordinator folding the distributed
        task-event stream into the query-level view).  Worker `now()`
        clocks are per-process perf counters with unrelated epochs, so
        each tree is anchored at the submission instant the coordinator
        observed for that task — relative timing within a worker tree is
        exact, cross-host alignment is submit-instant approximate."""
        tr = self.tracer
        if not tr.enabled:
            return
        for fid, tasks in self._stage_tasks.items():
            if isinstance(tasks, _LocalResult):
                continue
            fsp = self._fragment_spans.get(fid)
            if fsp is None:
                continue
            end = fsp.end_s
            for t in tasks:
                tree = t.spans()
                if not tree:
                    continue  # task failed / worker gone: no worker spans
                anchor = self._submit_t.get(t.task_id, fsp.start_s)
                sp = tr.graft(
                    fsp, tree, offset_s=anchor - float(tree["start_s"])
                )
                end = sp.end_s if end is None else max(end, sp.end_s)
            # the fragment span covers submission through its last task's
            # completion (zero-width when no task returned spans)
            fsp.end_s = end if end is not None else fsp.start_s

    def _register(self, sub: SubPlan) -> None:
        self._subplans[sub.fragment.id] = sub
        for c in sub.children:
            self._register(c)

    # -- distributed stages ---------------------------------------------------

    def _ensure_stage(self, sub: SubPlan):
        fid = sub.fragment.id
        if fid in self._stage_tasks:
            return self._stage_tasks[fid]
        if fid in self.runner._fte_completed:
            # fault-tolerant recovery: this fragment finished on an
            # earlier attempt and its output is spooled — serve it from
            # disk, and do NOT recurse into its children (finished
            # upstream fragments are never re-executed: the Tardigrade
            # property the spool buys).  A lost spool file falls through
            # to normal re-execution.
            spooled = self.runner._load_spooled_fragment(fid)
            if spooled is not None:
                self._stage_tasks[fid] = _LocalResult(
                    spooled, self.runner.device
                )
                return self._stage_tasks[fid]
        self._collect_dynamic_filters(sub)
        for child in sub.children:
            self._ensure_stage(child)
        if sub.fragment.partitioning.kind not in _DIST:
            # nested SINGLE fragment: run locally, expose its output as a
            # one-bucket local "task" via an in-memory stub
            out = self._coordinator_fragment(sub)
            self._stage_tasks[fid] = _LocalResult(out, self.runner.device)
            return self._stage_tasks[fid]
        w = self.plan_w
        tasks = []
        # tasks inherit what's left of the query deadline: a worker bounds
        # its own run AND its input-pull timeouts by it, so no task outlives
        # the query that scheduled it (HttpRemoteTask deadline derivation)
        qctx = lifecycle.current_query()
        deadline_s = qctx.remaining_s() if qctx is not None else None
        # cross-host trace context: one coordinator-side fragment span per
        # stage; its (trace id, span id) rides every task descriptor like
        # deadline_s does, and collect_spans() grafts the workers' trees
        # under it (the W3C traceparent analog)
        trace_context = None
        if self.tracer.enabled:
            t_sub = now()
            fsp = self.tracer.record(
                "fragment", t_sub, t_sub,
                {"fragment_id": fid,
                 "kind": sub.fragment.partitioning.kind, "tasks": w},
            )
            self._fragment_spans[fid] = fsp
            trace_context = (self.tracer.query_id, fsp.span_id)
        # plan_w task slots round-robin over the (possibly fewer) live
        # workers: a recovery pass keeps the fragmentation width, so a
        # survivor may host more than one slot of a stage
        for i in range(w):
            url = self.workers[i % len(self.workers)]
            desc = TaskDescriptor(
                task_id=f"t{next(self.runner._task_seq)}_f{fid}_w{i}",
                fragment_root=sub.fragment.root,
                output_symbols=sub.fragment.root.outputs,
                inputs=self._input_urls(sub, consumer_index=i),
                output_partitioning=self._output_partitioning(sub),
                split_mod=(i, w),
                properties=dict(self.runner.properties._values),
                dynamic_ranges=dict(self._pending_ranges.get(fid, {})),
                collect_ranges=fid in self._want_ranges,
                deadline_s=deadline_s,
                trace_context=trace_context,
            )
            tasks.append(self._submit_on_live(desc, url))
        self._stage_tasks[fid] = tasks
        return tasks

    def _collect_dynamic_filters(self, sub: SubPlan) -> None:
        """Cross-fragment dynamic filtering (reference:
        DynamicFilterService + DynamicFiltersFetcher): for an inner join in
        this fragment whose build AND probe sides both arrive through
        exchanges, run the build-side stage FIRST, wait for it, collect the
        workers' per-column value-range summaries, and deliver the probe
        symbols' ranges inside the probe fragment's task descriptors."""
        from trino_tpu_torch.planner import plan as P

        def remote_ids(node) -> set:
            if isinstance(node, RemoteSourceNode):
                return {node.fragment_id}
            out: set = set()
            for c in node.children:
                out |= remote_ids(c)
            return out

        def visit(node) -> None:
            for c in node.children:
                visit(c)
            if not (isinstance(node, P.JoinNode) and node.kind == "inner"):
                return
            build_ids = remote_ids(node.right)
            probe_ids = remote_ids(node.left)
            if not build_ids or not probe_ids:
                return
            child_by_id = {c.fragment.id: c for c in sub.children}
            builds = [child_by_id[f] for f in build_ids if f in child_by_id]
            probes = [f for f in probe_ids if f in child_by_id]
            if not builds or not probes:
                return
            for bsub in builds:
                self._want_ranges.add(bsub.fragment.id)
                tasks = self._ensure_stage(bsub)
                ranges = self._merged_ranges(tasks)
                if not ranges:
                    continue
                outs = {s.name for s in bsub.fragment.root.outputs}
                for lsym, rsym in node.criteria:
                    rng = ranges.get(rsym.name) if rsym.name in outs else None
                    if rng is None:
                        continue
                    for pf in probes:
                        self._pending_ranges.setdefault(pf, {})[
                            lsym.name
                        ] = tuple(rng)

        visit(sub.fragment.root)

    def _merged_ranges(self, tasks) -> dict:
        """Union of completed build tasks' column ranges ({} on any
        failure/timeout — dynamic filters are an optimization, never a
        correctness dependency)."""
        import json as _json

        merged: dict = {}
        for t in tasks:
            if isinstance(t, _LocalResult):
                return {}
            try:
                # the /dynamic endpoint blocks on task completion itself;
                # the state poll sits INSIDE the try too — a transient flap
                # on either request must degrade to "no dynamic filter",
                # never fail the query
                body = _http_get(
                    f"{t.worker_url}/v1/task/{t.task_id}/dynamic"
                )
                ranges = _json.loads(body.decode())
                if t.state() != "FINISHED":
                    return {}
            except QueryAbortedException:
                raise  # canceled/expired is not an optimization miss
            except Exception:
                return {}
            for name, (lo, hi) in ranges.items():
                if name in merged:
                    mlo, mhi = merged[name]
                    merged[name] = (min(mlo, lo), max(mhi, hi))
                else:
                    merged[name] = (lo, hi)
        return merged

    def _output_partitioning(self, sub: SubPlan) -> Optional[tuple]:
        """How the PARENT consumes this fragment decides the bucket layout
        (SystemPartitioningHandle on the fragment's output)."""
        parent = self._parent_remote(sub)
        if parent is None or parent.exchange_kind in ("gather", "merge", "broadcast"):
            return None  # one bucket, every consumer reads it whole
        # repartition: bucket by the exchange's partition symbols
        outs = sub.fragment.root.outputs
        chans = []
        for s in parent.partition_symbols:
            for i, o in enumerate(outs):
                if o.name == s.name:
                    chans.append(i)
                    break
        return (chans, self.plan_w)

    def _parent_remote(self, sub: SubPlan) -> Optional[RemoteSourceNode]:
        target = sub.fragment.id

        def find(node) -> Optional[RemoteSourceNode]:
            if isinstance(node, RemoteSourceNode) and node.fragment_id == target:
                return node
            for c in node.children:
                got = find(c)
                if got is not None:
                    return got
            return None

        for other in self._subplans.values():
            if other.fragment.id == target:
                continue
            got = find(other.fragment.root)
            if got is not None:
                return got
        return None

    def _input_urls(self, sub: SubPlan, consumer_index: int) -> dict:
        """URLs for every RemoteSourceNode under this fragment's root."""
        urls: dict = {}

        def walk(node):
            if isinstance(node, RemoteSourceNode):
                producers = self._stage_tasks[node.fragment_id]
                if node.exchange_kind == "repartition":
                    bucket = consumer_index
                else:  # broadcast (single bucket read by everyone)
                    bucket = 0
                urls[node.fragment_id] = [
                    t.result_url(bucket) for t in producers
                ]
                return
            for c in node.children:
                walk(c)

        walk(sub.fragment.root)
        return urls

    # -- coordinator-side fragments -------------------------------------------

    def _coordinator_fragment(self, sub: SubPlan) -> PhysicalPlan:
        from trino_tpu_torch.parallel.serde import bytes_to_batches

        device = self.runner.device
        lp = LocalExecutionPlanner(
            self.runner.catalogs,
            device,
            target_splits=self.runner.properties.get("target_splits"),
            properties=self.runner.properties,
        )
        saved = lp.plan
        sched = self

        def pull(t, fid: int) -> list:
            """One producer's page set; its bytes and decode seconds add to
            the stage's fragment span when the query is traced."""
            body = _fetch_ok(t)
            t0 = time.perf_counter()
            bs = bytes_to_batches(body)
            fsp = sched._fragment_spans.get(fid)
            if fsp is not None:
                a = fsp.attrs
                a["pulled_bytes"] = a.get("pulled_bytes", 0) + len(body)
                a["decode_s"] = a.get("decode_s", 0.0) + time.perf_counter() - t0
            return bs

        def hook(node):
            if isinstance(node, RemoteSourceNode):
                producers = sched._stage_tasks[node.fragment_id]
                if isinstance(producers, _LocalResult):
                    return producers.plan
                batches = []
                per_producer = []
                for i, t in enumerate(list(producers)):
                    try:
                        bs = pull(t, node.fragment_id)
                    except QueryAbortedException:
                        raise  # canceled/expired: stop, don't reschedule
                    except Exception:
                        # worker died (or its task failed) after submission:
                        # reassign to a live worker and re-read
                        t2 = sched._replace_task(node.fragment_id, i)
                        bs = pull(t2, node.fragment_id)
                    per_producer.append(bs)
                    batches.extend(bs)
                if node.exchange_kind == "merge":
                    return sched._merge(per_producer, node)
                # the fragment's output is fully fetched: spool it (no-op
                # unless fault_tolerant_execution) so a recovery pass
                # resumes from here instead of re-executing the fragment.
                # Merge exchanges skip the spool: their consumption is
                # per-producer ordered, not a flat batch list.
                sched.runner._spool_fragment(
                    node.fragment_id, batches, node.symbols
                )
                # the wire yields CPU batches: the fragment reads them on
                # the coordinator's device
                return PhysicalPlan(
                    iter([b.to(device) for b in batches]), node.symbols
                )
            return saved(node)

        lp.plan = hook
        return lp.plan(sub.fragment.root)

    def _merge(self, per_producer: list, node: RemoteSourceNode) -> PhysicalPlan:
        """Ordered merge of per-worker sorted shards (MergeOperator role),
        on the host; the merged batch moves to the coordinator's device."""
        import numpy as np

        from trino_tpu_torch.columnar.batch import concat_batches
        from trino_tpu_torch.ops.common import SortKey
        from trino_tpu_torch.ops.merge import merge_sorted_shards

        shards = []
        for bs in per_producer:
            if not bs:
                continue
            host = concat_batches(bs)  # pulled page sets are CPU batches
            mask = host.mask().numpy()
            idx = np.nonzero(mask)[0]
            shards.append(_take_host(host, idx))
        if not shards:
            return PhysicalPlan(iter(()), node.symbols)
        chan = {s.name: i for i, s in enumerate(node.symbols)}
        keys = [
            SortKey(chan[s.name], asc, nf) for s, asc, nf in node.orderings
        ]
        merged = merge_sorted_shards(shards, keys)
        return PhysicalPlan(
            iter([merged.to(self.runner.device)]), node.symbols
        )


class _LocalResult:
    """A fragment output materialized on the coordinator (a nested SINGLE
    fragment's, or a spooled one's CPU batches), on the coordinator's
    device."""

    def __init__(self, plan: PhysicalPlan, device):
        batches = [b.to(device) for b in plan.stream]
        self.plan = PhysicalPlan(iter(batches), plan.symbols)


def _take_host(batch, idx):
    import torch

    from trino_tpu_torch.columnar import Batch, Column

    idx = torch.as_tensor(idx, dtype=torch.int64)
    cols = []
    for c in batch.columns:
        data = c.data[idx]
        valid = None if c.valid is None else c.valid[idx]
        lens = None if c.lengths is None else c.lengths[idx]
        cols.append(Column(data, c.type, valid, c.dictionary, lens))
    return Batch(cols, torch.ones(len(idx), dtype=torch.bool))


def _fetch_ok(task: RemoteTaskClient, backoff: Optional[Backoff] = None) -> bytes:
    """Fetch bucket 0, surfacing worker-side failures.  Transient
    connection failures retry against the same worker behind capped
    exponential backoff with full jitter (reference: Backoff.java wait in
    the HttpPageBufferClient pull loop); each outcome feeds the worker's
    circuit breaker.  An HTTPError means the worker ANSWERED — its task
    failed — so it raises immediately (retrying can't fix the task, and
    the worker itself is healthy).  The retry budget (`remote.fetch-
    attempts`) bounds how long a dead worker stalls the pull before the
    caller falls back to task replacement / mesh-shrink re-planning."""
    cfg = get_config().remote
    backoff = backoff or Backoff(
        base_s=cfg.backoff_base_s, cap_s=cfg.backoff_cap_s
    )
    breaker = BREAKERS.get(task.worker_url)
    last: Optional[BaseException] = None
    for attempt in range(cfg.fetch_attempts):
        check_current()  # canceled/expired queries stop pulling results
        if attempt:
            backoff.wait(attempt - 1)
        try:
            body = _http_get(task.result_url(0))
        except urllib.error.HTTPError as e:
            breaker.record_success()  # the socket answered; the TASK failed
            raise RuntimeError(
                f"task {task.task_id} failed on {task.worker_url}: "
                f"{e.read().decode()[:2000]}"
            ) from None
        except QueryAbortedException:
            raise  # lifecycle abort, not worker evidence: no breaker vote
        except Exception as e:
            last = e
            breaker.record_failure()
            if _is_transient(e):
                continue
            raise
        breaker.record_success()
        return body
    raise last

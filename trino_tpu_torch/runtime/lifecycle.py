"""Query lifecycle: state machine, deadlines, cooperative cancellation,
and the low-memory killer.

Port of trino_tpu/runtime/lifecycle.py.  Reference roles:
execution/QueryTracker.java (enforceTimeLimits: the query_max_run_time /
query_max_planning_time sweep), QueryStateMachine (QUEUED -> RUNNING ->
FINISHING -> FINISHED|FAILED|CANCELED, terminal states frozen), and
memory/LowMemoryKiller.java + TotalReservationLowMemoryKiller (pick the
query with the largest reservation when the pool blocks).

One `QueryContext` per statement, created by `LocalQueryRunner.execute`
through its `QueryTracker` and published through a contextvar, so deep
call sites (result batches, mesh launches, fragment boundaries, the
exchange) consult it without a handle.  Cancellation is COOPERATIVE and
runs on the host: `check()` between result batches, before each mesh
launch, at each fragment and in the exchange's counts pass.  Work already
queued on the card when a check raises finishes there; the runner then
closes the result stream, the statement's spill stores and its memory
reservations.

Remote tasks of the multi-host tier (parallel/remote.py) register on the
executing query (`register_task`); an abort fans `RemoteTaskClient.cancel`
out to every live one (`cancel_tasks`), and every HTTP wait is bounded by
what is left of the query (`http_timeout`, `request_timeout`; reference:
HttpRemoteTask's per-request deadline derivation).
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Callable, Optional

# -- error surface ------------------------------------------------------------


class QueryAbortedException(RuntimeError):
    """Base for lifecycle aborts.  Deliberately NOT a ConnectionError /
    TimeoutError subclass: retry machinery must never classify an abort as
    transient and re-run the query past its deadline."""

    #: reference: spi ErrorCode name carried into QueryCompletedEvent
    error_code: str = "ABORTED"


class QueryCanceledException(QueryAbortedException):
    """DELETE /v1/query/{id} or QueryTracker.cancel (USER_ERROR/CANCELED)."""

    error_code = "USER_CANCELED"


class QueryDeadlineExceeded(QueryAbortedException):
    """query_max_run_time / query_max_planning_time expired
    (INSUFFICIENT_RESOURCES / EXCEEDED_TIME_LIMIT)."""

    error_code = "EXCEEDED_TIME_LIMIT"


class QueryQueuedTimeExceeded(QueryAbortedException):
    """query_max_queued_time expired while the query waited for admission
    (reference: QueryTracker.enforceTimeLimits' queued-time sweep /
    EXCEEDED_QUEUED_TIME_LIMIT).  Raised by the dispatcher's admission
    wait, BEFORE the query ever occupies an engine lane."""

    error_code = "EXCEEDED_QUEUED_TIME_LIMIT"


class QueryKilledException(QueryAbortedException):
    """Chosen as the low-memory killer's victim
    (INSUFFICIENT_RESOURCES / CLUSTER_OUT_OF_MEMORY)."""

    error_code = "CLUSTER_OUT_OF_MEMORY"


#: QueryContext.kill reason -> exception class raised at the next check()
_REASON_EXC = {
    "canceled": QueryCanceledException,
    "deadline": QueryDeadlineExceeded,
    "memory": QueryKilledException,
}


# -- task-recovery classification (fault-tolerant execution) -------------------

#: recovery action vocabulary (the {outcome} label of
#: trino_tpu_task_retries_total and the `recovery` decision kind)
RETRY = "retry"
REPLAN = "replan"
FAIL = "fail"

#: per-error-code recovery classification (reference: the retry-type
#: predicate split of EventDrivenFaultTolerantQueryScheduler — worker
#: failures re-run only the lost tasks; user errors are never retried).
#:
#:   retry  — same plan, lost tasks only: the mesh signature the plan was
#:            fragmented for still has live hosts, finished fragments
#:            resume from spooled intermediates, only lost outputs re-run.
#:   replan — the mesh signature truly changed (survivors cannot host the
#:            plan's fragments): re-fragment the query at the shrunk W.
#:   fail   — user/semantic errors: retrying re-raises the same error, so
#:            the classification NEVER retries them.  Unknown codes
#:            default here too — an unclassified error is not evidence of
#:            a lost task.
RECOVERY_CLASSIFICATION = {
    # lost tasks: the work is retryable, the plan is not at fault
    "WORKER_DEATH": RETRY,
    "WORKER_DRAIN": RETRY,
    "TRANSIENT_FETCH": RETRY,
    # the mesh the plan was fragmented for no longer exists
    "MESH_SHRINK_BELOW_REQUIREMENT": REPLAN,
    # user/semantic: retrying cannot change the outcome
    "USER_CANCELED": FAIL,
    "EXCEEDED_TIME_LIMIT": FAIL,
    "EXCEEDED_QUEUED_TIME_LIMIT": FAIL,
    "CLUSTER_OUT_OF_MEMORY": FAIL,
    "ABORTED": FAIL,
    "STAGE_FAILED": FAIL,
    "INTERNAL_ERROR": FAIL,
}


def error_code_of(exc: BaseException) -> str:
    """Classify an exception into the recovery table's error-code
    vocabulary (lifecycle aborts carry their own code; a connection or
    timeout failure is a transient fetch).  The JAX package also maps its
    membership errors (worker death and drain) here; membership is not
    ported, so nothing in the port raises them."""
    if isinstance(exc, QueryAbortedException):
        return exc.error_code
    from trino_tpu_torch.runtime.retry import StageFailedException

    if isinstance(exc, StageFailedException):
        return "STAGE_FAILED"
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return "TRANSIENT_FETCH"
    return "INTERNAL_ERROR"


def recovery_action(exc: BaseException) -> str:
    """The classified recovery action for an error (`retry` | `replan` |
    `fail`); unknown codes fail — an unclassified error is never
    retried."""
    return RECOVERY_CLASSIFICATION.get(error_code_of(exc), FAIL)


# -- state machine ------------------------------------------------------------

QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHING = "FINISHING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELED = "CANCELED"

TERMINAL_STATES = frozenset({FINISHED, FAILED, CANCELED})

#: legal transitions (reference: execution/QueryState.java's ordering —
#: terminal states are frozen, and the machine never moves backwards)
_TRANSITIONS = {
    QUEUED: {RUNNING, FAILED, CANCELED},
    RUNNING: {FINISHING, FAILED, CANCELED},
    FINISHING: {FINISHED, FAILED, CANCELED},
    FINISHED: set(),
    FAILED: set(),
    CANCELED: set(),
}


class InvalidStateTransition(RuntimeError):
    pass


class QueryContext:
    """Per-query lifecycle handle: state machine + deadline + cancellation
    token + attached memory contexts."""

    def __init__(
        self,
        query_id: str,
        max_run_time_s: float = 0.0,
        max_planning_time_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.query_id = query_id
        self.clock = clock
        self.created_at = clock()
        self.state = QUEUED
        #: absolute deadlines on the injectable clock (None = unbounded)
        self.deadline = (
            self.created_at + max_run_time_s if max_run_time_s > 0 else None
        )
        self.planning_deadline = (
            self.created_at + max_planning_time_s
            if max_planning_time_s > 0
            else None
        )
        self._lock = threading.Lock()
        self._cancel = threading.Event()
        #: why the token fired: canceled | deadline | memory
        self.kill_reason: Optional[str] = None
        #: human-readable detail surfaced in the raised exception
        self.kill_detail: Optional[str] = None
        #: live RemoteTaskClient handles (multi-host); canceled on abort
        #: query-level MemoryContexts reserved on the shared pool; released
        #: when the statement finishes (success OR failure)
        self._memory: list = []
        #: live SpillManagers owned by this query (runtime/spill registers
        #: them at construction): a query killed or canceled mid-wave must
        #: release its spill partitions through the filesystem SPI NOW,
        #: not when the abandoned wave generator happens to be GC'd or the
        #: hours-scale orphan sweep runs
        self._spills: list = []
        #: live RemoteTaskClient handles (multi-host); canceled on abort
        self._tasks: list = []
        # -- per-statement telemetry handles (the lane-safety contract):
        # concurrent engine lanes each resolve THEIR statement's tracer /
        # mesh profile / trace export through this context instead of
        # racing shared runner attributes (runner.last_mesh_profile and
        # runner.last_trace are properties over these)
        #: the statement's SpanTracer (None until execute installs one)
        self.tracer = None
        #: the statement's MeshProfile (distributed executions only)
        self.mesh_profile = None
        #: peak device-memory reservation of the statement's local plan
        self.peak_memory = 0
        #: Chrome-trace JSON exported when the statement finished tracing
        self.trace_json = None
        #: seconds this statement spent waiting on the device time-slice
        #: gate (runtime/dispatcher device_slice, contended acquires only)
        self.gate_wait_s = 0.0
        #: reference to this statement's archived profile artifact
        #: (telemetry/profile_store), set after FINISHING
        self.profile_ref = None
        #: the statement's plan-decision ledger (telemetry/decisions):
        #: planner rules and runtime branches record choices here via the
        #: contextvar, the runner joins outcomes + stamps hindsight before
        #: archiving (same lane-safety contract as the tracer)
        self.decisions = None

    # -- state machine --------------------------------------------------------

    def transition(self, to: str) -> None:
        with self._lock:
            self._transition_locked(to)

    def _transition_locked(self, to: str) -> None:  # lint: allow(unguarded-state)
        """Caller holds self._lock."""
        if to not in _TRANSITIONS.get(self.state, set()):
            raise InvalidStateTransition(
                f"query {self.query_id}: illegal transition "
                f"{self.state} -> {to}"
            )
        self.state = to

    @property
    def done(self) -> bool:
        with self._lock:
            return self.state in TERMINAL_STATES

    def begin(self) -> None:
        self.transition(RUNNING)

    def finishing(self) -> None:
        # check-then-transition is atomic: a concurrent fail() cannot slip
        # between the read and the write (the unguarded-state race the
        # concurrency analyzer flagged — finish() could resurrect a FAILED
        # query to FINISHED)
        with self._lock:
            if self.state == RUNNING:
                self._transition_locked(FINISHING)

    def finish(self) -> None:
        with self._lock:
            if self.state == RUNNING:
                # short statements (SET SESSION) may finish without FINISHING
                self._transition_locked(FINISHING)
            if self.state == FINISHING:
                self._transition_locked(FINISHED)
            elif self.state == QUEUED:
                self.state = FINISHED

    def fail(self, exc: BaseException) -> str:
        """Move to the terminal failure state for `exc`; returns the event
        state string (CANCELED for user cancels, FAILED otherwise)."""
        state = CANCELED if isinstance(exc, QueryCanceledException) else FAILED
        with self._lock:
            if self.state not in TERMINAL_STATES:
                self.state = state
        self.cancel_tasks()
        return state

    # -- cancellation token ---------------------------------------------------

    def cancel(self, detail: Optional[str] = None) -> None:
        """User-initiated cancel (DELETE /v1/query/{id})."""
        self.kill(reason="canceled", detail=detail or "canceled by user")

    def kill(self, reason: str, detail: Optional[str] = None) -> None:
        """Arm the token; the query aborts at its next cooperative check.
        First reason wins (a memory kill is not overwritten by a later
        deadline sweep)."""
        with self._lock:
            if self.kill_reason is None:
                self.kill_reason = reason
                self.kill_detail = detail
        self._cancel.set()
        self.cancel_tasks()

    @property
    def canceled(self) -> bool:
        return self._cancel.is_set()

    def remaining_s(self) -> Optional[float]:
        """Seconds left until the run deadline (None = unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - self.clock()

    def check(self) -> None:
        """Cooperative cancellation point: raises the classified abort when
        the token fired or the deadline passed.  Cheap (one Event.is_set +
        one clock read) — safe at per-batch / per-launch granularity."""
        if self._cancel.is_set():
            with self._lock:  # reason/detail are written under the lock
                reason, detail = self.kill_reason, self.kill_detail
            exc = _REASON_EXC.get(reason, QueryCanceledException)
            raise exc(
                f"query {self.query_id} {detail or reason or 'canceled'}"
            )
        if self.deadline is not None and self.clock() > self.deadline:
            # arm through kill() so live remote tasks get their cancel
            self.kill(
                "deadline",
                detail=(
                    f"exceeded query_max_run_time "
                    f"({self.deadline - self.created_at:.3f}s)"
                ),
            )
            raise QueryDeadlineExceeded(
                f"query {self.query_id} exceeded query_max_run_time "
                f"({self.deadline - self.created_at:.3f}s)"
            )

    def check_planning(self) -> None:
        """Planning-phase deadline (query_max_planning_time); also enforces
        the run deadline and the token."""
        self.check()
        if (
            self.planning_deadline is not None
            and self.clock() > self.planning_deadline
        ):
            self.kill(
                "deadline",
                detail=(
                    f"exceeded query_max_planning_time "
                    f"({self.planning_deadline - self.created_at:.3f}s)"
                ),
            )
            raise QueryDeadlineExceeded(
                f"query {self.query_id} exceeded query_max_planning_time "
                f"({self.planning_deadline - self.created_at:.3f}s)"
            )

    def http_timeout(self, default: Optional[float] = None) -> float:
        """Per-request timeout derived from the deadline: never wait on a
        socket longer than the query has left to live.  Raises when the
        deadline already passed (the request would be pointless).
        `default=None` reads the typed config's `lifecycle.request-timeout`."""
        if default is None:
            from trino_tpu_torch.config import get_config

            default = get_config().lifecycle.request_timeout_s
        self.check()
        rem = self.remaining_s()
        if rem is None:
            return default
        return max(min(default, rem), 0.001)

    # -- abort propagation ----------------------------------------------------

    def register_task(self, client) -> None:
        """Track a live remote task so aborts propagate its cancel."""
        with self._lock:
            self._tasks.append(client)

    def cancel_tasks(self) -> None:
        """Best-effort RemoteTaskClient.cancel on every registered task
        (reference: SqlStageExecution cancel fan-out on query failure)."""
        with self._lock:
            tasks, self._tasks = self._tasks, []
        for t in tasks:
            try:
                t.cancel()
            except Exception:
                pass

    # -- memory ---------------------------------------------------------------

    def attach_memory(self, ctx) -> None:
        with self._lock:
            self._memory.append(ctx)

    def memory_reserved(self) -> int:
        with self._lock:
            return sum(m.reserved for m in self._memory)

    def release_memory(self) -> None:
        """Release every query-level reservation; `peak_memory` keeps the
        largest peak among them."""
        with self._lock:
            mem, self._memory = self._memory, []
        for m in mem:
            self.peak_memory = max(self.peak_memory, m.peak)
            m.force_release()

    # -- device-gate accounting -----------------------------------------------

    def note_gate_wait(self, wait_s: float) -> None:
        """Fold one contended device-gate wait into this query's total
        (called by dispatcher._DeviceSlice on the contended path only; a
        statement's steps run on one thread at a time, the lock guards
        against an overlapping EXPLAIN-ANALYZE reader)."""
        with self._lock:
            self.gate_wait_s += wait_s

    # -- spill ----------------------------------------------------------------

    def register_spill(self, spiller) -> None:
        """Track a live SpillManager so aborts delete its partitions."""
        with self._lock:
            self._spills.append(spiller)

    def unregister_spill(self, spiller) -> None:
        with self._lock:
            if spiller in self._spills:
                self._spills.remove(spiller)

    def release_spills(self) -> None:
        """Close every still-open SpillManager (statement end, success OR
        abort): its partition files are deleted now.  Close is idempotent,
        so a wave loop's own finally running later is harmless."""
        with self._lock:
            spills, self._spills = self._spills, []
        for s in spills:
            s.close()


# -- current-query contextvar -------------------------------------------------

_CURRENT: "contextvars.ContextVar[Optional[QueryContext]]" = (
    contextvars.ContextVar("trino_tpu_torch_current_query", default=None)
)


def current_query() -> Optional[QueryContext]:
    return _CURRENT.get()


def set_current(ctx: Optional[QueryContext]):
    """Install `ctx` as the executing query; returns the reset token."""
    return _CURRENT.set(ctx)


def reset_current(token) -> None:
    _CURRENT.reset(token)


def check_current() -> None:
    """Cooperative cancellation point for call sites without a handle."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.check()


def check_current_planning() -> None:
    """Planning-phase cancellation point (query_max_planning_time)."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.check_planning()


def request_timeout(default: Optional[float] = None) -> float:
    """HTTP timeout for the executing query: bounded by the query's
    remaining run time, `default` when no query or no deadline.
    `default=None` reads the typed config's `lifecycle.request-timeout`."""
    if default is None:
        from trino_tpu_torch.config import get_config

        default = get_config().lifecycle.request_timeout_s
    ctx = _CURRENT.get()
    if ctx is None:
        return default
    return ctx.http_timeout(default)


def register_task(client) -> None:
    """Attach a remote task to the executing query (no-op without one)."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.register_task(client)


def register_spill(spiller) -> None:
    """Attach a SpillManager to the executing query/task (no-op without
    one): its partitions are released at statement end even when the wave
    generator that owns it is abandoned mid-stream by an abort."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.register_spill(spiller)


# -- dispatcher admission context ---------------------------------------------

#: the resource-group memory sub-pool the executing query was admitted
#: under (runtime/dispatcher sets it around each admitted run): when set,
#: query_memory_context parents query reservations under the GROUP node so
#: the group's memory_limit_bytes bounds them
_GROUP_MEMORY: "contextvars.ContextVar" = contextvars.ContextVar(
    "trino_tpu_torch_group_memory", default=None
)

#: (group name, queued seconds) of the executing query's admission — the
#: tracer's queue span and EXPLAIN ANALYZE read it
_ADMISSION: "contextvars.ContextVar" = contextvars.ContextVar(
    "trino_tpu_torch_admission", default=None
)


def set_group_memory(ctx):
    return _GROUP_MEMORY.set(ctx)


def reset_group_memory(token) -> None:
    _GROUP_MEMORY.reset(token)


def current_group_memory():
    return _GROUP_MEMORY.get()


def set_admission_info(info):
    """info = (group name, queued seconds)."""
    return _ADMISSION.set(info)


def reset_admission_info(token) -> None:
    _ADMISSION.reset(token)


def current_admission():
    return _ADMISSION.get()


#: engine-lane index of the executing statement (dispatcher sets it around
#: each admitted run); the device-gate occupancy gauge labels holds by it.
#: Default 0: undispatched executions (tests, dbapi, prewarm) are lane 0.
_LANE: "contextvars.ContextVar[int]" = contextvars.ContextVar(
    "trino_tpu_torch_lane", default=0
)


def set_lane(index: int):
    return _LANE.set(index)


def reset_lane(token) -> None:
    _LANE.reset(token)


def current_lane() -> int:
    return _LANE.get()


def note_gate_wait(wait_s: float) -> None:
    """Attribute a contended device-gate wait to the executing query
    (no-op without one — e.g. a bare planner test taking the gate)."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.note_gate_wait(wait_s)


# -- tracker ------------------------------------------------------------------


class QueryTracker:
    """Live-query registry (reference: execution/QueryTracker.java).  One
    per runner; DELETE /v1/query/{id} resolves through it.  Canceling an id
    that has not registered yet pre-cancels it (cancel-while-queued)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._live: dict[str, QueryContext] = {}
        self._precanceled: set[str] = set()

    def create(self, query_id: str, properties=None) -> QueryContext:
        max_run = max_plan = 0.0
        if properties is not None:
            try:
                max_run = float(properties.get("query_max_run_time"))
                max_plan = float(properties.get("query_max_planning_time"))
            except KeyError:  # pragma: no cover - older property sets
                pass
        ctx = QueryContext(
            query_id,
            max_run_time_s=max_run,
            max_planning_time_s=max_plan,
            clock=self.clock,
        )
        with self._lock:
            self._live[query_id] = ctx
            pre = query_id in self._precanceled
            self._precanceled.discard(query_id)
        if pre:
            ctx.cancel("canceled before execution started")
        return ctx

    def get(self, query_id: str) -> Optional[QueryContext]:
        with self._lock:
            return self._live.get(query_id)

    def live(self) -> list:
        with self._lock:
            return list(self._live.values())

    def cancel(self, query_id: str) -> bool:
        """True when a live query was canceled; unknown ids pre-cancel (the
        query may be queued and not yet registered)."""
        with self._lock:
            ctx = self._live.get(query_id)
            if ctx is None:
                self._precanceled.add(query_id)
        if ctx is None:
            return False
        ctx.cancel()
        return True

    def remove(self, ctx: QueryContext) -> None:
        with self._lock:
            if self._live.get(ctx.query_id) is ctx:
                del self._live[ctx.query_id]


# -- low-memory killer --------------------------------------------------------


class LowMemoryKiller:
    """TotalReservationLowMemoryKiller analog: when a reservation would
    exceed the shared pool, kill the query holding the LARGEST reservation
    (never the requesting one while another holds more), reclaim its
    accounting, and let the blocked reservation retry."""

    def __call__(self, pool_root, requesting, delta: int) -> bool:
        """MemoryContext on_exceeded hook: True = freed something, retry;
        False = raise to the requester."""
        req_query = requesting.query_root()
        candidates = [q for q in pool_root.query_children if q.reserved > 0]
        if not candidates:
            return False
        victim = max(candidates, key=lambda q: q.reserved)
        if victim is req_query:
            # the requester holds the largest reservation: failing its
            # reservation IS the kill (never shoot a smaller bystander)
            return False
        from trino_tpu_torch.telemetry.metrics import memory_kills_counter

        memory_kills_counter().inc()
        if victim.owner is not None:
            victim.owner.kill(
                "memory",
                detail=(
                    f"killed by the low-memory killer: largest reservation "
                    f"({victim.reserved} bytes) when "
                    f"{requesting.name} requested {delta} more"
                ),
            )
        victim.force_release()
        return True


#: the process-wide memory pool every statement reserves on (reference:
#: MemoryPool.java's GENERAL pool); unlimited until set_memory_pool_limit
_GLOBAL_POOL = None
_POOL_LOCK = threading.Lock()


def memory_pool():
    """The process memory pool with the escalation hook installed: the
    revoke tier (runtime/spill.MemoryEscalation: the largest registered
    wave-capable operator spills and releases) runs first, the low-memory
    killer stays the last resort."""
    global _GLOBAL_POOL
    with _POOL_LOCK:
        if _GLOBAL_POOL is None:
            from trino_tpu_torch.runtime.memory import MemoryPool
            from trino_tpu_torch.runtime.spill import MemoryEscalation

            _GLOBAL_POOL = MemoryPool()
            _GLOBAL_POOL.root.on_exceeded = MemoryEscalation(LowMemoryKiller())
        return _GLOBAL_POOL


def set_memory_pool_limit(limit_bytes: int) -> None:
    """Arm (limit > 0) or disarm (0) the shared pool limit."""
    memory_pool().root.limit_bytes = int(limit_bytes)


def query_memory_context(limit_bytes: int = 0):
    """Per-query memory context for the execution planners: on the SHARED
    pool (visible to the killer, released by the runner at statement end)
    when a statement is executing, else on a private throwaway pool
    (planners built directly, as tests do).

    When the statement was admitted through a resource group with a
    memory sub-pool (the dispatcher sets `set_group_memory`), the query
    node parents under the GROUP node, so the group's limit bounds it and
    a breach escalates within the group; the node registers as a victim
    candidate on both the group and the pool root."""
    from trino_tpu_torch.runtime.memory import MemoryPool

    ctx = current_query()
    if ctx is None:
        return MemoryPool().query_context("query", limit_bytes)
    pool = memory_pool()
    group_ctx = current_group_memory()
    if group_ctx is None:
        mem = pool.query_context(ctx.query_id, limit_bytes)
    else:
        mem = group_ctx.child(f"query:{ctx.query_id}")
        mem.limit_bytes = limit_bytes
        mem.is_query_root = True
        with pool.root._lock:
            group_ctx.query_children.append(mem)
            pool.root.query_children.append(mem)
    mem.owner = ctx
    ctx.attach_memory(mem)
    return mem

"""Concurrent query serving: admission control + weighted-fair dispatch.

Reference roles: dispatcher/DispatchManager.java (the queued -> dispatched
query lifecycle, queue limits, shedding), execution/resourcegroups/
InternalResourceGroupManager (admission through weighted groups), and the
TaskExecutor time-slicing loop (SURVEY §5.7) — many queries share one
device by interleaving at fragment/batch boundaries, never by preemption.

Engine mapping.  A coordinator holding ONE global engine lock around
every statement executes exactly one statement at a time and has no
defined behavior under overload.  This module replaces that lock
with three coordinated tiers:

  * **Admission** — every statement enters a `ResourceGroup`'s FIFO queue
    (`enqueue`); a full queue SHEDS the statement (`QueryShedError`,
    surfaced as HTTP 429 + Retry-After before the request body is read);
    a statement queued past `query_max_queued_time` fails with
    EXCEEDED_QUEUED_TIME_LIMIT without ever occupying a lane; a DELETE on
    a queued query dequeues it without acquiring a slot.
  * **Weighted-fair scheduling** — the next statement comes from the
    eligible group (nonempty queue, below its `hard_concurrency`) with
    the smallest weighted virtual time, not from a global FIFO: saturated
    groups with weights w1:w2 converge to a w1:w2 admission ratio, and an
    idle group re-entering clamps to the global virtual clock so it gets
    its share immediately without starving everyone with banked credit.
  * **Engine lanes (time slicing)** — admitted statements run on `lanes`
    runner clones sharing the process trace cache, catalogs, tracker, and
    memory pool: host-side planning, analysis, and result serialization
    overlap across lanes, while actual device execution time-slices
    through the process-wide `device_slice()` gate at fragment/batch
    boundaries (feed/step/drain — SPMD launches stay serialized per
    device, no preemption).  Runners that cannot be cloned (multi-host)
    degrade to one lane: admission control and fairness still apply, and
    execution serializes exactly as before.

Memory: a group with `memory_limit_bytes` owns a sub-pool of the
shared MemoryContext tree; admitted queries reserve under it (the
contextvar `lifecycle.set_group_memory` routes `query_memory_context`),
so a group at its limit degrades through revoke -> wave -> kill WITHIN
the group (resource_groups.GroupMemoryEscalation) and can never kill a
bystander group's query.

Shutdown: `drain()` stops admission, fails every queued statement
classified (SERVER_SHUTTING_DOWN), waits `dispatcher.drain-wait` for
running ones, then force-kills stragglers through their lifecycle tokens
(the bounded force-kill contract) and waits a short grace.

Port of trino_tpu/runtime/dispatcher.py: a copy, with the package
renamed, less `system_admission` (the admission of prewarm replays onto
the primary lane), which raises NotImplementedError until prewarm is
ported.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Optional

from trino_tpu_torch.runtime.resource_groups import (
    SYSTEM_PREWARM_GROUP,
    ResourceGroup,
    ResourceGroupConfig,
    ResourceGroupManager,
)
from trino_tpu_torch.telemetry.spans import now

#: process-wide device time-slice gate: one compiled program launches at a
#: time; host work (parse/plan/serialize) runs outside it.  An RLock so
#: nested statement execution (EXECUTE -> execute) re-enters freely.
_DEVICE_GATE = threading.RLock()

#: gate contention telemetry state.  _GATE_WAITERS is mutated only on the
#: CONTENDED acquire path (under _WAITERS_LOCK); _GATE_HOLDER/_GATE_DEPTH
#: are mutated only by the thread HOLDING the gate (the gate itself is
#: their lock).  Readers (the occupancy callback gauge, the release-path
#: `if _GATE_WAITERS` check) take snapshots of a single int — stale by at
#: most one step, never torn.
_WAITERS_LOCK = threading.Lock()
_GATE_WAITERS = 0
_GATE_HOLDER = -1
_GATE_DEPTH = 0


def gate_holder() -> int:
    """Engine lane currently holding the device gate (-1 = idle); feeds
    the trino_tpu_device_gate_occupied callback gauge."""
    return _GATE_HOLDER


def gate_waiters() -> int:
    """Lanes currently blocked in a contended device-gate acquire."""
    return _GATE_WAITERS


class _DeviceSlice:
    """One timed passage through the device gate (see device_slice()).

    Cost contract (zero cost when idle, as the JAX package measures in
    tests/test_profile_store.py): the UNCONTENDED path is one non-blocking
    RLock acquire, ONE clock read, and two attribute writes per step — no
    histogram observe, no contextvar lookup beyond the holder label.  All
    wait accounting lives on the contended path, where the caller is about
    to block anyway; hold time is observed only when another lane waited
    during the hold (the contention-relevant holds)."""

    __slots__ = ("t_acq",)

    def __enter__(self):
        global _GATE_WAITERS, _GATE_HOLDER, _GATE_DEPTH
        if _DEVICE_GATE.acquire(blocking=False):
            self.t_acq = now()  # the one uncontended clock read
        else:
            from trino_tpu_torch.runtime import lifecycle
            from trino_tpu_torch.telemetry.metrics import gate_wait_histogram

            t0 = now()
            with _WAITERS_LOCK:
                _GATE_WAITERS += 1
            try:
                _DEVICE_GATE.acquire()
            finally:
                with _WAITERS_LOCK:
                    _GATE_WAITERS -= 1
            self.t_acq = now()
            wait = self.t_acq - t0
            gate_wait_histogram().observe(wait)
            lifecycle.note_gate_wait(wait)
        # depth/holder are guarded by the gate itself (holder-only writes)
        _GATE_DEPTH += 1
        if _GATE_DEPTH == 1:
            from trino_tpu_torch.runtime.lifecycle import current_lane

            _GATE_HOLDER = current_lane()
        return self

    def __exit__(self, et, ev, tb):
        global _GATE_HOLDER, _GATE_DEPTH
        _GATE_DEPTH -= 1
        if _GATE_DEPTH == 0:
            _GATE_HOLDER = -1
            if _GATE_WAITERS:
                from trino_tpu_torch.telemetry.metrics import gate_hold_histogram

                gate_hold_histogram().observe(now() - self.t_acq)
        _DEVICE_GATE.release()
        return False


def device_slice():
    """The device time-slice gate (a reentrant, TIMED context manager):
    lanes acquire it around each execution step — pipeline construction
    and per-batch pulls — so concurrent queries interleave device work at
    fragment/batch boundaries instead of contending mid-kernel.

    Telemetry: contended acquires observe
    `trino_tpu_device_gate_wait_seconds` and fold into the executing
    query's `gate_wait_s` (QueryStatistics, the query trace, and the
    archived profile); holds during which another lane waited observe
    `trino_tpu_device_gate_hold_seconds`; the holding lane is readable as
    the `trino_tpu_device_gate_occupied{lane}` pull gauge.  Uncontended
    (single lane / no dispatcher) a step costs one non-blocking RLock
    acquire + one clock read: noise."""
    return _DeviceSlice()


class QueryShedError(RuntimeError):
    """Resource-group queue full: the statement is shed (HTTP 429 with
    Retry-After) instead of queued — a RETRYABLE client error, the
    defined overload behavior."""

    error_code = "QUERY_QUEUE_FULL"
    retryable = True

    def __init__(self, group: str, retry_after_s: float):
        super().__init__(
            f"resource group {group} queue is full; retry after "
            f"{retry_after_s:.1f}s"
        )
        self.group = group
        self.retry_after_s = retry_after_s


class DispatcherStoppedError(RuntimeError):
    """The dispatcher is draining/stopped: queued statements fail
    classified instead of hanging."""

    error_code = "SERVER_SHUTTING_DOWN"

    def __init__(self, detail: str = "coordinator is shutting down"):
        super().__init__(detail)


# -- tickets -------------------------------------------------------------------

QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
DONE = "DONE"
CANCELED = "CANCELED"
EXPIRED = "EXPIRED"
STOPPED = "STOPPED"


class AdmissionTicket:
    """One statement's place in the admission queue.  All state
    transitions happen under the DISPATCHER's lock (the ticket itself has
    none); `wait()` blocks the statement thread until an engine lane is
    granted or the ticket resolves canceled/expired/stopped."""

    __slots__ = (
        "dispatcher", "group_name", "state", "event", "lane",
        "enqueued_at", "admitted_at", "deadline", "on_force_kill", "queued_s", "_observed",
    )

    def __init__(self, dispatcher: "QueryDispatcher", group_name: str,
                 deadline: Optional[float]):
        self.dispatcher = dispatcher
        self.group_name = group_name
        self.state = QUEUED
        self.event = threading.Event()
        self.lane = None
        self.enqueued_at = dispatcher._clock()
        self.admitted_at: Optional[float] = None
        self.deadline = deadline
        #: called by drain() on a still-running statement past the drain
        #: deadline (the coordinator wires the query's cancel here)
        self.on_force_kill: Optional[Callable[[], None]] = None
        self.queued_s = 0.0
        self._observed = False

    def wait(self):
        """Block until admitted; returns the granted engine lane.  Raises
        the classified outcome otherwise: QueryCanceledException
        (cancel-while-queued), QueryQueuedTimeExceeded
        (query_max_queued_time), DispatcherStoppedError (drain)."""
        from trino_tpu_torch.runtime.lifecycle import (
            QueryCanceledException,
            QueryQueuedTimeExceeded,
        )

        d = self.dispatcher
        while True:
            with d._lock:
                st = self.state
            if st in (ADMITTED, RUNNING):
                return self.lane
            if st == CANCELED:
                raise QueryCanceledException(
                    f"query canceled while queued in resource group "
                    f"{self.group_name}"
                )
            if st == EXPIRED:
                raise QueryQueuedTimeExceeded(
                    f"query exceeded query_max_queued_time in resource "
                    f"group {self.group_name} "
                    f"({(self.deadline or 0) - self.enqueued_at:.3f}s)"
                )
            if st == STOPPED:
                raise DispatcherStoppedError(
                    "query failed while queued: coordinator is shutting "
                    "down"
                )
            remaining = None
            if self.deadline is not None:
                remaining = self.deadline - d._clock()
                if remaining <= 0:
                    with d._lock:
                        if self.state == QUEUED:
                            self.state = EXPIRED
                            d._dequeue_locked(self)
                    continue
            self.event.wait(remaining)

    def cancel(self) -> None:
        """Queued-query cancel (DELETE /v1/query/{id} racing admission):
        a QUEUED ticket dequeues without ever acquiring a slot; a ticket
        that WON the admission race but has not started running hands its
        lane and group slot straight back — either way the statement
        never consumes engine time."""
        self.dispatcher._cancel_ticket(self)


class _Lane:
    """One engine lane: a runner the dispatcher grants to admitted
    statements, one at a time.  Lane 0 is the primary runner (the one
    system tables, prewarm, and membership live on); higher lanes are
    `clone_for_dispatch` clones sharing its catalogs/tracker/caches."""

    __slots__ = ("index", "runner", "busy")

    def __init__(self, index: int, runner):
        self.index = index
        self.runner = runner
        self.busy = False


class _GroupSched:
    """Dispatcher-side scheduling state for one resource group.  Mutated
    ONLY under the dispatcher lock; the group's `running` admission
    counter stays on the ResourceGroup (shared with the legacy blocking
    acquire() path, so both admission surfaces see one limit)."""

    __slots__ = ("group", "queue", "vtime", "shed_total", "queued_total")

    def __init__(self, group: ResourceGroup):
        self.group = group
        self.queue: deque = deque()
        self.vtime = 0.0
        self.shed_total = 0
        self.queued_total = 0


class QueryDispatcher:
    """See module docstring.  One per coordinator; the runner exposes it
    as `runner.dispatcher` so `system.runtime.resource_groups` can read
    live admission state over SQL."""

    def __init__(self, runner, groups: Optional[ResourceGroupManager] = None,
                 lanes: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        from trino_tpu_torch.config import get_config
        from trino_tpu_torch.telemetry.metrics import (
            queries_queued_gauge,
            queries_running_gauge,
            queries_shed_counter,
        )

        self.groups = groups or ResourceGroupManager()
        # prewarm replays admit through a dedicated weight-capped group
        # instead of holding an engine lock (prewarm is not ported: the
        # group stays idle, a row of system.runtime.resource_groups as in
        # the JAX package)
        self.groups.ensure(
            ResourceGroupConfig(
                SYSTEM_PREWARM_GROUP, hard_concurrency=1, max_queued=8,
                weight=1,
            )
        )
        self._clock = clock
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        cfg = get_config().dispatcher
        n = int(lanes) if lanes is not None else max(1, int(cfg.lanes))
        self._lanes = [_Lane(0, runner)]
        for i in range(1, n):
            clone = None
            maker = getattr(runner, "clone_for_dispatch", None)
            if maker is not None:
                clone = maker()
            if clone is None:
                break  # not cloneable (multi-host): single lane
            self._lanes.append(_Lane(i, clone))
        self._sched: dict[str, _GroupSched] = {}
        for name, g in self.groups.groups.items():
            self._sched[name] = _GroupSched(g)
            # a LEGACY ResourceGroup.release() (dbapi holders) must also
            # wake tickets queued in the dispatcher — both admission
            # surfaces share the slot counter, so both must schedule
            g.on_slot_freed = self._kick
            queries_queued_gauge().labels(name).set(0)
            queries_running_gauge().labels(name).set(0)
            queries_shed_counter().labels(name).inc(0)
        self._vtime = 0.0
        self._running: set = set()
        self._stopped = False
        #: immutable post-construction aliases for lock-free reads (the
        #: _lanes LIST itself is only walked under the dispatcher lock)
        self._primary = runner
        self._n_lanes = len(self._lanes)
        # group memory sub-pools attach to the shared pool root eagerly so
        # limits bind from the first admitted statement
        from trino_tpu_torch.runtime.lifecycle import memory_pool

        root = memory_pool().root
        for g in self.groups.groups.values():
            g.memory_context(root)

    @property
    def lanes(self) -> int:
        return self._n_lanes

    @property
    def runner(self):
        return self._primary

    # -- admission -------------------------------------------------------------

    def _group_for(self, user: Optional[str],
                   group_name: Optional[str]) -> _GroupSched:
        if group_name is not None:
            group = self.groups.groups[group_name]
        else:
            group = self.groups.select(user)
        with self._lock:
            gs = self._sched.get(group.config.name)
            if gs is None:  # a group added after construction (tests)
                gs = self._sched.setdefault(
                    group.config.name, _GroupSched(group)
                )
                group.on_slot_freed = self._kick
        return gs

    def _retry_after(self) -> float:
        from trino_tpu_torch.config import get_config

        return float(get_config().dispatcher.retry_after_s)

    def _kick(self) -> None:
        """Scheduling pass triggered from outside the dispatcher (a legacy
        ResourceGroup.release freeing a shared slot).  Reentrant-safe: the
        dispatcher's own release path may reach here while already holding
        the (R)lock."""
        with self._lock:
            self._schedule_locked()
            self._cv.notify_all()

    def _can_start_now_locked(  # lint: allow(unguarded-state)
            self, gs: _GroupSched) -> bool:
        """Caller holds self._lock."""
        if self._stopped or gs.queue:
            return False
        if not any(not l.busy for l in self._lanes):
            return False
        return gs.group.has_slot()

    def shed_probe(self, user: Optional[str] = None) -> Optional[float]:
        """The PRE-BODY overload check (HTTP 429 path): None = admit or
        queue normally; a float = shed, answer 429 with this Retry-After.
        Bumps the group's shed counter — a probe that sheds IS the shed
        event (the request body is never read, no ticket exists)."""
        gs = self._group_for(user, None)
        with self._lock:
            if self._stopped:
                return None  # submit path answers SERVER_SHUTTING_DOWN
            if len(gs.queue) < gs.group.config.max_queued:
                return None
            if self._can_start_now_locked(gs):
                return None
            return self._shed_locked(gs)

    def _shed_locked(self, gs: _GroupSched) -> float:
        from trino_tpu_torch.telemetry.metrics import queries_shed_counter

        gs.shed_total += 1
        queries_shed_counter().labels(gs.group.config.name).inc()
        return self._retry_after()

    def enqueue(self, user: Optional[str] = None,
                group_name: Optional[str] = None,
                queue_deadline_s: Optional[float] = None) -> AdmissionTicket:
        """Admit-or-queue one statement; returns its ticket (wait() blocks
        for the lane).  Raises QueryShedError when the group's queue is
        full and no slot is immediately free; DispatcherStoppedError when
        draining.  `queue_deadline_s` defaults to the primary runner's
        query_max_queued_time session property."""
        gs = self._group_for(user, group_name)
        group = gs.group
        if queue_deadline_s is None:
            try:
                queue_deadline_s = float(
                    self.runner.properties.get("query_max_queued_time")
                )
            except (AttributeError, KeyError):
                queue_deadline_s = 0.0
        deadline = (
            self._clock() + queue_deadline_s if queue_deadline_s > 0 else None
        )
        from trino_tpu_torch.telemetry.metrics import queries_queued_gauge

        with self._lock:
            if self._stopped:
                raise DispatcherStoppedError()
            if (
                len(gs.queue) >= group.config.max_queued
                and not self._can_start_now_locked(gs)
            ):
                raise QueryShedError(
                    group.config.name, self._shed_locked(gs)
                )
            t = AdmissionTicket(self, group.config.name, deadline)
            gs.queue.append(t)
            gs.queued_total += 1
            with group.lock:
                group.total_queued += 1
            queries_queued_gauge().labels(group.config.name).set(
                len(gs.queue)
            )
            self._schedule_locked()
        return t

    def _dequeue_locked(self, t: AdmissionTicket) -> None:  # lint: allow(unguarded-state)
        """Caller holds self._lock.  Remove a no-longer-QUEUED ticket from its group queue and
        publish its queue-wait (caller already moved t.state)."""
        from trino_tpu_torch.telemetry.metrics import queries_queued_gauge

        gs = self._sched[t.group_name]
        try:
            gs.queue.remove(t)
        except ValueError:
            pass
        queries_queued_gauge().labels(t.group_name).set(len(gs.queue))
        self._observe_queued_locked(t)
        t.event.set()
        self._schedule_locked()

    def _observe_queued_locked(self, t: AdmissionTicket) -> None:  # lint: allow(unguarded-state)
        """Caller holds self._lock."""
        from trino_tpu_torch.telemetry.metrics import query_queued_histogram

        if not t._observed:
            t._observed = True
            t.queued_s = max(0.0, self._clock() - t.enqueued_at)
            query_queued_histogram().observe(t.queued_s)

    def _cancel_ticket(self, t: AdmissionTicket) -> None:
        from trino_tpu_torch.telemetry.metrics import queries_running_gauge

        with self._lock:
            if t.state == QUEUED:
                t.state = CANCELED
                self._dequeue_locked(t)
                return
            if t.state == ADMITTED:
                # cancel WON the race against a concurrent grant: hand the
                # lane and group slot straight back — the statement never
                # ran, the slot wakes the next queued ticket
                t.state = CANCELED
                lane = t.lane
                if lane is not None:
                    lane.busy = False
                    t.lane = None
                self._running.discard(t)
                gs = self._sched[t.group_name]
                gs.group.release()
                queries_running_gauge().labels(t.group_name).set(
                    self._running_in_group(t.group_name)
                )
                t.event.set()
                self._schedule_locked()
                self._cv.notify_all()
            # RUNNING/terminal: the lifecycle token owns cancellation

    def _running_in_group(self, name: str) -> int:  # lint: allow(unguarded-state)
        """Caller holds self._lock."""
        return sum(1 for r in self._running if r.group_name == name)

    # -- weighted-fair scheduling ----------------------------------------------

    def _schedule_locked(self) -> None:  # lint: allow(unguarded-state)
        """Caller holds self._lock.  Grant free lanes to queued tickets, next eligible group by
        smallest weighted virtual time (WFQ): an admission charges the
        group 1/weight of virtual service, and a group going backlogged
        clamps to the global virtual clock so banked idle credit cannot
        starve the others."""
        from trino_tpu_torch.telemetry.metrics import (
            queries_queued_gauge,
            queries_running_gauge,
        )

        while not self._stopped:
            free = [l for l in self._lanes if not l.busy]
            if not free:
                return
            best = None
            for name, gs in sorted(self._sched.items()):
                if not gs.queue:
                    continue
                head = gs.queue[0]
                if not gs.group.has_slot():
                    continue
                if best is None or gs.vtime < best[0]:
                    best = (gs.vtime, name, gs, head)
            if best is None:
                return
            _, name, gs, t = best
            if not gs.group.try_acquire_now():
                continue  # raced a legacy acquire(); re-evaluate
            lane = free[-1]
            lane.busy = True
            t.lane = lane
            t.state = ADMITTED
            t.admitted_at = self._clock()
            gs.queue.popleft()
            self._running.add(t)
            # virtual-time bookkeeping: service starts at the later of the
            # group's own clock and the global clock (idle catch-up), and
            # costs 1/weight
            start = max(gs.vtime, self._vtime)
            gs.vtime = start + 1.0 / max(1, gs.group.config.weight)
            self._vtime = start
            queries_queued_gauge().labels(name).set(len(gs.queue))
            queries_running_gauge().labels(name).set(
                self._running_in_group(name)
            )
            self._observe_queued_locked(t)
            t.event.set()

    # -- execution -------------------------------------------------------------

    def run_admitted(self, ticket: AdmissionTicket, fn):
        """Run `fn(lane_runner)` on the ticket's granted lane, under the
        group's memory sub-pool and admission contextvars; releases the
        lane + slot and schedules the next ticket when done."""
        from trino_tpu_torch.runtime import lifecycle

        with self._lock:
            if ticket.state == CANCELED:
                # DELETE slipped between wait() returning and execution
                # starting: the cancel path already handed the slot back
                raise lifecycle.QueryCanceledException(
                    "query canceled before execution started"
                )
            if ticket.state != ADMITTED:
                raise RuntimeError(
                    f"ticket is {ticket.state}, not ADMITTED"
                )
            ticket.state = RUNNING
            lane = ticket.lane
            gs = self._sched[ticket.group_name]
        primary = self._primary
        group_mem = gs.group.memory_context(
            lifecycle.memory_pool().root
        )
        tok_mem = lifecycle.set_group_memory(group_mem)
        tok_adm = lifecycle.set_admission_info(
            (ticket.group_name, ticket.queued_s)
        )
        # lane identity for the device-gate occupancy gauge: the statement
        # thread's device_slice() passages report this lane as the holder
        tok_lane = lifecycle.set_lane(lane.index)
        session_before = getattr(primary, "session", None)
        if lane.runner is not primary and session_before is not None:
            # lanes inherit the primary's catalog/schema; a USE executed on
            # a lane publishes back (last writer wins, like the shared
            # pre-dispatcher runner)
            lane.runner.session = session_before
        try:
            return fn(lane.runner)
        finally:
            if (
                lane.runner is not primary
                and getattr(lane.runner, "session", None) is not session_before
            ):
                primary.session = lane.runner.session
            lifecycle.reset_lane(tok_lane)
            lifecycle.reset_admission_info(tok_adm)
            lifecycle.reset_group_memory(tok_mem)
            self.release(ticket)

    def release(self, ticket: AdmissionTicket) -> None:
        from trino_tpu_torch.telemetry.metrics import queries_running_gauge

        with self._lock:
            if ticket.state in (DONE, CANCELED):
                return  # already released (idempotent; cancel handed back)
            ticket.state = DONE
            lane = ticket.lane
            if lane is not None:
                lane.busy = False
                ticket.lane = None
            self._running.discard(ticket)
            gs = self._sched[ticket.group_name]
            gs.group.release()
            queries_running_gauge().labels(ticket.group_name).set(
                self._running_in_group(ticket.group_name)
            )
            self._schedule_locked()
            self._cv.notify_all()

    def system_admission(self):
        """Engine-internal admission for prewarm replays: prewarm is not
        ported, so there is nothing to admit."""
        raise NotImplementedError("system_admission (runtime/prewarm): not ported yet")

    # -- shutdown --------------------------------------------------------------

    def drain(self, wait_s: Optional[float] = None,
              grace_s: Optional[float] = None) -> bool:
        """Stop admission, fail queued statements classified, wait
        `wait_s` for running ones, force-kill stragglers through their
        lifecycle tokens, wait `grace_s` more.  Returns True when every
        lane is idle at exit (a clean drain)."""
        from trino_tpu_torch.config import get_config
        from trino_tpu_torch.telemetry.metrics import queries_queued_gauge

        cfg = get_config().dispatcher
        wait_s = cfg.drain_wait_s if wait_s is None else wait_s
        grace_s = cfg.drain_grace_s if grace_s is None else grace_s
        with self._lock:
            self._stopped = True
            for name, gs in self._sched.items():
                while gs.queue:
                    t = gs.queue.popleft()
                    t.state = STOPPED
                    self._observe_queued_locked(t)
                    t.event.set()
                queries_queued_gauge().labels(name).set(0)
        self._wait_idle(self._clock() + wait_s)
        with self._lock:
            leftovers = list(self._running)
        if leftovers:
            from trino_tpu_torch.telemetry.metrics import (
                drain_force_kills_counter,
            )

            for t in leftovers:
                cb = t.on_force_kill
                if cb is not None:
                    drain_force_kills_counter().inc()
                    try:
                        cb()
                    except Exception:
                        pass
            self._wait_idle(self._clock() + grace_s)
        with self._lock:
            return not self._running

    def _wait_idle(self, deadline: float) -> None:
        with self._lock:
            while self._running:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return
                # the condition shares self._lock, so wait() releases it
                self._cv.wait(timeout=min(remaining, 0.25))

    # -- observability ---------------------------------------------------------

    def stats(self) -> list:
        """Per-group admission state (system.runtime.resource_groups)."""
        with self._lock:
            out = []
            for name, gs in sorted(self._sched.items()):
                s = gs.group.stats()
                s["queued"] = len(gs.queue)
                s["running"] = self._running_in_group(name)
                s["shed_total"] = gs.shed_total
                s["dispatcher_queued_total"] = gs.queued_total
                out.append(s)
            return out

    def retry_after_hint(self) -> int:
        return max(1, int(math.ceil(self._retry_after())))


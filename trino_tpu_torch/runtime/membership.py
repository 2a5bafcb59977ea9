"""Elastic cluster membership: heartbeat failure detection, drain, grow.

Reference roles: failuredetector/HeartbeatFailureDetector.java:78 (the
coordinator pings workers; consecutive silence marks them failed),
server/GracefulShutdownHandler.java (SURVEY §5.3: drain running tasks,
refuse new ones, then exit), and DiscoveryNodeManager (workers announce
themselves; the scheduler consults the live set per query).

The query lifecycle makes individual queries stoppable; this module makes the CLUSTER
mutable:

  * `ClusterMembership` — the coordinator's worker registry.  Every worker
    is ACTIVE, DRAINING, or DEAD; `active_workers()` is the set the NEXT
    query's mesh is planned against (a membership change never mutates a
    running query's mesh — the running query re-plans or completes).
    Transitions bump `trino_tpu_membership_events_total{kind}` and the
    per-worker `trino_tpu_worker_alive` gauge, and the registry feeds
    `system.runtime.nodes`.
  * `HeartbeatDetector` — periodic worker probes with an injectable clock
    and prober.  Consecutive misses past `heartbeat.miss-threshold` declare
    the worker DEAD and trip its circuit breaker; a DEAD worker stays
    DEAD until it explicitly re-registers (the grow path), so a flapping
    worker can never oscillate ACTIVE<->DEAD inside one probe window.
  * `MeshChangedError` — raised by the multi-host scheduler when a worker
    in the CURRENT query's mesh is discovered dead (connection refused) or
    draining (503 REFUSED semantics): the runner marks membership, then
    re-plans the query's remaining fragments against the SHRUNK worker set
    (W-1) instead of retrying forever against a corpse.  Spooled/pull
    exchanges make the replay deterministic.

Everything time-related is injectable so the detector state machine runs in
tier-1 on a deterministic clock with zero sleeps.

Port of trino_tpu/runtime/membership.py: a copy, with the package renamed;
`invalidate_mesh_scans` drops the port's device scan-cache entries
(runtime/buffer_pool.POOL), which live on the mesh runner's card.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

# -- worker states -------------------------------------------------------------

ACTIVE = "ACTIVE"
DRAINING = "DRAINING"
DEAD = "DEAD"


class MeshChangedError(RuntimeError):
    """The executing query's worker set changed under it (death or drain):
    re-plan the remaining fragments against the new set.  Deliberately NOT
    a ConnectionError: retry machinery must never absorb a mesh change."""

    def __init__(self, dead=(), drained=()):
        self.dead = tuple(dead)
        self.drained = tuple(drained)
        super().__init__(
            f"mesh changed: dead={list(self.dead)} drained={list(self.drained)}"
        )


class WorkerDrainingError(ConnectionRefusedError):
    """A draining worker refused a task submission (HTTP 503).  Subclasses
    ConnectionRefusedError ON PURPOSE: the retry logic already treats
    REFUSED as 'do not retry this worker' — drain refusals ride the same
    classification, they just must not feed the breaker (the worker is
    healthy, it is leaving)."""


@dataclass
class WorkerEntry:
    worker_id: str
    state: str = ACTIVE
    #: clock() of the last successful heartbeat/probe
    last_heartbeat: float = 0.0
    #: consecutive failed probes (reset by any success while not DEAD)
    misses: int = 0
    registered_at: float = 0.0


class ClusterMembership:
    """Coordinator-side worker registry (DiscoveryNodeManager role).

    State machine per worker:

        (register) -> ACTIVE -(drain)-> DRAINING -(exit/miss)-> DEAD
                        |                                        ^
                        +------------- (misses >= threshold) ----+
        DEAD -(register again)-> ACTIVE   ("rejoin": the grow path)

    DEAD is sticky: only an explicit `register` resurrects a worker, so
    probe flaps cannot oscillate the state inside a probe window."""

    def __init__(self, worker_ids=(), clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerEntry] = {}
        for w in worker_ids:
            self.register(w)

    # -- transitions ----------------------------------------------------------

    def register(self, worker_id: str) -> WorkerEntry:
        """A worker announces itself: new workers join, DEAD or DRAINING
        workers rejoin (registration is an explicit grow intent — a
        drained-for-maintenance worker that restarts must be able to come
        back).  Either way it serves the NEXT query's mesh, never a
        running one (schedulers snapshot active_workers per query)."""
        now = self.clock()
        with self._lock:
            e = self._workers.get(worker_id)
            if e is None:
                e = WorkerEntry(worker_id, ACTIVE, now, 0, now)
                self._workers[worker_id] = e
                kind = "join"
            elif e.state in (DEAD, DRAINING):
                e.state = ACTIVE
                e.misses = 0
                e.last_heartbeat = now
                kind = "rejoin"
            else:
                e.last_heartbeat = now
                return e  # already a member: a no-op announce
        self._event(kind)
        self._set_alive(worker_id, 1)
        if kind == "rejoin":
            # fresh start for its breaker too: failure history belongs to
            # the dead incarnation
            from trino_tpu_torch.runtime.retry import BREAKERS

            BREAKERS.get(worker_id).record_success()
        return e

    def drain(self, worker_id: str) -> bool:
        """Mark a worker DRAINING: it finishes running tasks and refuses
        new ones; the next query's mesh excludes it."""
        with self._lock:
            e = self._workers.get(worker_id)
            if e is None or e.state != ACTIVE:
                return False
            e.state = DRAINING
        self._event("drain")
        return True

    def mark_dead(self, worker_id: str, trip_breaker: bool = True) -> bool:
        """Declare a worker DEAD (detector threshold or scheduler evidence);
        trips its circuit breaker OPEN so nothing routes to the corpse —
        EXCEPT when the worker was DRAINING: its exit is the drain
        completing by choice, recorded as death without a breaker trip (the
        breaker narrates failures, not retirements)."""
        with self._lock:
            e = self._workers.get(worker_id)
            if e is None:
                e = WorkerEntry(worker_id, DEAD, 0.0, 0, self.clock())
                self._workers[worker_id] = e
            elif e.state == DEAD:
                return False
            else:
                if e.state == DRAINING:
                    trip_breaker = False
                e.state = DEAD
        self._event("death")
        self._set_alive(worker_id, 0)
        if trip_breaker:
            from trino_tpu_torch.runtime.retry import BREAKERS

            BREAKERS.get(worker_id).trip()
        return True

    def heartbeat(self, worker_id: str) -> None:
        """A successful probe/announce.  DEAD stays DEAD (sticky — see the
        class doc); live workers reset their miss count."""
        with self._lock:
            e = self._workers.get(worker_id)
            if e is None or e.state == DEAD:
                return
            e.last_heartbeat = self.clock()
            e.misses = 0

    def forget(self, worker_id: str) -> None:
        """Remove a worker from the registry entirely (a mesh SHRINK drops
        it by intent — a stale entry must not time out later and fail
        liveness checks that no longer concern it).  Unlike death this is
        not a failure event: no breaker trip, no death metric — only the
        liveness gauge drops."""
        with self._lock:
            if self._workers.pop(worker_id, None) is None:
                return
        self._set_alive(worker_id, 0)

    def miss(self, worker_id: str) -> int:
        """A failed probe; returns the consecutive-miss count."""
        with self._lock:
            e = self._workers.get(worker_id)
            if e is None or e.state == DEAD:
                return 0
            e.misses += 1
            return e.misses

    # -- views ----------------------------------------------------------------

    def get(self, worker_id: str) -> Optional[WorkerEntry]:
        with self._lock:
            return self._workers.get(worker_id)

    def state(self, worker_id: str) -> Optional[str]:
        e = self.get(worker_id)
        return None if e is None else e.state

    def active_workers(self) -> list:
        """Workers the next query's mesh may schedule on (ACTIVE only:
        DRAINING workers refuse new tasks, DEAD ones are gone).  Insertion
        order — stable task placement across queries."""
        with self._lock:
            return [w for w, e in self._workers.items() if e.state == ACTIVE]

    def probe_targets(self) -> list:
        """Workers the detector should ping (everything not DEAD)."""
        with self._lock:
            return [w for w, e in self._workers.items() if e.state != DEAD]

    def entries(self) -> list:
        """Point-in-time (worker_id, state, last_heartbeat) triples.  The
        list is built UNDER the lock, so callers iterate a stable snapshot
        — the fte detector's old dict.copy() refresh-race fix, subsumed by
        the registry lock (a concurrent heartbeat/register can never
        resize the dict mid-iteration here)."""
        with self._lock:
            return [
                (w, e.state, e.last_heartbeat)
                for w, e in self._workers.items()
            ]

    def snapshot(self) -> list:
        """system.runtime.nodes feed: (worker id, state, seconds since the
        last heartbeat, breaker state) per worker."""
        from trino_tpu_torch.runtime.retry import BREAKER_CLOSED, BREAKERS

        breakers = BREAKERS.states()
        now = self.clock()
        with self._lock:
            return [
                (
                    w,
                    e.state,
                    (
                        round(now - e.last_heartbeat, 3)
                        if e.last_heartbeat
                        else None
                    ),
                    breakers.get(w, BREAKER_CLOSED),
                )
                for w, e in self._workers.items()
            ]

    # -- telemetry ------------------------------------------------------------

    @staticmethod
    def _event(kind: str) -> None:
        from trino_tpu_torch.telemetry.metrics import membership_events_counter

        membership_events_counter().labels(kind).inc()

    @staticmethod
    def _set_alive(worker_id: str, v: int) -> None:
        from trino_tpu_torch.telemetry.metrics import worker_alive_gauge

        worker_alive_gauge().labels(worker_id).set(v)


# -- heartbeat failure detection -----------------------------------------------


def http_probe(worker_url: str, timeout_s: float = 5.0) -> bool:
    """Default prober: does GET /v1/info answer?  DELIBERATELY laxer than
    the scheduler's `_StageScheduler._probe` (which only counts
    REFUSED/RESET, because it acts on one probe): the detector may count a
    timeout as a miss too, since declaring death takes miss-threshold
    CONSECUTIVE misses — an answering-but-slow worker misses once, then
    answers."""
    import urllib.request

    try:
        with urllib.request.urlopen(
            f"{worker_url}/v1/info", timeout=timeout_s
        ) as r:
            r.read()
        return True
    except Exception:
        return False


class HeartbeatDetector:
    """Coordinator-side failure detector over a ClusterMembership
    (HeartbeatFailureDetector role, with the breaker registry as the
    consumer).  `tick()` runs one probe round — deterministic for tests;
    `start()` runs rounds on a background thread at the configured
    interval (injectable sleep).

    Per round, per non-DEAD worker: a successful probe heartbeats the
    membership (never the breaker — an info answer is process liveness,
    not task-tier health); a failure counts a consecutive miss and votes
    failure on the breaker; `miss-threshold` consecutive misses declare
    the worker DEAD (membership trips the breaker OPEN).
    State is only evaluated at round boundaries, and DEAD is sticky, so a
    flapping worker cannot oscillate inside one probe window."""

    def __init__(
        self,
        membership: ClusterMembership,
        prober: Optional[Callable[[str], bool]] = None,
        config=None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        from trino_tpu_torch.config import get_config

        self.membership = membership
        self._get_config = (lambda: config) if config is not None else (
            lambda: get_config().heartbeat
        )
        self.prober = prober or (
            lambda w: http_probe(w, self._get_config().probe_timeout_s)
        )
        self._sleep = sleep
        #: guards the start()/stop() check-then-act on _stop/_thread — a
        #: double start() racing itself must never leak a second probe loop
        self._loop_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: probe rounds completed (test/telemetry evidence)
        self.rounds = 0

    # ui.py compatibility: the coordinator dashboard asks the detector for
    # the live worker list
    def active_workers(self) -> list:
        return self.membership.active_workers()

    def tick(self) -> list:
        """One probe round; returns the workers declared DEAD this round.

        Probe FAILURES vote on the worker's breaker (real negative
        evidence); probe SUCCESSES only heartbeat the membership — a
        /v1/info answer proves process liveness, not task-tier health, so
        it must never close an OPEN breaker and short-circuit the cooldown
        real request failures earned."""
        from trino_tpu_torch.runtime.retry import BREAKERS

        cfg = self._get_config()
        died = []
        for w in self.membership.probe_targets():
            ok = False
            try:
                ok = bool(self.prober(w))
            except Exception:
                ok = False
            if ok:
                self.membership.heartbeat(w)
            else:
                misses = self.membership.miss(w)
                if self.membership.state(w) != DRAINING:
                    # a DRAINING worker going silent is its drain
                    # completing by choice — no breaker vote (the trip
                    # would outrun mark_dead's own retirement carve-out)
                    BREAKERS.get(w).record_failure()
                if misses >= cfg.miss_threshold:
                    if self.membership.mark_dead(w):
                        died.append(w)
        self.rounds += 1
        return died

    def start(self, interval_s: Optional[float] = None) -> "HeartbeatDetector":
        """Background probe loop (daemon thread).  Idempotent AND atomic:
        two concurrent start() calls (e.g. two embedded servers adopting
        one runner) race on the _thread check — the loop lock makes the
        check-then-spawn a single step, so exactly one loop ever runs."""
        with self._loop_lock:
            if self._thread is not None:
                return self
            # each loop owns ITS stop event: a stopped loop's event stays
            # set forever, so a stop()/start() cycle can never leak a
            # second live loop racing the new one (the old thread may still
            # be inside its sleep when the new one starts)
            stop = threading.Event()
            self._stop = stop

            def loop():
                while not stop.is_set():
                    self.tick()
                    self._sleep(
                        interval_s
                        if interval_s is not None
                        else self._get_config().interval_s
                    )

            self._thread = threading.Thread(
                target=loop, daemon=True, name="heartbeat-detector"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._loop_lock:
            self._stop.set()
            self._thread = None


class HeartbeatFailureDetector:
    """Timeout-based liveness facade over a ``ClusterMembership`` — THE
    heartbeat failure detector (reference:
    failuredetector/HeartbeatFailureDetector.java:78, ping():350).

    This unifies the duplicate detector ``runtime/fte.py`` used to carry:
    the in-process mesh runner's timeout-based API (register / heartbeat /
    failed_workers / active_workers) is preserved, but the state now lives
    in the membership registry, so the mesh runner inherits sticky death,
    breaker integration (``mark_dead`` trips the worker's breaker OPEN),
    and the lock-guarded snapshot iteration that subsumed the old
    ``dict.copy()`` refresh-race fix (see ``ClusterMembership.entries``).

    Semantics preserved from the old detector:

      * a worker silent past ``timeout_s`` fails liveness checks,
      * a fresh ``heartbeat`` from a failed worker RECOVERS it — mapped to
        ``register`` (a worker-originated announce is the explicit rejoin
        intent sticky death requires; a mere probe success still cannot
        resurrect a DEAD worker, because probes route through
        ``ClusterMembership.heartbeat`` which keeps DEAD sticky),
      * ``unregister`` forgets a worker entirely (mesh shrink by intent).
    """

    def __init__(
        self,
        timeout_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        membership: Optional[ClusterMembership] = None,
    ):
        self.timeout_s = timeout_s
        # an explicitly provided membership keeps ITS clock; otherwise the
        # facade's clock argument seeds the registry it creates
        self.membership = (
            membership if membership is not None
            else ClusterMembership(clock=clock)
        )

    # the detector and its registry share ONE time source (the old
    # detector's semantics): overriding `detector.clock` must move the
    # heartbeat timestamps too, or a test-shifted clock would mark every
    # worker stale the instant it heartbeats
    @property
    def clock(self) -> Callable[[], float]:
        return self.membership.clock

    @clock.setter
    def clock(self, fn: Callable[[], float]) -> None:
        self.membership.clock = fn

    def register(self, worker: str) -> None:
        self.membership.register(worker)

    def unregister(self, worker: str) -> None:
        self.membership.forget(worker)

    def heartbeat(self, worker: str) -> None:
        # a worker-originated announce: refreshes a live worker, rejoins a
        # DEAD one (registration is the explicit resurrection intent)
        self.membership.register(worker)

    def refresh(self) -> None:
        """Mark every worker silent past the timeout DEAD (sticky; trips
        its breaker).  Iterates a lock-built snapshot — see entries()."""
        now = self.clock()
        for w, state, last in self.membership.entries():
            if state != DEAD and now - last > self.timeout_s:
                self.membership.mark_dead(w)

    def failed_workers(self) -> set:
        self.refresh()
        return {
            w for w, state, _ in self.membership.entries() if state == DEAD
        }

    def active_workers(self) -> list:
        self.refresh()
        return sorted(
            w for w, state, _ in self.membership.entries() if state == ACTIVE
        )

    def is_alive(self, worker: str) -> bool:
        self.refresh()
        return self.membership.state(worker) in (ACTIVE, DRAINING)


# -- mesh-signature cache invalidation -----------------------------------------


def invalidate_mesh_scans(mesh_sig=None) -> int:
    """Drop device-resident stacked-scan cache entries for a mesh signature
    (all mesh signatures when None).  A query re-planned at a different W
    shards scans differently — entries keyed by the OLD signature are dead
    weight holding device memory, and must never alias the new mesh's keys.  Returns
    the number of entries dropped."""
    from trino_tpu_torch.runtime.buffer_pool import POOL

    def stale(key) -> bool:
        if not (isinstance(key, tuple) and key and key[0] == "mesh_scan"):
            return False
        return mesh_sig is None or (len(key) > 1 and key[1] == mesh_sig)

    return POOL.invalidate_device(stale)

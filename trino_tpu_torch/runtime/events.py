"""Query event pipeline (reference: event/QueryMonitor.java ->
eventlistener/EventListenerManager.java -> spi eventlistener plugins).

Listeners receive QueryCreatedEvent / QueryCompletedEvent; failures carry the
error string plus an error TYPE classification (USER_ERROR | INTERNAL_ERROR;
reference role: spi ErrorCode/ErrorType), and completions carry a
QueryStatistics payload (wall, phase totals, counters, peak memory — what
EXPLAIN ANALYZE sees, reference: spi eventlistener QueryStatistics).  The
bundled FileEventListener mirrors trino-http-event-listener's role as the
simplest sink.

Port of trino_tpu/runtime/events.py: a copy, with the package renamed.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("trino_tpu_torch.events")

#: error-type vocabulary (reference: spi ErrorType — the subset the engine
#: distinguishes; external classes fold into INTERNAL here)
USER_ERROR = "USER_ERROR"
INTERNAL_ERROR = "INTERNAL_ERROR"
#: deadline / memory-kill / admission aborts (reference: INSUFFICIENT_
#: RESOURCES — the class a serving stack pages on differently from bugs)
RESOURCE_ERROR = "RESOURCE_ERROR"


def classify_error(exc: BaseException) -> str:
    """Exception -> error type.  Lifecycle aborts classify first (a user
    cancel is the user's, a deadline/memory kill is a resource verdict —
    both are RuntimeErrors, so they must not fall through to INTERNAL).
    Parse/analysis/semantic errors (the engine raises them as ValueError
    subclasses — ParseError, AnalysisError — plus KeyError for missing
    objects and NotImplementedError for unsupported SQL) are the user's;
    everything else is the engine's."""
    from trino_tpu_torch.runtime.lifecycle import (
        QueryAbortedException,
        QueryCanceledException,
    )
    from trino_tpu_torch.runtime.memory import ExceededMemoryLimitException

    if isinstance(exc, QueryCanceledException):
        return USER_ERROR
    if isinstance(exc, (QueryAbortedException, ExceededMemoryLimitException)):
        return RESOURCE_ERROR
    if isinstance(exc, (ValueError, KeyError, NotImplementedError)):
        return USER_ERROR
    return INTERNAL_ERROR


@dataclass
class QueryStatistics:
    """Per-query execution statistics delivered with QueryCompletedEvent
    (reference: spi eventlistener QueryStatistics — listeners see what
    EXPLAIN ANALYZE sees, machine-readable)."""

    wall_s: float = 0.0
    rows: int = 0
    #: per-phase seconds summed over distributed fragments (empty for
    #: purely local executions)
    phase_totals_s: dict = field(default_factory=dict)
    #: MeshProfile counters of the execution (empty when local)
    counters: dict = field(default_factory=dict)
    #: trace-cache hits/misses/retraces attributed to this query
    trace_cache: dict = field(default_factory=dict)
    peak_memory_bytes: int = 0
    #: spans recorded by the query tracer (0 when tracing is off)
    spans: int = 0
    #: seconds the statement waited on the device time-slice gate
    #: (runtime/dispatcher device_slice; contended acquires only)
    gate_wait_s: float = 0.0
    #: resource group the statement was admitted through + its queue wait
    #: (empty/0 for undispatched executions)
    group: str = ""
    queued_s: float = 0.0
    #: archived profile-artifact key (telemetry/profile_store; empty when
    #: no store is attached)
    profile_key: str = ""


@dataclass
class QueryCreatedEvent:
    query_id: str
    sql: str
    create_time: float


@dataclass
class QueryCompletedEvent:
    query_id: str
    sql: str
    state: str  # FINISHED | FAILED | CANCELED
    create_time: float
    end_time: float
    rows: int = 0
    error: Optional[str] = None
    #: USER_ERROR | INTERNAL_ERROR | RESOURCE_ERROR when not FINISHED
    error_type: Optional[str] = None
    #: lifecycle kill reason when the query was aborted (USER_CANCELED |
    #: EXCEEDED_TIME_LIMIT | CLUSTER_OUT_OF_MEMORY; reference: ErrorCode
    #: name) — the `system.runtime.queries` kill-reason column
    error_code: Optional[str] = None
    statistics: Optional[QueryStatistics] = None

    @property
    def wall_s(self) -> float:
        return self.end_time - self.create_time


class EventListener:
    def query_created(self, event: QueryCreatedEvent) -> None:  # pragma: no cover
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:  # pragma: no cover
        pass


class EventListenerManager:
    def __init__(self):
        self.listeners: list[EventListener] = []
        #: (listener class name, event kind) pairs already warned about —
        #: a broken audit sink logs ONE rate-limited warning per listener
        #: class per event type instead of failing silently forever
        self._warned: set = set()

    def add(self, listener: EventListener) -> None:
        self.listeners.append(listener)

    def _deliver(self, method: str, event) -> None:
        for l in self.listeners:
            try:
                getattr(l, method)(event)
            except Exception:
                # listeners must not break queries, but a dead sink must be
                # VISIBLE: warn once per (listener class, event type)
                key = (type(l).__name__, method)
                if key not in self._warned:
                    self._warned.add(key)
                    log.warning(
                        "event listener %s failed handling %s (suppressing "
                        "further warnings for this listener/event pair)",
                        type(l).__name__,
                        method,
                        exc_info=True,
                    )

    def query_created(self, event: QueryCreatedEvent) -> None:
        self._deliver("query_created", event)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        self._deliver("query_completed", event)


class FileEventListener(EventListener):
    """Append query events as JSON lines (reference role: the
    http/kafka event-listener plugins' sink, file-backed — the shape an
    external audit pipeline ingests)."""

    def __init__(self, path: str):
        self.path = path
        # surface unwritable paths at STARTUP — the manager swallows
        # per-event listener errors, so a bad path would otherwise drop the
        # whole audit trail silently
        with open(path, "a", encoding="utf-8"):
            pass

    def _write(self, doc: dict) -> None:
        import json

        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(doc) + "\n")

    def query_created(self, e: QueryCreatedEvent) -> None:
        self._write(
            {
                "event": "query_created",
                "query_id": e.query_id,
                "sql": e.sql,
                "create_time": e.create_time,
            }
        )

    def query_completed(self, e: QueryCompletedEvent) -> None:
        self._write(
            {
                "event": "query_completed",
                "query_id": e.query_id,
                "state": e.state,
                "wall_s": e.wall_s,
                "rows": e.rows,
                "error": e.error,
                "error_type": e.error_type,
                "error_code": e.error_code,
            }
        )


class CollectingEventListener(EventListener):
    """Test fixture (reference: testing EventsCollector)."""

    def __init__(self):
        self.created: list[QueryCreatedEvent] = []
        self.completed: list[QueryCompletedEvent] = []

    def query_created(self, e):
        self.created.append(e)

    def query_completed(self, e):
        self.completed.append(e)

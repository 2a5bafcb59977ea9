"""Structured JSONL query audit log.

Port of trino_tpu/telemetry/audit.py, copied with the package renamed.
Reference roles: the http/kafka event-listener plugins' durable sink plus
airlift's size-rotated log management (io.airlift.log) — the
machine-readable per-query trail an external audit/billing pipeline tails.
One line per `QueryCompletedEvent`, written through the filesystem SPI
(`audit.log-path`) with size-based rotation (`audit.rotate-bytes` /
`audit.rotate-keep`): `<path>` is always the live segment, `<path>.1` the
most recent rotated one.

Each line carries what an SRE pages on and what a billing pipeline meters:
query id, terminal state + error code classification, resource group, wall
seconds, device-gate wait, peak memory, row count, and the counter
snapshot of the execution (the QueryStatistics payload) — the same facts
`system.runtime.queries` shows, but durable and append-only.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Optional

from trino_tpu_torch.filesystem import filesystem_for, strip_scheme
from trino_tpu_torch.runtime.events import EventListener

log = logging.getLogger("trino_tpu_torch.audit")

#: process-wide monotonic audit sequence: every appended line carries the
#: next value, so external tails detect gaps (a dropped line is visible)
#: and the decision ledger cross-references in-flight decisions against
#: shed/kill/drain events by (query_id, seq) — a decision whose
#: `audit_seq` watermark is below a kill line's seq was made BEFORE the
#: kill landed
_seq_lock = threading.Lock()
_seq = 0


def _next_sequence() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def sequence_watermark() -> int:
    """Highest audit sequence issued so far (0 before any line)."""
    with _seq_lock:
        return _seq


class QueryAuditLog(EventListener):
    """JSONL sink for query completions (see module doc).  Thread-safe:
    concurrent engine lanes deliver completions from their own statement
    threads, so append+rotate serialize under one lock.  Failures are the
    event manager's problem (it warns once per listener/event pair) —
    a dead audit disk never breaks queries."""

    def __init__(self, path: str, rotate_bytes: int = 64 * 1024 * 1024,
                 rotate_keep: int = 2, clock=time.time):
        self.path = strip_scheme(path)
        self.fs = filesystem_for(path)
        self.rotate_bytes = int(rotate_bytes)
        self.rotate_keep = max(1, int(rotate_keep))
        self.clock = clock
        self._lock = threading.Lock()
        # surface unwritable locations at STARTUP, not at first completion
        # (the manager swallows per-event errors)
        self.fs.append(self.path, b"")

    @classmethod
    def from_config(cls, cfg=None) -> "Optional[QueryAuditLog]":
        """Listener wired from the typed config's `audit.*` section
        (None when `audit.log-path` is unset)."""
        if cfg is None:
            from trino_tpu_torch.config import get_config

            cfg = get_config()
        if not cfg.audit.log_path:
            return None
        return cls(
            cfg.audit.log_path,
            rotate_bytes=cfg.audit.rotate_bytes,
            rotate_keep=cfg.audit.rotate_keep,
        )

    # -- event sink -----------------------------------------------------------

    def query_completed(self, e) -> None:
        from trino_tpu_torch.telemetry.metrics import audit_events_counter

        stats = getattr(e, "statistics", None)
        doc = {
            "seq": _next_sequence(),
            "ts": self.clock(),
            "query_id": e.query_id,
            "state": e.state,
            "error_code": e.error_code,
            "error_type": e.error_type,
            "group": getattr(stats, "group", None),
            "queued_s": getattr(stats, "queued_s", 0.0),
            "wall_s": round(e.wall_s, 6),
            "gate_wait_s": getattr(stats, "gate_wait_s", 0.0),
            "peak_memory_bytes": getattr(stats, "peak_memory_bytes", 0),
            "rows": e.rows,
            "counters": dict(getattr(stats, "counters", None) or {}),
        }
        line = (json.dumps(doc, sort_keys=True) + "\n").encode()
        with self._lock:
            size = self.fs.size(self.path)
            if (
                self.rotate_bytes > 0
                and size > 0
                and size + len(line) > self.rotate_bytes
            ):
                self._rotate_locked()
            self.fs.append(self.path, line)
        audit_events_counter().inc()

    def _rotate_locked(self) -> None:  # lint: allow(unguarded-state)
        """Caller holds self._lock.  Shift segments newest-first through
        the SPI rename primitive (O(1) locally via os.replace; an
        object-store implementation pays its copy there, not here):
        <path> -> <path>.1, <path>.1 -> <path>.2, ...; the oldest falls
        off at rotate_keep."""
        from trino_tpu_torch.telemetry.metrics import audit_rotations_counter

        for i in range(self.rotate_keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if self.fs.exists(src):
                self.fs.rename(src, f"{self.path}.{i + 1}")
        self.fs.rename(self.path, f"{self.path}.1")
        # drop any segment beyond the keep budget
        drop = f"{self.path}.{self.rotate_keep + 1}"
        if self.fs.exists(drop):
            self.fs.delete(drop)
        audit_rotations_counter().inc()


def attach_audit_log(runner, listener: Optional[QueryAuditLog] = None):
    """Attach the audit listener to a runner's event pipeline (idempotent;
    config-driven when no listener is passed — a no-op returning None
    without `audit.log-path`)."""
    if listener is None:
        listener = QueryAuditLog.from_config()
        if listener is None:
            return None
    if any(isinstance(l, QueryAuditLog) for l in runner.events.listeners):
        return next(
            l for l in runner.events.listeners
            if isinstance(l, QueryAuditLog)
        )
    runner.events.add(listener)
    return listener

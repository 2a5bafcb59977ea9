"""System connector: engine state queryable as SQL tables.

Reference: core/trino-main/.../connector/system/ (QuerySystemTable.java,
NodeSystemTable, system.runtime schema) — the observability surface that
makes the engine inspectable from its own SQL prompt.

Tables (schema `runtime`):
  queries          — query history from the event pipeline (wall, state,
                     rows, error + error_type classification)
  spans            — flattened span trees of recently traced queries
                     (query_trace session property; telemetry/spans)
  compilations     — recent compile events: step-cache builds and kernel
                     builds/loads (step, bucket, mesh, wall seconds;
                     telemetry/compile_events ring)
  metrics          — the process metrics registry (telemetry/metrics)
  query_profiles   — the persistent per-query profile archive's memory
                     ring (telemetry/profile_store; wall, gate wait,
                     compile seconds, archived artifact path)
  plan_decisions   — per-query plan-decision ledgers of recently archived
                     statements (telemetry/decisions; choice, rejected
                     alternative, measured bytes, hindsight verdict)
  nodes            — mesh workers and their liveness
  session_properties — property values in effect
  caches           — buffer-pool tiers (bytes, hits, misses)

Schema `metrics` re-exposes the registry as `system.metrics.metrics` (the
Prometheus surface's SQL twin).

Port of trino_tpu/connectors/system.py.  `nodes` lists the cluster
membership's workers (runtime/membership: a multi-host runner's registry,
or the mesh runner's heartbeat detector over `worker-0..W-1`) with their
state, heartbeat age and breaker state; a runner with neither lists its
device (one row per CUDA device when it runs on the card, one `cpu` row
otherwise; the JAX package lists its XLA devices by id).  The prewarm
column is the attached prewarm executor's state (runtime/prewarm), NULL
without one.  (The JAX mesh runner's
`nodes` raises AttributeError: it reads a detector field that its
membership-backed detector no longer has.)  `query_profiles` and `plan_decisions` read
the profile store attached to the runner (`profile.archive-dir`, or
`attach_profile_store`) and give no rows without one.
"""

from __future__ import annotations

import threading

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.connectors.api import (
    ColumnData,
    ColumnMeta,
    Connector,
    ConnectorMetadata,
    PageSource,
    Split,
    TableHandle,
    TableMetadata,
    TableStatistics,
)
from trino_tpu_torch.runtime.events import EventListener


class QueryHistory(EventListener):
    """Bounded in-memory query log fed by the event pipeline."""

    def __init__(self, limit: int = 1000):
        self.limit = limit
        self.entries: list[dict] = []
        self._running: dict[str, dict] = {}
        #: dispatcher lanes deliver events from several threads
        self._lock = threading.Lock()

    def query_created(self, e):
        row = {
            "query_id": e.query_id,
            "state": "RUNNING",
            "query": e.sql,
            "create_time": e.create_time,
            "end_time": None,
            "wall_s": None,
            "rows": None,
            "error": None,
            "error_type": None,
            "error_code": None,
        }
        with self._lock:
            self._running[e.query_id] = row
            self.entries.append(row)
            if len(self.entries) > self.limit:
                self.entries = self.entries[-self.limit :]

    def query_completed(self, e):
        with self._lock:
            row = self._running.pop(e.query_id, None)
        if row is None:
            return
        row["state"] = e.state
        row["end_time"] = e.end_time
        row["rows"] = e.rows
        row["error"] = e.error
        row["error_type"] = getattr(e, "error_type", None)
        # lifecycle kill reason (USER_CANCELED | EXCEEDED_TIME_LIMIT |
        # CLUSTER_OUT_OF_MEMORY) — why a query stopped, not just that it did
        row["error_code"] = getattr(e, "error_code", None)
        row["wall_s"] = e.wall_s


_TABLES = {
    "queries": [
        ("query_id", T.VARCHAR),
        ("state", T.VARCHAR),
        ("query", T.VARCHAR),
        ("create_time", T.DOUBLE),
        ("end_time", T.DOUBLE),
        ("wall_s", T.DOUBLE),
        ("rows", T.BIGINT),
        ("error", T.VARCHAR),
        ("error_type", T.VARCHAR),
        ("error_code", T.VARCHAR),
    ],
    "spans": [
        ("query_id", T.VARCHAR),
        ("span_id", T.BIGINT),
        ("parent_id", T.BIGINT),
        ("name", T.VARCHAR),
        ("start_ms", T.DOUBLE),
        ("duration_ms", T.DOUBLE),
        ("attributes", T.VARCHAR),
    ],
    "compilations": [
        ("seq", T.BIGINT),
        ("step", T.VARCHAR),
        ("bucket", T.BIGINT),
        ("mesh", T.VARCHAR),
        ("query_id", T.VARCHAR),
        ("fragment", T.BIGINT),
        ("wall_s", T.DOUBLE),
        ("key_fp", T.VARCHAR),
        ("key", T.VARCHAR),
    ],
    "metrics": [
        ("name", T.VARCHAR),
        ("kind", T.VARCHAR),
        ("labels", T.VARCHAR),
        ("value", T.DOUBLE),
    ],
    "nodes": [
        ("node_id", T.VARCHAR),
        ("state", T.VARCHAR),
        # seconds since the worker's last successful heartbeat (NULL when
        # the node never heartbeat — e.g. local mesh devices)
        ("heartbeat_age_s", T.DOUBLE),
        # the worker's circuit-breaker state (closed | half_open | open)
        ("breaker_state", T.VARCHAR),
        # the process's prewarm-executor state (runtime/prewarm: IDLE |
        # RUNNING | WARM | UNCLOSED | FAILED; NULL = no executor attached)
        ("prewarm", T.VARCHAR),
    ],
    "resource_groups": [
        ("name", T.VARCHAR),
        ("weight", T.BIGINT),
        ("max_concurrency", T.BIGINT),
        ("max_queued", T.BIGINT),
        ("memory_limit_bytes", T.BIGINT),
        ("memory_reserved_bytes", T.BIGINT),
        ("running", T.BIGINT),
        ("queued", T.BIGINT),
        ("total_admitted", T.BIGINT),
        ("total_queued", T.BIGINT),
        ("shed", T.BIGINT),
    ],
    "query_profiles": [
        ("query_id", T.VARCHAR),
        ("sql_hash", T.VARCHAR),
        ("state", T.VARCHAR),
        ("wall_s", T.DOUBLE),
        ("mesh", T.VARCHAR),
        # resource group the statement was admitted through (NULL for
        # undispatched executions)
        ("resource_group", T.VARCHAR),
        # device time-slice gate wait attributed to the statement
        ("gate_wait_s", T.DOUBLE),
        ("compile_s", T.DOUBLE),
        ("peak_memory_bytes", T.BIGINT),
        # filesystem-SPI location of the archived artifact (NULL when the
        # store runs in-memory only)
        ("archived_path", T.VARCHAR),
    ],
    "plan_decisions": [
        ("query_id", T.VARCHAR),
        ("decision_id", T.VARCHAR),
        ("kind", T.VARCHAR),
        ("site", T.VARCHAR),
        ("choice", T.VARCHAR),
        ("alternative", T.VARCHAR),
        # JSON: the inputs the decider saw (estimated rows, license
        # width, economy verdict)
        ("inputs", T.VARCHAR),
        # audit-log watermark at decision time (telemetry/audit seq)
        ("audit_seq", T.BIGINT),
        # exchange-plane bytes (all_to_all + all_gather) this choice moved
        ("exchange_bytes", T.BIGINT),
        # JSON: {kind/purpose: bytes} full attribution
        ("bytes_by", T.VARCHAR),
        # summed wall of the fragments whose collectives attributed here
        ("fragment_wall_s", T.DOUBLE),
        ("hindsight", T.VARCHAR),
        ("hindsight_detail", T.VARCHAR),
    ],
    "session_properties": [
        ("name", T.VARCHAR),
        ("value", T.VARCHAR),
        ("description", T.VARCHAR),
    ],
    "caches": [
        ("tier", T.VARCHAR),
        ("bytes", T.BIGINT),
        ("hits", T.BIGINT),
        ("misses", T.BIGINT),
    ],
}


class _SystemMetadata(ConnectorMetadata):
    def list_schemas(self):
        return ["metrics", "runtime"]

    def list_tables(self, schema: str):
        if schema == "runtime":
            return sorted(_TABLES)
        if schema == "metrics":
            return ["metrics"]
        return []

    def table_metadata(self, schema: str, table: str) -> TableMetadata:
        if table not in self.list_tables(schema):
            raise KeyError(f"system table not found: {schema}.{table}")
        return TableMetadata(
            schema, table, tuple(ColumnMeta(n, t) for n, t in _TABLES[table])
        )

    def table_statistics(self, schema: str, table: str) -> TableStatistics:
        return TableStatistics(row_count=100)


class _RowsPageSource(PageSource):
    def __init__(self, rows: list, types: list, columns: list, all_names: list):
        self.rows = rows
        self.types = types
        self.columns = columns
        self.all_names = all_names

    def row_count(self) -> int:
        return len(self.rows)

    def pages(self):
        ix = [self.all_names.index(c) for c in self.columns]
        out = []
        for i, t in zip(ix, self.types):
            vals = [r[i] for r in self.rows]
            valid = np.asarray([v is not None for v in vals])
            if T.is_string_kind(t):
                strs = ["" if v is None else str(v) for v in vals]
                d = StringDictionary.from_unsorted(strs or [""])
                codes = np.asarray(
                    [d.index[s] for s in strs], dtype=np.int32
                )
                out.append(
                    ColumnData(codes, None if valid.all() else valid, d)
                )
            else:
                data = np.asarray(
                    [0 if v is None else v for v in vals], dtype=t.np_dtype
                )
                out.append(ColumnData(data, None if valid.all() else valid))
        yield out


class SystemConnector(Connector):
    name = "system"

    def __init__(self, runner=None):
        self.runner = runner  # bound after runner construction
        self._metadata = _SystemMetadata()

    def metadata(self):
        return self._metadata

    def splits(self, handle: TableHandle, target_splits: int, predicate=None):
        n = len(self._rows(handle.table))
        return [Split(handle, 0, row_start=0, row_count=n)]

    def page_source(self, split: Split, columns, max_rows_per_page: int = 1 << 20):
        table = split.table.table
        schema = _TABLES[table]
        all_names = [n for n, _ in schema]
        tmap = dict(schema)
        return _RowsPageSource(
            self._rows(table), [tmap[c] for c in columns], list(columns), all_names
        )

    def _rows(self, table: str) -> list:
        r = self.runner
        if table == "queries":
            hist = getattr(r, "query_history", None)
            if hist is None:
                return []
            return [
                (
                    e["query_id"], e["state"], e["query"], e["create_time"],
                    e["end_time"], e.get("wall_s"), e["rows"], e["error"],
                    e.get("error_type"), e.get("error_code"),
                )
                for e in hist.entries
            ]
        if table == "spans":
            out = []
            for qid, spans in getattr(r, "traces", ()):
                for s in spans:
                    out.append(
                        (
                            s["query_id"] or qid, s["span_id"],
                            s["parent_id"], s["name"], s["start_ms"],
                            s["duration_ms"], s["attributes"],
                        )
                    )
            return out
        if table == "compilations":
            # the compile observatory's recent events (telemetry/
            # compile_events): step-cache builds and kernel builds/loads
            from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

            return OBSERVATORY.rows()
        if table == "metrics":
            from trino_tpu_torch.telemetry import REGISTRY

            return REGISTRY.rows()
        if table == "nodes":
            # cluster membership (runtime/membership) is authoritative when
            # present: worker id, ACTIVE|DRAINING|DEAD, heartbeat age, the
            # worker's breaker state, and the process's prewarm state
            pw = getattr(r, "prewarm", None)
            pstate = pw.state if pw is not None else None
            membership = getattr(r, "membership", None)
            det = getattr(r, "failure_detector", None)
            if membership is None and det is not None:
                membership = getattr(det, "membership", None)
                if membership is not None and hasattr(det, "refresh"):
                    det.refresh()  # silent past the timeout -> DEAD
            if membership is not None:
                return [row + (pstate,) for row in membership.snapshot()]
            # no membership: the runner's device, every CUDA device when
            # it runs on the card, one row for the CPU otherwise
            import torch

            dev = getattr(r, "device", None)
            if dev is not None and dev.type == "cuda":
                return [
                    (f"cuda:{i}", "ACTIVE", None, None, pstate)
                    for i in range(torch.cuda.device_count())
                ]
            return [("cpu", "ACTIVE", None, None, pstate)]
        if table == "resource_groups":
            # live admission state: the dispatcher when attached (serving
            # coordinator), else any standalone resource-group manager the
            # runner carries; an embedded runner with neither has no rows
            d = getattr(r, "dispatcher", None)
            stats = (
                d.stats()
                if d is not None
                else getattr(
                    getattr(r, "resource_groups", None), "stats", lambda: []
                )()
            )
            return [
                (
                    s["name"], s.get("weight", 1), s["hard_concurrency"],
                    s.get("max_queued"), s.get("memory_limit_bytes", 0),
                    s.get("memory_reserved_bytes", 0), s["running"],
                    s["queued"], s["total_admitted"], s["total_queued"],
                    s.get("shed_total", 0),
                )
                for s in stats
            ]
        if table == "query_profiles":
            # the profile archive's memory ring (telemetry/profile_store):
            # one row per recently archived statement artifact; empty when
            # no store is attached (profile.archive-dir unset)
            store = getattr(r, "profile_store", None)
            return store.rows() if store is not None else []
        if table == "plan_decisions":
            # the decision ledgers of recently archived statements
            # (telemetry/decisions via the profile ring); empty when no
            # store is attached
            store = getattr(r, "profile_store", None)
            return store.decision_rows() if store is not None else []
        if table == "session_properties":
            return [
                (name, str(value), meta.description)
                for name, value, meta in r.properties.items()
            ]
        if table == "caches":
            from trino_tpu_torch.runtime.buffer_pool import POOL

            s = POOL.stats()
            return [
                ("host", s["host_bytes"], s["host_hits"], s["host_misses"]),
                (
                    "device",
                    s["device_bytes"],
                    s["device_hits"],
                    s["device_misses"],
                ),
            ]
        raise KeyError(table)

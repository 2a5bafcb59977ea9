"""Query performance observatory: the persistent per-query profile archive.

Port of trino_tpu/telemetry/profile_store.py.  Reference roles: QueryInfo
JSON persisted per query (the reference writes the full QueryStats tree
to disk), plus the event-listener pipeline that makes completed-query
statistics durable, so any two runs of a statement can be diffed, weeks
apart, without re-measuring.

  * `build_artifact` assembles ONE structured JSON artifact per completed
    statement: wall + per-phase decomposition (trace/compute/collective/
    transfer/other from the MeshProfile, plus the device-gate wait and a
    signed `unattributed` remainder so **phases always sum to wall_s
    exactly** — the invariant `tools/profile_diff.py` relies on), the
    per-fragment stats with `collective_bytes_by`, counters, step-cache
    stats, the span tree, the compile events attributed to the query,
    admission info (group, queued seconds), peak memory and the decision
    ledger — keyed by (query_id, sql_hash, mesh signature, bucket set);
  * `ProfileStore` persists artifacts through the filesystem SPI
    (`profile.archive-dir`), OFF the statement thread (one named
    background writer thread; the statement thread only assembles the
    dict), keeps a bounded in-memory ring for
    `system.runtime.query_profiles` and `system.runtime.plan_decisions`,
    and runs the retention sweep (`profile.retention-max-age` /
    `profile.retention-max-count`) with an injectable clock.

Peak memory: on the card, `torch.cuda.max_memory_allocated` of the
statement's device (the runner resets the device's peak counter when a
statement with an attached store starts); on the CPU, the statement's
reserved peak (`QueryContext.peak_memory`).
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

#: artifact schema version (bump on incompatible shape changes so
#: profile_diff can refuse apples-vs-oranges comparisons loudly)
ARTIFACT_VERSION = 1

#: phase vocabulary of the artifact-level decomposition: the MeshProfile
#: phases, the device-gate wait, and the signed remainder that makes the
#: set sum to wall_s exactly (host planning/serialization and, for purely
#: local executions, all device work land in `unattributed`)
ARTIFACT_PHASES = (
    "trace", "compute", "collective", "transfer", "other",
    "gate_wait", "unattributed",
)

#: spans stored per artifact (profiles are diff inputs, not trace
#: replacements; the full tree stays in the runner's trace)
MAX_SPANS = 512
#: compile events stored per artifact
MAX_COMPILE_EVENTS = 256


def sql_hash(sql: str) -> str:
    """Stable statement fingerprint (whitespace-normalized)."""
    norm = " ".join(sql.split()).lower()
    return hashlib.blake2s(norm.encode()).hexdigest()[:16]


def _artifact_key(query_id: str, shash: str, mesh: str, buckets) -> str:
    mesh_fp = hashlib.blake2s(
        (str(mesh) + str(sorted(buckets or ()))).encode()
    ).hexdigest()[:8]
    return f"{query_id}-{shash[:12]}-{mesh_fp}"


def build_artifact(
    query_id: str,
    sql: str,
    state: str,
    wall_s: float,
    rows: int = 0,
    mesh_profile=None,
    tracer=None,
    gate_wait_s: float = 0.0,
    peak_memory_bytes: int = 0,
    admission=None,
    mesh: str = "local",
    compile_events=None,
    error_code=None,
    created_at: Optional[float] = None,
    decisions=None,
) -> dict:
    """Assemble one archived profile artifact (plain JSON-able dict).

    The phase decomposition invariant: ``sum(artifact['phases'].values())
    == artifact['wall_s']`` EXACTLY, because `unattributed` is defined as
    the signed remainder — time the profile did not see (host planning,
    result serialization, local device work) is named, never vanished,
    and `profile_diff`'s per-phase attributions therefore sum to the wall
    delta by construction."""
    phases = {p: 0.0 for p in ARTIFACT_PHASES}
    fragments = []
    counters: dict = {}
    trace_cache: dict = {}
    collective_by: dict = {}
    if mesh_profile is not None:
        prof = mesh_profile.to_json()
        fragments = prof["fragments"]
        counters = dict(prof["counters"])
        trace_cache = dict(prof["trace_cache"])
        collective_by = dict(prof["collective_bytes_by"])
        for k, v in mesh_profile.phase_totals().items():
            if k in phases:
                phases[k] = float(v)
            else:  # future phase names never silently drop
                phases[k] = phases.get(k, 0.0) + float(v)
    phases["gate_wait"] = round(float(gate_wait_s), 9)
    tracked = sum(v for k, v in phases.items() if k != "unattributed")
    phases["unattributed"] = wall_s - tracked
    events = []
    buckets: set = set()
    compile_s = 0.0
    for ev in compile_events or ():
        if ev.query_id != query_id:
            continue
        if ev.bucket is not None:
            buckets.add(int(ev.bucket))
        compile_s += ev.wall_s
        if len(events) < MAX_COMPILE_EVENTS:
            events.append(
                {
                    "step": ev.step,
                    "bucket": ev.bucket,
                    "fragment": ev.fragment,
                    "wall_s": round(ev.wall_s, 6),
                    "key_fp": ev.key_fp,
                }
            )
    spans = []
    if tracer is not None and getattr(tracer, "enabled", False):
        spans = tracer.flat_spans()[:MAX_SPANS]
    group, queued_s = (admission or (None, 0.0))
    shash = sql_hash(sql)
    return {
        "version": ARTIFACT_VERSION,
        "key": _artifact_key(query_id, shash, mesh, buckets),
        "query_id": query_id,
        "sql": sql[:2000],
        "sql_hash": shash,
        "state": state,
        "error_code": error_code,
        "created_at": (
            time.time() if created_at is None else float(created_at)
        ),
        "rows": rows,
        "wall_s": wall_s,
        "mesh": str(mesh),
        "buckets": sorted(buckets),
        "phases": phases,
        "fragments": fragments,
        "counters": counters,
        "trace_cache": trace_cache,
        "collective_bytes_by": collective_by,
        "compile": {"events": events, "compile_s": round(compile_s, 6)},
        "admission": {"group": group, "queued_s": round(queued_s, 6)},
        "gate": {"wait_s": round(float(gate_wait_s), 9)},
        "peak_memory_bytes": int(peak_memory_bytes),
        "spans": spans,
        "decisions": decisions,
    }


def statement_peak_memory(runner, ctx) -> int:
    """The statement's peak memory: the allocator's peak on the card (the
    counter the runner reset when the statement started), the reserved
    peak on the CPU."""
    dev = getattr(runner, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch

        return int(torch.cuda.max_memory_allocated(dev))
    return int(ctx.peak_memory)


def artifact_from_runner(runner, ctx, sql: str, state: str, wall_s: float,
                         rows: int = 0, error_code=None) -> dict:
    """Assemble the artifact for a just-completed statement from the
    engine surfaces the runner already holds (called by
    LocalQueryRunner.execute after FINISHING; the heavy half — the SPI
    write — happens on the store's writer thread, not here)."""
    from trino_tpu_torch.runtime.lifecycle import current_admission
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    mesh = "local"
    wm = getattr(runner, "wm", None)
    if wm is not None:
        from trino_tpu_torch.parallel.spmd import mesh_key

        mesh = str(mesh_key(wm))
    return build_artifact(
        query_id=ctx.query_id,
        sql=sql,
        state=state,
        wall_s=wall_s,
        rows=rows,
        mesh_profile=ctx.mesh_profile,
        tracer=ctx.tracer,
        gate_wait_s=ctx.gate_wait_s,
        peak_memory_bytes=statement_peak_memory(runner, ctx),
        admission=current_admission(),
        mesh=mesh,
        compile_events=OBSERVATORY.events(),
        error_code=error_code,
        decisions=(
            ctx.decisions.to_json()
            if getattr(ctx, "decisions", None) is not None
            else None
        ),
    )


class ProfileStore:
    """Bounded in-memory ring + filesystem-SPI archive of profile
    artifacts.  Thread-safe: statement threads on concurrent engine lanes
    call `archive()` simultaneously; one background writer drains the
    queue so the SPI write never sits on the statement hot path.  Every
    write goes through `FileSystem.write` (atomic publish), so concurrent
    completions produce K distinct, never-torn JSON files."""

    def __init__(
        self,
        archive_dir: str = "",
        retention_max_age_s: float = 0.0,
        retention_max_count: int = 0,
        ring_limit: int = 256,
        clock: Callable[[], float] = time.time,
        synchronous: bool = False,
    ):
        self.archive_dir = strip_scheme(archive_dir) if archive_dir else ""
        self.fs = filesystem_for(archive_dir) if archive_dir else None
        self.retention_max_age_s = float(retention_max_age_s)
        self.retention_max_count = int(retention_max_count)
        self.clock = clock
        #: tests: write on the caller thread instead of the queue
        self.synchronous = synchronous
        self._lock = threading.Lock()
        #: artifact key -> artifact (insertion-ordered recency ring)
        self._ring: OrderedDict = OrderedDict()
        self._ring_limit = int(ring_limit)
        #: query_id -> artifact key (the `get` resolver)
        self._by_query: OrderedDict = OrderedDict()
        self._queue: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        #: background-writer SPI failures (monotonic; flush() reports a
        #: drain that ERRORED as False — refs to files that never landed
        #: must not read as a usable diff baseline)
        self._write_errors = 0

    @classmethod
    def from_config(cls, cfg=None) -> "ProfileStore":
        """Store wired from the typed config's `profile.*` section."""
        if cfg is None:
            from trino_tpu_torch.config import get_config

            cfg = get_config()
        p = cfg.profile
        return cls(
            archive_dir=p.archive_dir,
            retention_max_age_s=p.retention_max_age_s,
            retention_max_count=p.retention_max_count,
            ring_limit=p.ring_limit,
        )

    # -- archive ---------------------------------------------------------------

    def archive(self, artifact: dict) -> dict:
        """Record one artifact; returns its ref {key, query_id, sql_hash,
        path}.  The ring insert is O(1) under the lock; the SPI write is
        handed to the background writer (or done inline when
        `synchronous`, the test mode)."""
        from trino_tpu_torch.telemetry.metrics import profiles_archived_counter

        key = artifact["key"]
        path = self._path(key)
        with self._lock:
            self._ring[key] = artifact
            self._by_query[artifact["query_id"]] = key
            while len(self._ring) > self._ring_limit:
                self._ring.popitem(last=False)
            while len(self._by_query) > self._ring_limit:
                self._by_query.popitem(last=False)
        profiles_archived_counter().inc()
        if self.fs is not None:
            if self.synchronous:
                self._write(artifact, path)
            else:
                self._ensure_writer()
                self._queue.put((artifact, path))
        return {
            "key": key,
            "query_id": artifact["query_id"],
            "sql_hash": artifact["sql_hash"],
            "path": path,
        }

    def _path(self, key: str) -> Optional[str]:
        if not self.archive_dir:
            return None
        import os

        return os.path.join(self.archive_dir, f"{key}.json")

    def _write(self, artifact: dict, path: str) -> None:
        data = json.dumps(artifact, sort_keys=True).encode()
        self.fs.write(path, data)

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._writer is not None and self._writer.is_alive():
                return
            self._writer = threading.Thread(
                target=self._drain, name="profile-archiver", daemon=True
            )
            self._writer.start()

    def _drain(self) -> None:
        while True:
            artifact, path = self._queue.get()
            try:
                self._write(artifact, path)
            except Exception:
                import logging

                with self._lock:
                    self._write_errors += 1
                logging.getLogger("trino_tpu_torch.profile_store").warning(
                    "failed to archive profile %s", path, exc_info=True
                )
            finally:
                self._queue.task_done()

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every queued artifact is on disk (tests);
        True only when the queue drained inside the timeout AND no write
        errored since the call started — a drain that merely DISCARDED
        failed writes is not a flush."""
        if self.fs is None or self.synchronous:
            return True
        with self._lock:
            errors_before = self._write_errors
        deadline = time.monotonic() + timeout_s
        drained = False
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                drained = True
                break
            time.sleep(0.005)
        drained = drained or self._queue.unfinished_tasks == 0
        with self._lock:
            errors_after = self._write_errors
        return drained and errors_after == errors_before

    # -- lookup ----------------------------------------------------------------

    def get(self, query_id_or_key: str) -> Optional[dict]:
        """Artifact by engine query id or artifact key: the memory ring
        first, then the archive directory (a fresh process can serve
        profiles the previous incarnation archived)."""
        with self._lock:
            key = self._by_query.get(query_id_or_key, query_id_or_key)
            art = self._ring.get(key)
        if art is not None:
            return art
        if self.fs is None:
            return None
        path = self._path(key)
        if path is not None and self.fs.exists(path):
            return json.loads(self.fs.read(path).decode())
        # engine query id of a previous incarnation: scan by prefix,
        # NEWEST artifact first (query_N sequences restart per process, so
        # several incarnations' files can share a prefix)
        candidates = []
        for p in self.fs.list(self.archive_dir):
            name = p.rsplit("/", 1)[-1]
            if name.startswith(f"{query_id_or_key}-") and name.endswith(".json"):
                try:
                    candidates.append((self.fs.mtime(p), p))
                except OSError:
                    continue
        if candidates:
            return json.loads(self.fs.read(max(candidates)[1]).decode())
        return None

    def refs(self) -> list:
        """[{key, query_id, sql_hash, path}] of ring artifacts, oldest
        first."""
        with self._lock:
            return [
                {
                    "key": a["key"],
                    "query_id": a["query_id"],
                    "sql_hash": a["sql_hash"],
                    "path": self._path(a["key"]),
                }
                for a in self._ring.values()
            ]

    def rows(self) -> list:
        """system.runtime.query_profiles feed: (query_id, sql_hash, state,
        wall_s, mesh, group, gate_wait_s, compile_s, peak_memory_bytes,
        archived_path) per ring artifact."""
        with self._lock:
            arts = list(self._ring.values())
        return [
            (
                a["query_id"],
                a["sql_hash"],
                a["state"],
                round(a["wall_s"], 6),
                a["mesh"],
                a["admission"]["group"],
                a["gate"]["wait_s"],
                a["compile"]["compile_s"],
                a["peak_memory_bytes"],
                self._path(a["key"]),
            )
            for a in arts
        ]

    def decision_rows(self) -> list:
        """system.runtime.plan_decisions feed: one row per recorded plan
        decision across ring artifacts (telemetry/decisions), oldest
        artifact first — (query_id, decision_id, kind, site, choice,
        alternative, inputs, audit_seq, exchange_bytes, bytes_by,
        fragment_wall_s, hindsight, hindsight_detail)."""
        import json as _json

        with self._lock:
            arts = list(self._ring.values())
        out = []
        for a in arts:
            led = a.get("decisions") or {}
            for d in led.get("decisions", ()):
                out.append(
                    (
                        a["query_id"],
                        d["decision_id"],
                        d["kind"],
                        d["site"],
                        d["choice"],
                        d["alternative"],
                        _json.dumps(d["inputs"], sort_keys=True),
                        d["audit_seq"],
                        d["exchange_bytes"],
                        _json.dumps(d["bytes_by"], sort_keys=True),
                        d["measured"].get("fragment_wall_s"),
                        d["hindsight"],
                        d["hindsight_detail"],
                    )
                )
        return out

    # -- retention -------------------------------------------------------------

    def sweep(self, now_s: Optional[float] = None) -> list:
        """Delete expired artifacts from the archive directory: older than
        `retention_max_age_s` (by SPI mtime against the injectable clock),
        then oldest-first down to `retention_max_count`.  Returns deleted
        paths; only `.json` files under the archive dir are ever touched
        (the sweep must not eat a co-located spool)."""
        if self.fs is None:
            return []
        from trino_tpu_torch.telemetry.metrics import profiles_pruned_counter

        now_s = self.clock() if now_s is None else now_s
        entries = []
        for p in self.fs.list(self.archive_dir):
            if not p.endswith(".json"):
                continue
            try:
                entries.append((self.fs.mtime(p), p))
            except OSError:
                continue  # vanished under us
        entries.sort()
        deleted = []
        if self.retention_max_age_s > 0:
            for mt, p in list(entries):
                if now_s - mt > self.retention_max_age_s:
                    self.fs.delete(p)
                    deleted.append(p)
                    entries.remove((mt, p))
        if self.retention_max_count > 0:
            while len(entries) > self.retention_max_count:
                mt, p = entries.pop(0)
                self.fs.delete(p)
                deleted.append(p)
        if deleted:
            profiles_pruned_counter().inc(len(deleted))
        return deleted


def attach_profile_store(runner, store: Optional[ProfileStore] = None):
    """Attach a ProfileStore to a runner (and through clone_for_dispatch
    to every engine lane).  With no explicit store, builds one from the
    typed config — a no-op returning None when `profile.archive-dir` is
    unset and no store was passed (archiving stays zero-cost-off by
    default, the idle-cost contract)."""
    if store is None:
        existing = getattr(runner, "profile_store", None)
        if existing is not None:
            return existing  # idempotent config-driven re-attach
        from trino_tpu_torch.config import get_config

        if not get_config().profile.archive_dir:
            return None
        store = ProfileStore.from_config()
    runner.profile_store = store
    return store

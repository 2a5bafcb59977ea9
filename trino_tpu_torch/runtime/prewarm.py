"""Restart resilience: the AOT prewarm executor and its workload manifest.

Port of trino_tpu/runtime/prewarm.py.  A restarted process is cold in two
layers, and the port covers them so:

  * **the kernels**: each CUDA kernel is an nvcc build kept under the hash
    of its source in the build directory (`build/trino_tpu_torch/`,
    kernels/build.py), which survives a restart, so a restarted process
    only loads its libraries (one `dlopen` each).  That directory is the
    counterpart of the JAX package's persistent XLA compile cache, whose
    two functions (`enable_persistent_compile_cache` /
    `disable_persistent_compile_cache`) are therefore left out: there is
    no jit cache for them to configure;
  * **the steps** (`parallel/spmd.TRACE_CACHE` is process-local and dies
    with the process) are re-built by the `PrewarmExecutor`: it persists a
    workload manifest -- the SQL replay set, the learned speculative-join
    capacities (`cap_history`), the global dictionary assignment and the
    recorder's closure watermark -- via the filesystem SPI, and replays it
    in a background thread at server start and after a mesh grow
    (`resize_mesh`, `add_worker`), building every (step, bucket, mesh) key
    at the CURRENT mesh signature and loading every kernel the statements
    launch before the next query arrives.

A compile event is the observatory's (telemetry/compile_events): a
step-cache miss, a kernel build or a kernel load.  Closure is verified,
not assumed: after the replay the executor takes an observatory watermark
and (when `verify`) replays once more -- zero compile events above the
watermark means the key set is closed and the first real query builds
and loads nothing.  The manifest's JSON document is the JAX package's, so
a manifest either package wrote loads in the other.  State is surfaced in
`system.runtime.nodes` (`prewarm` column) and the `trino_tpu_prewarm_*`
metric family.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger(__name__)

MANIFEST_VERSION = 1

#: bounded replay set: a serving coordinator records distinct SELECTs here,
#: and an unbounded set would make prewarm replay unbounded too
RECORD_LIMIT = 512

#: a statement that LEARNS a speculative-join capacity legitimately builds
#: again on its next run (the fused expand moves to the learned bucket);
#: bound the follow-up runs so a pathological workload cannot loop
MAX_CAPACITY_ROUNDS = 4


# -- workload manifest ---------------------------------------------------------


@dataclass
class WorkloadManifest:
    """What a process must replay to be warm: the SQL set, the learned
    capacities that make speculative joins take the fused path at the
    right bucket on run 1, and the recorder's closure evidence."""

    statements: list = field(default_factory=list)
    cap_history: list = field(default_factory=list)
    #: recorder's compile-event count once its key set closed (its own
    #: process counter — a replaying process derives its OWN watermark)
    watermark: int = 0
    #: recorder verified a replay added zero events above the watermark
    closed: Optional[bool] = None
    workers: int = 0
    #: the observatory's deduplicated key set at save (informational: which
    #: steps/buckets the replay is expected to build)
    compile_keys: list = field(default_factory=list)
    #: global dictionary snapshot document (runtime/dictionary_service
    #: snapshot_doc): shipped with the manifest so a restarted process
    #: resolves versioned code assignments BEFORE replaying — warm paths
    #: never block on (or re-derive differently-versioned) code resolution
    dictionaries: Optional[dict] = None

    def to_json(self) -> dict:
        return {
            "version": MANIFEST_VERSION,
            "sql": list(self.statements),
            "cap_history": list(self.cap_history),
            "watermark": self.watermark,
            "closed": self.closed,
            "workers": self.workers,
            "manifest": list(self.compile_keys),
            "dictionaries": self.dictionaries,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "WorkloadManifest":
        """Tolerant load: tools/prewarm_manifest.py documents (which carry
        extra bench fields) and hand-written {"sql": [...]} files both
        work — a manifest is an optimization input, never a schema
        contract that bricks a restart."""
        return cls(
            statements=list(doc.get("sql") or ()),
            cap_history=list(doc.get("cap_history") or ()),
            watermark=int(doc.get("watermark") or 0),
            closed=doc.get("closed"),
            workers=int(doc.get("workers") or 0),
            compile_keys=list(doc.get("manifest") or ()),
            dictionaries=(
                doc.get("dictionaries")
                if isinstance(doc.get("dictionaries"), dict)
                else None
            ),
        )


def save_manifest(manifest: WorkloadManifest, location: str,
                  extra: Optional[dict] = None) -> None:
    """Persist via the filesystem SPI (atomic publish — a reader never
    sees a half-written manifest)."""
    from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

    fs = filesystem_for(location)
    doc = manifest.to_json()
    if extra:
        doc.update(extra)
    fs.write(
        strip_scheme(location),
        (json.dumps(doc, indent=1, default=str) + "\n").encode(),
    )


def load_manifest(location: str) -> Optional[WorkloadManifest]:
    """Load, or None when absent/unreadable (a fresh deployment has no
    manifest yet; prewarm simply has nothing to do)."""
    from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

    try:
        fs = filesystem_for(location)
        path = strip_scheme(location)
        if not fs.exists(path):
            return None
        return WorkloadManifest.from_json(json.loads(fs.read(path).decode()))
    except (NotImplementedError, OSError, ValueError) as e:
        log.warning("prewarm manifest unreadable at %s: %s", location, e)
        return None


def replay_statements(runner, statements,
                      max_capacity_rounds: int = MAX_CAPACITY_ROUNDS) -> int:
    """Run each statement once, plus one bounded follow-up per run that
    LEARNED a speculative-join capacity (CAP_HISTORY.version moved): the
    next run compiles the fused expand at the learned bucket, which is part
    of the closed key set, not a closure failure.  Returns executions."""
    from trino_tpu_torch.partitioning import CAP_HISTORY

    runs = 0
    for sql in statements:
        version = CAP_HISTORY.version
        runner.execute(sql)
        runs += 1
        extra = 0
        while CAP_HISTORY.version != version and extra < max_capacity_rounds:
            version = CAP_HISTORY.version
            runner.execute(sql)
            runs += 1
            extra += 1
    return runs


def _is_replayable(sql: str) -> bool:
    """Only read-only statements belong in a replay set: replaying DDL/DML
    would mutate state, and SET SESSION would leak into later queries."""
    head = sql.lstrip().lower()
    return head.startswith(("select", "with", "values", "table "))


# -- prewarm executor ----------------------------------------------------------


class PrewarmExecutor:
    """Replays a persisted workload manifest on a runner so its compile-key
    set is warm before real traffic arrives (see module doc).

    States: IDLE (no manifest / nothing replayed), RUNNING (replay in
    flight), WARM (replayed AND verified closed), UNCLOSED (the verify
    replay still compiled — the manifest under-covers the workload),
    FAILED (a replay statement raised).  `watermark` is the observatory
    count taken right after the replay: the closure assertion for THIS
    process is `OBSERVATORY.mark() - watermark == 0` after any further
    replay of the manifest."""

    def __init__(self, runner, manifest_location: Optional[str] = None,
                 verify: bool = True):
        from trino_tpu_torch.config import get_config

        self.runner = runner
        self.location = (
            manifest_location
            if manifest_location is not None
            else (get_config().prewarm.manifest_path or None)
        )
        self.verify = verify
        #: serializes replays with each other until a dispatcher adopts
        #: the executor (use_admission), which then serializes them with
        #: live queries on the shared (not concurrency-safe) runner
        self._engine_lock = threading.Lock()
        #: dispatcher-mode admission (use_admission): a factory returning a
        #: context manager that admits the replay through the weight-capped
        #: system.prewarm resource group onto the primary engine lane —
        #: replays become fair queue participants instead of lock holders
        self._admission = None
        self._state_lock = threading.Lock()
        self.state = "IDLE"
        #: observatory count at closure (None until a replay completed)
        self.watermark: Optional[int] = None
        #: compile events the last verify replay recorded above the
        #: watermark (0 = closed; the acceptance assertion)
        self.verify_events: Optional[int] = None
        self.last_error: Optional[str] = None
        self.runs = 0
        self._recorded: list = []
        self._recorded_set: set = set()
        self._thread: Optional[threading.Thread] = None
        #: a kick that arrived while a replay was in flight (latest wins);
        #: the finishing replay starts it, so a grow during a start replay
        #: still re-builds at the final mesh signature
        self._pending: Optional[tuple] = None

    def use_admission(self, factory) -> None:
        """Adopt a dispatcher admission (CoordinatorServer passes
        `dispatcher.system_admission`): replays serialize with live
        queries by admitting through the system.prewarm resource group
        instead of holding a lock — a post-grow replay waits its fair
        turn and other engine lanes keep serving users meanwhile."""
        self._admission = factory

    def _serialized(self):
        """The context manager one replay runs under (admission when a
        dispatcher adopted us, the engine lock otherwise)."""
        return (
            self._admission() if self._admission is not None
            else self._engine_lock
        )

    # -- recording (the serving-path manifest source) -------------------------

    def record(self, sql: str) -> bool:
        """Add a statement to the replay set (deduplicated, first-seen
        order, read-only statements only, bounded)."""
        if not _is_replayable(sql):
            return False
        with self._state_lock:
            if sql in self._recorded_set or len(self._recorded) >= RECORD_LIMIT:
                return False
            self._recorded.append(sql)
            self._recorded_set.add(sql)
        return True

    def manifest(self) -> WorkloadManifest:
        """A manifest of everything recorded in THIS process, with the
        current learned capacities and observatory state."""
        from trino_tpu_torch.partitioning import CAP_HISTORY
        from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE
        from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

        with self._state_lock:
            stmts = list(self._recorded)
        from trino_tpu_torch.config import get_config

        dicts = DICTIONARY_SERVICE.snapshot_doc(
            get_config().dictionary.max_inline_values
        )
        return WorkloadManifest(
            statements=stmts,
            cap_history=CAP_HISTORY.snapshot(),
            watermark=OBSERVATORY.mark(),
            closed=None,
            workers=getattr(getattr(self.runner, "wm", None), "n", 0)
            or len(getattr(self.runner, "worker_urls", ())),
            compile_keys=OBSERVATORY.manifest(),
            dictionaries=dicts if dicts.get("entries") else None,
        )

    def save(self) -> bool:
        """Persist the UNION of the on-disk manifest and this process's
        recorded statements (no-op without a location or anything new to
        add).  Merging at save time — not only when a replay happened to
        load the file — means an operator-provided manifest survives even
        a server that shut down before its prewarm ran or had
        `prewarm.on-start=false`."""
        if not self.location:
            return False
        m = self.manifest()
        existing = self.load()
        if existing is not None and existing.statements:
            seen = set(existing.statements)
            m.statements = existing.statements + [
                s for s in m.statements if s not in seen
            ]
        if not m.statements:
            return False
        save_manifest(m, self.location)
        return True

    def load(self) -> Optional[WorkloadManifest]:
        return load_manifest(self.location) if self.location else None

    # -- replay ----------------------------------------------------------------

    def run(self, reason: str = "manual", wait: bool = False,
            statements: Optional[list] = None) -> Optional[threading.Thread]:
        """Replay in a background thread, one at a time.  A kick arriving
        while a replay is in flight is QUEUED (latest wins) and started by
        the finishing replay — a grow racing a start replay must still get
        a replay at the final mesh signature, never be silently dropped.
        `wait=True` joins the replay (and the queued follow-up, if any)."""
        with self._state_lock:
            t = self._thread
            if t is not None and t.is_alive():
                self._pending = (reason, statements)
            else:
                t = self._spawn(reason, statements)
        if wait:
            self.wait()
        return t

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the replay in flight and the follow-ups it starts (a kick
        queued meanwhile); True once none is running, False when
        `timeout` seconds ran out first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # a replay starts its follow-up before it ends, so a finished
            # thread still current means nothing is left to run
            with self._state_lock:
                t = self._thread
                if t is None or not t.is_alive():
                    return True
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return False
            t.join(left)

    def _spawn(self, reason: str, statements: Optional[list]):  # lint: allow(unguarded-state)
        """Start a replay thread (caller holds _state_lock)."""
        t = threading.Thread(
            target=self._replay, args=(reason, statements),
            daemon=True, name=f"prewarm-{reason}",
        )
        self._thread = t
        t.start()
        return t

    def _set_state(self, state: str) -> None:
        from trino_tpu_torch.telemetry.metrics import (
            PREWARM_STATE_CODES,
            prewarm_state_gauge,
        )

        with self._state_lock:
            self.state = state
        prewarm_state_gauge().set(PREWARM_STATE_CODES.get(state, 0))

    def _replay(self, reason: str, statements: Optional[list]) -> None:
        from trino_tpu_torch.partitioning import CAP_HISTORY
        from trino_tpu_torch.telemetry.compile_events import OBSERVATORY
        from trino_tpu_torch.telemetry.metrics import (
            prewarm_runs_counter,
            prewarm_statements_counter,
        )

        self._set_state("RUNNING")
        outcome = "failed"
        try:
            stmts = statements
            if stmts is None:
                m = self.load()
                if m is not None:
                    stmts = m.statements
                    # seed learned capacities FIRST so capacity-learning
                    # statements take the fused path at the right bucket on
                    # run 1 and the key set closes without extra rounds
                    CAP_HISTORY.seed(m.cap_history)
                    # adopt the recorded global dictionary assignment BEFORE
                    # replaying: the replay re-registers connector
                    # dictionaries under the RECORDED versions, so refs and
                    # steps built before the restart stay valid
                    if m.dictionaries:
                        from trino_tpu_torch.runtime.dictionary_service import (
                            DICTIONARY_SERVICE,
                        )

                        DICTIONARY_SERVICE.load_doc(m.dictionaries)
                    # the loaded set joins the recorded set: a restarted
                    # server's save() persists the UNION of the seed
                    # manifest and this incarnation's observed statements
                    for s in stmts:
                        self.record(s)
            if not stmts:
                outcome = "empty"
                self._set_state("IDLE")
                return
            with self._serialized():
                n = replay_statements(self.runner, stmts)
                prewarm_statements_counter().inc(n)
                wm = OBSERVATORY.mark()
                with self._state_lock:
                    self.watermark = wm
                if self.verify:
                    # closure is MEASURED: one more replay must record zero
                    # compile events above the watermark (capacity learning
                    # is settled by now, so no follow-up rounds)
                    prewarm_statements_counter().inc(
                        replay_statements(
                            self.runner, stmts, max_capacity_rounds=0
                        )
                    )
                    above = OBSERVATORY.mark() - wm
                    with self._state_lock:
                        self.verify_events = above
                    if above:
                        leaks = sorted(
                            {e.step for e in OBSERVATORY.events_above(wm)}
                        )
                        log.warning(
                            "prewarm replay is not closed: %d compile "
                            "event(s) above the watermark (steps: %s)",
                            above, ", ".join(leaks) or "rotated out of ring",
                        )
                        outcome = "unclosed"
                        self._set_state("UNCLOSED")
                        return
            outcome = "warm"
            self._set_state("WARM")
        except Exception as e:
            msg = f"{type(e).__name__}: {e}"
            with self._state_lock:
                self.last_error = msg
            log.warning("prewarm replay failed: %s", msg)
            self._set_state("FAILED")
        finally:
            self.runs += 1
            prewarm_runs_counter().labels(
                reason if reason in ("start", "grow") else "manual", outcome
            ).inc()
            # a kick queued while we ran replays now, at the CURRENT state
            # (e.g. the final mesh signature after a grow raced us)
            with self._state_lock:
                pending, self._pending = self._pending, None
                if pending is not None:
                    self._spawn(*pending)


def attach_prewarm(runner, manifest_location: Optional[str] = None,
                   **kw) -> Optional[PrewarmExecutor]:
    """Create + attach a PrewarmExecutor as `runner.prewarm` when a
    manifest location is configured (arg or `prewarm.manifest-path`);
    returns it, or None when unconfigured.  Grow paths
    (DistributedQueryRunner.resize_mesh / MultiHostQueryRunner.add_worker)
    and server start consult the attribute."""
    from trino_tpu_torch.config import get_config

    loc = manifest_location or get_config().prewarm.manifest_path
    if not loc:
        return None
    runner.prewarm = PrewarmExecutor(runner, loc, **kw)
    return runner.prewarm


def kick_grow_prewarm(runner) -> Optional[threading.Thread]:
    """After a mesh grow: replay the manifest at the NEW mesh signature in
    the background (a changed W is a new `mesh_key`, so the replay builds
    the new signature's steps).  No-op without an attached executor or
    with `prewarm.on-grow=false`."""
    from trino_tpu_torch.config import get_config

    pw = getattr(runner, "prewarm", None)
    if pw is None or not get_config().prewarm.on_grow:
        return None
    return pw.run(reason="grow")

"""Worker server: remote task execution over HTTP (the multi-host tier).

Reference roles: server/SqlTaskManager + TaskResource (/v1/task REST API) on
the worker side, TaskExecutor for the execution slot, and the HTTP data
plane of exchange/ExchangeClient: task outputs are partitioned buckets that
downstream tasks PULL with GET /v1/task/{id}/results/{bucket}.

The multi-host layer complements the in-mesh SPMD path: intra-host
parallelism is XLA collectives over the device mesh (parallel/runner.py);
inter-host distribution is fragments shipped to worker processes with HTTP
exchanges — the DCN tier, matching the reference's worker-to-worker shuffle.

Wire format: pickled plan fragments (intra-cluster traffic, the role of the
reference's internal thrift/json codecs) + PagesSerde buckets
(parallel/serde.py).  Because unpickling executes code, task submissions are
authenticated: when TRINO_TPU_CLUSTER_SECRET is set, every POST /v1/task must
carry an HMAC-SHA256 of the body under X-Cluster-Auth (the internal-
communication shared-secret analog of the reference's
internal-communication.shared-secret).  Binding to a non-loopback interface
REQUIRES the secret; the default loopback bind works without one.

Port of trino_tpu/server/worker.py.  A worker executes its fragments on
its own device: `WorkerServer(device=None)` resolves to the CUDA card and
raises where there is none, as `LocalQueryRunner` does, and `main` takes
`--device`.  Pulled page sets arrive as CPU batches (parallel/serde.py)
and move to the worker's device before the fragment reads them; a task's
output leaves the card once (`Batch.to("cpu")` of the concatenated
output) before it is partitioned and serialized.  A worker in its own
process is started with `python -m trino_tpu_torch.server.worker
--device cuda --port 0` under `PYTHONHASHSEED=0` (the TPC-H comment pools
follow Python's string hash), never forked from a process that already
initialised CUDA; `main` installs the config its environment gives
(`TRINO_TPU_WORKER_COORDINATOR_URL` points its dictionary-ref fetches at
the coordinator's `/v1/dictionary`; the JAX `main` reads no config).
Each task's `task` span carries its output bytes and
the host seconds of its output's copy off the card (`d2h_s`), bucketing
(`partition_s`) and serialization (`encode_s`); each `input_fetch` span
the bytes it pulled and their decode seconds (`decode_s`).  The listener keeps a backlog of 128
(`server/coordinator.HTTPServer`), as the port's coordinator does.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import pickle
import threading
import time
import traceback
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Optional, Sequence


def cluster_secret() -> Optional[bytes]:
    """Shared intra-cluster secret (reference:
    internal-communication.shared-secret)."""
    s = os.environ.get("TRINO_TPU_CLUSTER_SECRET")
    return s.encode() if s else None


def sign_body(secret: bytes, body: bytes) -> str:
    return _hmac.new(secret, body, hashlib.sha256).hexdigest()


class WorkerDraining(RuntimeError):
    """A submission raced past the handler's DRAINING fast-path but lost
    the atomic admission check in `WorkerServer.submit` — mapped to the
    same 503 the fast path answers."""


@dataclass
class TaskDescriptor:
    """One fragment execution on one worker."""

    task_id: str
    fragment_root: object  # PlanNode
    output_symbols: list
    #: RemoteSourceNode inputs: fragment_id -> list of result URLs (one per
    #: producing task; the bucket for THIS task is already in the URL)
    inputs: dict = field(default_factory=dict)
    #: output partitioning: (channels, n_buckets) or None for a single bucket
    output_partitioning: Optional[tuple] = None
    #: split assignment for leaf scans: (worker_index, total_workers)
    split_mod: Optional[tuple] = None
    #: session properties to apply
    properties: dict = field(default_factory=dict)
    #: cross-fragment dynamic filters: probe symbol name -> (lo, hi) raw
    #: device-representation bounds (reference: DynamicFilterService summary
    #: delivery into task descriptors)
    dynamic_ranges: dict = field(default_factory=dict)
    #: compute the dynamic-filter range summary for this task's output
    #: (set only on build-side fragments the coordinator will query)
    collect_ranges: bool = False
    #: seconds the owning query had left at submission (None = unbounded);
    #: bounds the task's own run AND its input-pull HTTP timeouts, so a
    #: worker never outlives the query that scheduled it (reference:
    #: HttpRemoteTask's per-request deadline derivation)
    deadline_s: Optional[float] = None
    #: coordinator trace context: (query_id, parent span id) — rides the
    #: descriptor the same way deadline_s does (the W3C traceparent analog
    #: of the reference's opentelemetry context propagation).  The worker
    #: opens its task/execution spans under it and serves the finished tree
    #: at GET /v1/task/{id}/spans for the coordinator to merge.
    trace_context: Optional[tuple] = None


class _FilteringConnector:
    """Delegates to a connector but serves only splits with
    seq % total == index (the coordinator's split assignment)."""

    def __init__(self, inner, index: int, total: int):
        self._inner = inner
        self._index = index
        self._total = total

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def splits(self, handle, target_splits, predicate=None):
        out = [
            s
            for s in self._inner.splits(
                handle, target_splits=max(target_splits, self._total),
                predicate=predicate,
            )
            if s.seq % self._total == self._index
        ]
        return out


class _Task:
    def __init__(self, desc: TaskDescriptor):
        from trino_tpu_torch.runtime.lifecycle import QueryContext

        self.desc = desc
        self.state = "RUNNING"
        self.error: Optional[str] = None
        self.buckets: list = []
        #: nested span tree of this task's execution (Span.to_dict form),
        #: set at completion when the descriptor carried a trace context;
        #: the coordinator grafts it under its fragment span
        self.spans: Optional[dict] = None
        #: per-output-symbol (lo, hi) value bounds of this task's result
        #: (the dynamic-filter summary the coordinator may collect)
        self.ranges: dict = {}
        self.done = threading.Event()
        #: task-local lifecycle handle: DELETE /v1/task/{id} cancels it, the
        #: descriptor deadline bounds it, and cooperative checks inside the
        #: execution abort through it
        self.lifecycle = QueryContext(
            desc.task_id, max_run_time_s=desc.deadline_s or 0.0
        )


class WorkerServer:
    """One worker process: accepts tasks, executes fragments, serves
    result buckets."""

    def __init__(
        self,
        catalogs=None,
        port: int = 0,
        host: str = "127.0.0.1",
        max_concurrent_tasks: Optional[int] = None,
        coordinator_url: Optional[str] = None,
        device=None,
    ):
        from trino_tpu_torch.config import get_config
        from trino_tpu_torch.connectors.api import default_catalogs
        from trino_tpu_torch.device import resolve_device

        #: the device this worker's fragments run on (the card by default)
        self.device = resolve_device(device)
        if max_concurrent_tasks is None:
            max_concurrent_tasks = get_config().worker.max_concurrent_tasks
        self.catalogs = catalogs or default_catalogs()
        self._tasks: dict[str, _Task] = {}
        #: TaskExecutor analog (reference: execution/executor/
        #: TaskExecutor.java): a bounded number of concurrently RUNNING
        #: tasks; excess submissions queue on the semaphore instead of
        #: oversubscribing the host
        self._slots = threading.Semaphore(max(1, max_concurrent_tasks))
        #: graceful-shutdown state (GracefulShutdownHandler role): ACTIVE
        #: serves everything; DRAINING finishes running tasks, refuses new
        #: submissions with 503 (REFUSED semantics on the client), then
        #: exits once idle.  `drained` is set when the last task finished.
        self.state = "ACTIVE"
        self._state_lock = threading.Lock()
        self.drained = threading.Event()
        #: injectable for tests (the drain-grace linger must not slow them)
        self._sleep = time.sleep
        #: injectable clock: the drain waiter's wait+grace bound and its
        #: force-kill escalation run deterministically in tier-1
        self._clock = time.monotonic
        #: coordinator to announce to at start (auto-rejoin); falls back to
        #: the `worker.coordinator-url` config knob
        self._coordinator_url = coordinator_url
        # global dictionary refs shipped in exchange pages resolve against
        # this worker's own catalogs first (generated catalogs re-derive
        # deterministically); anything else is pulled from the coordinator
        from trino_tpu_torch.runtime.dictionary_service import (
            DICTIONARY_SERVICE,
            coordinator_fetch_hook,
        )

        DICTIONARY_SERVICE.attach_catalogs(self.catalogs)
        coord = coordinator_url or get_config().worker.coordinator_url
        if coord:
            DICTIONARY_SERVICE.fetch_hook = coordinator_fetch_hook(coord)
        #: set once a register announce succeeded (test/ops evidence)
        self.registered = threading.Event()
        self._secret = cluster_secret()
        if host not in ("127.0.0.1", "localhost") and self._secret is None:
            raise ValueError(
                "non-loopback worker bind requires TRINO_TPU_CLUSTER_SECRET "
                "(task submissions are code-executing pickles)"
            )
        self._host = host
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _bytes(self, code: int, body: bytes, ctype="application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/v1/task":
                    return self._bytes(404, b"not found", "text/plain")
                if worker.lifecycle_state() != "ACTIVE":
                    # draining: refuse BEFORE reading/unpickling — the
                    # coordinator's submit maps 503 to REFUSED (skip this
                    # worker, never retry it) and re-plans without us
                    return self._bytes(503, b"DRAINING", "text/plain")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                secret = worker._secret
                if secret is not None:
                    sig = self.headers.get("X-Cluster-Auth", "")
                    if not _hmac.compare_digest(sig, sign_body(secret, body)):
                        # reject BEFORE unpickling: the codec executes code
                        return self._bytes(401, b"bad signature", "text/plain")
                desc = pickle.loads(body)
                try:
                    t = worker.submit(desc)
                except WorkerDraining:
                    # lost the race with begin_drain's state flip: same
                    # refusal as the fast path above
                    return self._bytes(503, b"DRAINING", "text/plain")
                self._bytes(200, t.desc.task_id.encode(), "text/plain")

            def do_PUT(self):
                if self.path != "/v1/worker/shutdown":
                    return self._bytes(404, b"not found", "text/plain")
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                secret = worker._secret
                if secret is not None:
                    # shutdown is as privileged as task submission: same
                    # HMAC gate (an unauthenticated PUT per worker would
                    # let any peer drain the whole cluster)
                    sig = self.headers.get("X-Cluster-Auth", "")
                    if not _hmac.compare_digest(sig, sign_body(secret, body)):
                        return self._bytes(401, b"bad signature", "text/plain")
                # graceful drain (GracefulShutdownHandler analog): answer
                # immediately; a background waiter finishes running tasks,
                # sets `drained`, and shuts the server down
                worker.begin_drain()
                self._bytes(200, b"DRAINING", "text/plain")

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if parts == ["v1", "info"]:
                    body = ('{"state": "%s"}' % worker.lifecycle_state()).encode()
                    self._bytes(200, body, "application/json")
                    return
                if parts == ["v1", "metrics"]:
                    # same Prometheus surface as the coordinator, so one
                    # scrape config covers both tiers
                    from trino_tpu_torch.telemetry import REGISTRY

                    self._bytes(
                        200,
                        REGISTRY.render_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    return
                if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                    t = worker.task(parts[2])
                    if t is None:
                        return self._bytes(404, b"no such task", "text/plain")
                    t.done.wait(timeout=status_wait_default())
                    body = (
                        t.state
                        if t.error is None
                        else f"{t.state}\n{t.error}"
                    ).encode()
                    return self._bytes(200, body, "text/plain")
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "task"]
                    and parts[3] == "spans"
                ):
                    # cross-host tracing pull: the finished task's span tree
                    # (Span.to_dict form, worker-local clock) for the
                    # coordinator to graft under its fragment span; null
                    # when the descriptor carried no trace context
                    t = worker.task(parts[2])
                    if t is None:
                        return self._bytes(404, b"no such task", "text/plain")
                    t.done.wait(timeout=_result_wait_s(t))
                    import json as _json

                    return self._bytes(
                        200, _json.dumps(t.spans).encode(), "application/json"
                    )
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "task"]
                    and parts[3] == "dynamic"
                ):
                    t = worker.task(parts[2])
                    if t is None:
                        return self._bytes(404, b"no such task", "text/plain")
                    t.done.wait(timeout=_result_wait_s(t))
                    import json as _json

                    return self._bytes(
                        200, _json.dumps(t.ranges).encode(), "application/json"
                    )
                if (
                    len(parts) == 5
                    and parts[:2] == ["v1", "task"]
                    and parts[3] == "results"
                ):
                    t = worker.task(parts[2])
                    if t is None:
                        return self._bytes(404, b"no such task", "text/plain")
                    t.done.wait(timeout=_result_wait_s(t))
                    if t.state != "FINISHED":
                        return self._bytes(
                            500, (t.error or "task failed").encode(), "text/plain"
                        )
                    bucket = int(parts[4])
                    return self._bytes(200, t.buckets[bucket])
                self._bytes(404, b"not found", "text/plain")

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                    t = worker.pop_task(parts[2])
                    if t is not None:
                        # REAL cancel: a running task aborts at its next
                        # cooperative check instead of burning the slot
                        t.lifecycle.cancel("task canceled by coordinator")
                self._bytes(200, b"ok", "text/plain")

        # the coordinator's listener: a backlog for bursts of pulls (with
        # socketserver's 5, as the JAX worker keeps, a burst resets some)
        from trino_tpu_torch.server.coordinator import HTTPServer

        self._httpd = HTTPServer((self._host, port), Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "WorkerServer":
        from trino_tpu_torch.config import get_config

        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="worker"
        )
        self._thread.start()
        # auto-rejoin (reference: DiscoveryNodeManager announcement): a
        # RESTARTED worker resurrects its membership entry by announcing
        # itself — no operator action.  Background + best-effort: a worker
        # must come up even while its coordinator is still restarting.
        coord = self._coordinator_url or get_config().worker.coordinator_url
        if coord:
            threading.Thread(
                target=self.announce, args=(coord,), daemon=True,
                name="worker-register",
            ).start()
        return self

    def announce(self, coordinator_url: str,
                 attempts: Optional[int] = None) -> bool:
        """PUT /v1/worker/register at the coordinator (HMAC'd when the
        cluster secret is set), with backed-off retries so a worker that
        restarts FASTER than its coordinator still rejoins."""
        from trino_tpu_torch.config import get_config
        from trino_tpu_torch.runtime.retry import Backoff

        cfg = get_config()
        body = self.url.encode()
        headers = {}
        if self._secret is not None:
            headers["X-Cluster-Auth"] = sign_body(self._secret, body)
        backoff = Backoff(
            base_s=cfg.remote.backoff_base_s, cap_s=cfg.remote.backoff_cap_s,
            sleep=self._sleep,
        )
        n = attempts if attempts is not None else cfg.remote.submit_attempts
        for attempt in range(max(1, n)):
            if attempt:
                backoff.wait(attempt - 1)
            req = urllib.request.Request(
                f"{coordinator_url}/v1/worker/register", data=body,
                headers=headers, method="PUT",
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=cfg.lifecycle.probe_timeout_s
                ) as r:
                    r.read()
            except Exception:
                continue
            self.registered.set()
            return True
        return False

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def begin_drain(self, exit_on_idle: bool = True) -> None:
        """Graceful shutdown (reference: GracefulShutdownHandler, SURVEY
        §5.3): flip to DRAINING (new submissions get 503/REFUSED), wait for
        running tasks to finish under ONE shared `worker.drain-task-wait`
        deadline, set `drained`, linger for `worker.drain-grace` seconds so
        downstream consumers can still PULL the finished tasks' results
        (task completion is not result delivery — the reference sleeps out
        a grace period for exactly this reason), then stop the HTTP server.

        Forced-kill escalation: tasks still running when the wait expires
        are canceled through their task-lifecycle tokens (they abort at
        their next cooperative check, with the grace window to honor it)
        and the server exits REGARDLESS — total drain time is bounded by
        wait + grace, so a wedged task can never wedge a drain.
        Idempotent — a second PUT while draining is a no-op."""
        with self._state_lock:
            if self.state != "ACTIVE":
                return
            self.state = "DRAINING"
            # snapshot under the same lock submit() admits under: every
            # task that slipped in before the flip is in it
            running = list(self._tasks.values())
        worker = self

        def waiter():
            from trino_tpu_torch.config import get_config
            from trino_tpu_torch.telemetry.metrics import drain_force_kills_counter

            cfg = get_config().worker
            deadline = worker._clock() + cfg.drain_task_wait_s
            for t in running:
                t.done.wait(timeout=max(0.0, deadline - worker._clock()))
            for t in running:
                if not t.done.is_set():
                    # the escalation: a cooperative task aborts inside the
                    # grace window; a truly wedged one is abandoned when
                    # the server exits below — either way the drain ends
                    t.lifecycle.cancel(
                        "drain force-kill: worker.drain-task-wait expired"
                    )
                    drain_force_kills_counter().inc()
            worker.drained.set()
            if exit_on_idle:
                self._sleep(cfg.drain_grace_s)
                try:
                    worker.shutdown()
                except Exception:
                    pass

        threading.Thread(target=waiter, daemon=True, name="drain").start()

    # -- task registry (locked accessors: the HTTP handler threads and the
    # drain waiter share _tasks with submit; every touch goes through
    # _state_lock so the drain snapshot can never race a handler mutation) --

    def task(self, task_id: str) -> Optional[_Task]:
        with self._state_lock:
            return self._tasks.get(task_id)

    def pop_task(self, task_id: str) -> Optional[_Task]:
        with self._state_lock:
            return self._tasks.pop(task_id, None)

    def lifecycle_state(self) -> str:
        """ACTIVE | DRAINING for /v1/info (the detector's probe surface)."""
        with self._state_lock:
            return self.state

    # -- task execution (SqlTaskExecution role) ------------------------------

    def submit(self, desc: TaskDescriptor) -> _Task:
        t = _Task(desc)
        # admission is atomic with the drain flip: a submission that read
        # ACTIVE before begin_drain either registers HERE (so the drain
        # waiter's snapshot sees it and waits for it) or observes DRAINING
        # and is refused — no task can slip past the waiter's snapshot
        with self._state_lock:
            if self.state != "ACTIVE":
                raise WorkerDraining(f"worker is {self.state}")
            self._tasks[desc.task_id] = t
        threading.Thread(
            target=self._run, args=(t,), daemon=True, name=desc.task_id
        ).start()
        return t

    def _run(self, t: _Task) -> None:
        from trino_tpu_torch.runtime.lifecycle import (
            QueryAbortedException,
            reset_current,
            set_current,
        )
        from trino_tpu_torch.telemetry import NULL_TRACER, SpanTracer

        self._slots.acquire()
        # publish the task's lifecycle handle in THIS worker thread: the
        # execution's cooperative checks and its input-pull HTTP timeouts
        # (request_timeout) derive from the task deadline
        token = set_current(t.lifecycle)
        # cross-host tracing: the descriptor's trace context makes this
        # task's spans part of the coordinator's query trace
        tc = t.desc.trace_context
        tracer = SpanTracer(query_id=tc[0]) if tc else NULL_TRACER
        try:
            with tracer.span(
                "task", task_id=t.desc.task_id, worker=self.url,
                coordinator_span=(tc[1] if tc else None),
            ) as sp:
                t.buckets, t.ranges = self._execute(t.desc, tracer=tracer, span=sp)
            t.state = "FINISHED"
        except QueryAbortedException as e:
            t.state = "CANCELED"
            t.error = str(e)
        except Exception:
            t.state = "FAILED"
            t.error = traceback.format_exc()
        finally:
            if tracer.enabled and tracer.root is not None:
                t.spans = tracer.root.to_dict()
            # a task aborted mid-wave must release its spill partitions
            # now, not when the abandoned wave generator is GC'd
            t.lifecycle.release_spills()
            reset_current(token)
            self._slots.release()
            t.done.set()

    def _execute(self, desc: TaskDescriptor, tracer=None, span=None) -> list:
        from trino_tpu_torch.columnar.batch import concat_batches
        from trino_tpu_torch.parallel.serde import (
            batches_to_bytes,
            bytes_to_batches,
            partition_batches,
        )
        from trino_tpu_torch.planner.fragmenter import RemoteSourceNode
        from trino_tpu_torch.runtime.local_planner import (
            LocalExecutionPlanner,
            PhysicalPlan,
        )
        from trino_tpu_torch.runtime.session import SessionProperties
        from trino_tpu_torch.telemetry import NULL_TRACER

        tracer = tracer if tracer is not None else NULL_TRACER
        catalogs = self.catalogs
        if desc.split_mod is not None:
            index, total = desc.split_mod
            catalogs = _FilteringCatalogs(self.catalogs, index, total)

        props = SessionProperties()
        for k, v in desc.properties.items():
            props.set(k, v)
        lp = LocalExecutionPlanner(
            catalogs, self.device, target_splits=props.get("target_splits"),
            properties=props,
        )
        # coordinator-delivered dynamic filters fuse into this fragment's
        # scans exactly like locally-registered build ranges
        for name, rng in (desc.dynamic_ranges or {}).items():
            lp.dynamic_filters[name] = tuple(rng)
        saved = lp.plan

        def hook(node):
            if isinstance(node, RemoteSourceNode):
                batches = []
                # input pulls are the task's DCN wait: a distinct span per
                # remote source so the merged cross-host timeline separates
                # exchange stall from fragment compute
                pulled = 0
                decode_s = 0.0
                with tracer.span(
                    "input_fetch", source_fragment=node.fragment_id
                ) as sp:
                    for url in desc.inputs.get(node.fragment_id, ()):
                        body = _http_get(url)
                        t0 = time.perf_counter()
                        host = bytes_to_batches(body)
                        decode_s += time.perf_counter() - t0
                        pulled += len(body)
                        # the wire yields CPU batches: the fragment reads
                        # them on this worker's device
                        batches.extend(b.to(self.device) for b in host)
                    if sp is not None:
                        sp.attrs.update(bytes=pulled, decode_s=decode_s)
                return PhysicalPlan(iter(batches), node.symbols)
            return saved(node)

        lp.plan = hook
        from trino_tpu_torch.runtime.lifecycle import check_current

        with tracer.span("execute_fragment", task_id=desc.task_id):
            out = lp.plan(desc.fragment_root)
            batches = []
            for b in out.stream:
                check_current()  # canceled/expired tasks abort between batches
                batches.append(b)
        clock = time.perf_counter
        d2h_s = partition_s = 0.0
        ranges = {}
        if not batches:
            n = desc.output_partitioning[1] if desc.output_partitioning else 1
            host_buckets = [[]] * n
        else:
            # the task's output leaves the card once
            t0 = clock()
            host = concat_batches(batches).to("cpu")
            d2h_s = clock() - t0
            if desc.collect_ranges:
                ranges = _result_ranges([host], desc.output_symbols)
            if desc.output_partitioning is None:
                host_buckets = [[host]]
            else:
                t0 = clock()
                channels, n = desc.output_partitioning
                host_buckets = partition_batches([host], channels, n)
                partition_s = clock() - t0
        t0 = clock()
        out = [batches_to_bytes(bs) for bs in host_buckets]
        if span is not None:
            span.attrs.update(
                output_bytes=sum(len(b) for b in out),
                d2h_s=d2h_s,
                partition_s=partition_s,
                encode_s=clock() - t0,
            )
        return out, ranges


def _result_ranges(batches, symbols) -> dict:
    """{symbol name: [lo, hi]} over 1-D numeric result columns of host
    batches (the dynamic-filter summary; dictionary/limb-plane/bool
    columns skipped)."""
    import numpy as np

    out: dict = {}
    for i, sym in enumerate(symbols):
        lo = hi = None
        for b in batches:
            c = b.columns[i]
            d = c.data.numpy()
            if d.ndim != 1 or c.dictionary is not None or d.dtype == np.bool_:
                lo = None
                break
            if not np.issubdtype(d.dtype, np.number):
                lo = None
                break
            live = b.mask().numpy()
            if c.valid is not None:
                live = live & c.valid.numpy()
            if not live.any():
                continue
            vals = d[live]
            blo, bhi = vals.min(), vals.max()
            lo = blo if lo is None else min(lo, blo)
            hi = bhi if hi is None else max(hi, bhi)
        if lo is not None and hi is not None:
            out[sym.name] = [int(lo), int(hi)] if np.issubdtype(
                type(lo), np.integer
            ) else [float(lo), float(hi)]
    return out


class _FilteringCatalogs:
    def __init__(self, inner, index: int, total: int):
        self._inner = inner
        self._index = index
        self._total = total

    def get(self, name: str):
        return _FilteringConnector(self._inner.get(name), self._index, self._total)

    def names(self):
        return self._inner.names()

    def register(self, name, connector):
        self._inner.register(name, connector)


def result_wait_default() -> float:
    """Long-poll bound on a task's result/dynamic endpoints when the
    descriptor carries no deadline (the typed config owns it:
    `worker.result-wait`)."""
    from trino_tpu_torch.config import get_config

    return get_config().worker.result_wait_s


def status_wait_default() -> float:
    """Short status long-poll (reference: the async task-status responses;
    typed config `worker.status-wait`)."""
    from trino_tpu_torch.config import get_config

    return get_config().worker.status_wait_s


def _result_wait_s(t: _Task) -> float:
    """Result long-poll bound: never wait on a task longer than its owning
    query has LEFT to live — the task lifecycle's remaining time, not the
    original budget (a late re-fetch after retries must not pin a server
    thread past the query's death)."""
    bound = result_wait_default()
    if t.desc.deadline_s is None:
        return bound
    rem = t.lifecycle.remaining_s()
    if rem is None:  # deadline_s <= 0: the owning query is out of time
        return 0.001
    return max(0.001, min(bound, rem))


def _http_get(url: str, timeout: Optional[float] = None) -> bytes:
    """Intra-cluster GET.  The timeout derives from the executing query's
    remaining run time (lifecycle.request_timeout) unless the caller passes
    an explicit bound — no HTTP call outlives its query."""
    from trino_tpu_torch.runtime.lifecycle import request_timeout
    from trino_tpu_torch.runtime.retry import FAILURE_INJECTOR

    # chaos hook for the pull data plane (result + input fetches).  Named
    # `fetch:` — NOT `http:` — so injection patterns don't accidentally
    # match the scheme inside every point's url suffix
    FAILURE_INJECTOR.maybe_fail(f"fetch:{url}")
    if timeout is None:
        timeout = request_timeout(result_wait_default())
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def main(argv=None):  # pragma: no cover - manual entry point
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument(
        "--host",
        default="127.0.0.1",
        help="bind address; non-loopback requires TRINO_TPU_CLUSTER_SECRET",
    )
    ap.add_argument(
        "--device", default=None,
        help="device the worker's fragments run on (default: the CUDA card)",
    )
    args = ap.parse_args(argv)
    from trino_tpu_torch.config import install_config, load_cluster_config
    from trino_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # no card: raise before anything starts
    # the process's knobs come from its environment (TRINO_TPU_<KEY>), e.g.
    # TRINO_TPU_WORKER_COORDINATOR_URL, which the dictionary refs resolve
    # through; the default config would never read them
    install_config(load_cluster_config())
    w = WorkerServer(port=args.port, host=args.host, device=device)
    print(f"worker listening on {w.url}", flush=True)
    w._httpd.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()

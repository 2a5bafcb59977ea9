"""Coordinator HTTP server.

Reference roles: dispatcher/QueuedStatementResource.java:157 (POST
/v1/statement), server/protocol/ExecutingStatementResource.java:73 (paged
GET), DispatchManager (query registry/lifecycle), QueryStateMachine states
QUEUED -> RUNNING -> FINISHED/FAILED (execution/QueryState.java:26-58).

Implementation: stdlib ThreadingHTTPServer; each query runs on a worker
thread against the shared LocalQueryRunner (execution itself fans out on the
device); results are paged back RESULT_PAGE_ROWS at a time via nextUri
tokens, and a client that stops following nextUri leaves the query to a
DELETE (cancel) or the finished-result GC, like the reference's token-acked
paging.

Port of trino_tpu/server/coordinator.py: a copy, with the package renamed.
With no `runner`, the server builds `LocalQueryRunner(device=device)`, so
`CoordinatorServer()` serves from the CUDA card and raises where there is
none unless `device="cpu"` is passed.  Statements run on their own
`statement-{id}` threads through the dispatcher's engine lanes; each lane's
kernels launch on that thread's current stream, and the device gate
(runtime/dispatcher.device_slice) orders the batch pulls.  The prewarm hooks
keep their `getattr(runner, "prewarm", None)` form: no port runner carries a
prewarm executor, and `prewarm.manifest-path` raises NotImplementedError
naming runtime/prewarm (its executor is not ported yet).  Given a
`MultiHostQueryRunner` (parallel/remote.py), `start()` starts its
heartbeat detector's probe loop and `shutdown()` stops it, and PUT
/v1/worker/register and /v1/worker/drain grow and drain its membership,
HMAC-checked under TRINO_TPU_CLUSTER_SECRET (401 "bad signature"
otherwise).  The mesh runner's detector has no loop to start: it is
checked before each query.  The listener's backlog is `HTTPServer.request_queue_size` (the JAX server
keeps socketserver's 5).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from trino_tpu_torch.server import protocol


class HTTPServer(ThreadingHTTPServer):
    """The threading HTTP server with a listen backlog for bursts of
    clients: with socketserver's default of 5, a client connecting beside
    seven others waits a SYN retry (about 1 s) and one beside fifteen
    others can be reset."""

    request_queue_size = 128

def result_page_rows() -> int:
    """Rows per paged statement response (typed config
    coordinator.result-page-rows; compiled-in default 4096)."""
    from trino_tpu_torch.config import get_config

    return get_config().coordinator.result_page_rows


def poll_wait_s() -> float:
    """Long-poll bound on statement/trace GETs (reference: the async
    responses; typed config coordinator.poll-wait)."""
    from trino_tpu_torch.config import get_config

    return get_config().coordinator.poll_wait_s


class _Query:
    def __init__(self, qid: str, sql: str):
        self.id = qid
        self.sql = sql
        self.state = "QUEUED"
        self.result = None
        self.error: Optional[dict] = None
        #: Chrome-trace/Perfetto JSON captured at completion (query_trace)
        self.trace: Optional[dict] = None
        self.done = threading.Event()
        self._lock = threading.Lock()
        #: runtime lifecycle handle, attached the moment the engine creates
        #: it (LocalQueryRunner._query_context_cb); DELETE resolves here
        self.lifecycle = None
        #: dispatcher admission ticket (runtime/dispatcher): DELETE on a
        #: still-queued query dequeues it here, without ever acquiring an
        #: admission slot or engine time
        self.ticket = None
        #: cancel arrived before execution started (cancel-while-queued)
        self.cancel_requested = False

    def cancel(self) -> None:
        """DELETE /v1/query/{id}: a REAL cancel — the running statement
        aborts at its next cooperative check and fans the cancel out to its
        remote tasks; a queued one dequeues before it starts."""
        with self._lock:
            self.cancel_requested = True
            ctx = self.lifecycle
            ticket = self.ticket
        if ticket is not None:
            ticket.cancel()
        if ctx is not None:
            ctx.cancel("canceled via DELETE /v1/query")

    def _attach(self, ctx) -> None:
        with self._lock:
            self.lifecycle = ctx
            pre = self.cancel_requested
        if pre:
            ctx.cancel("canceled via DELETE /v1/query")

    def _attach_ticket(self, ticket) -> None:
        with self._lock:
            self.ticket = ticket
            pre = self.cancel_requested
        if pre:
            ticket.cancel()

    def run(self, runner) -> None:
        from trino_tpu_torch.runtime.lifecycle import QueryCanceledException

        self.state = "RUNNING"
        runner._query_context_cb = self._attach
        try:
            self.result = runner.execute(self.sql)
            self.state = "FINISHED"
        except Exception as e:  # surface as protocol error object
            from trino_tpu_torch.runtime.events import classify_error

            self.state = (
                "CANCELED" if isinstance(e, QueryCanceledException) else "FAILED"
            )
            self.error = {
                "message": str(e),
                "errorName": type(e).__name__,
                "errorType": classify_error(e),
                "errorCode": getattr(e, "error_code", None),
                "stack": traceback.format_exc(),
            }
        finally:
            # execute can raise BEFORE consuming the one-shot callback
            # (parse/access-control errors): clear it so a later statement
            # never attaches ITS context to this dead query's cancel surface
            runner._query_context_cb = None
            # span trace of THIS query (GET /v1/query/{id}/trace): read
            # from the statement's OWN lifecycle context, so a neighboring
            # lane finishing first can never hand us its trace (the
            # pre-dispatcher code diffed the shared runner.last_trace,
            # which raced under concurrent lanes)
            with self._lock:
                ctx = self.lifecycle
            self.trace = getattr(ctx, "trace_json", None)
            self.done.set()

    def columns_json(self) -> list:
        r = self.result
        return [
            {"name": n, "type": (t.name if t is not None else "unknown")}
            for n, t in zip(r.column_names, r.types or [None] * len(r.column_names))
        ]


class CoordinatorServer:
    """serve() blocks; start()/shutdown() for embedded use (tests, CLI)."""

    def __init__(
        self,
        runner=None,
        host: str = "127.0.0.1",
        port: int = 8080,
        resource_groups=None,
        authenticator=None,
        access_control=None,
        dispatcher=None,
        device=None,
    ):
        from trino_tpu_torch.config import get_config
        from trino_tpu_torch.runtime.dispatcher import QueryDispatcher
        from trino_tpu_torch.runtime.resource_groups import ResourceGroupManager
        from trino_tpu_torch.runtime.runner import LocalQueryRunner

        self.runner = runner or LocalQueryRunner(device=device)
        if getattr(self.runner, "prewarm", None) is None and get_config(
        ).properties.get("prewarm.manifest-path"):
            # start() would attach an executor from the manifest
            raise NotImplementedError(
                "prewarm.manifest-path (runtime/prewarm, the prewarm "
                "executor): not ported yet"
            )
        #: optional PasswordAuthenticator (AuthenticationFilter role)
        self.authenticator = authenticator
        if access_control is not None:
            self.runner.access_control = access_control
        self.host = host
        self.port = port
        self._queries: dict[str, _Query] = {}
        self._qid = itertools.count(1)
        #: admission control (resource-group tree): the engine/device is the
        #: shared resource, hard_concurrency bounds concurrent executions
        #: (reference: InternalResourceGroupManager); group definitions load
        #: from `resource-groups.*` config properties when no manager is
        #: passed in
        if resource_groups is None:
            props = get_config().properties
            resource_groups = ResourceGroupManager.from_properties(props)
            if not any(
                k.startswith("resource-groups.global.") for k in props
            ):
                # unconfigured default: let the global group use every
                # engine lane (the pre-dispatcher default of 1 modeled the
                # old global engine lock, which is gone)
                resource_groups.default.config.hard_concurrency = max(
                    1, int(get_config().dispatcher.lanes)
                )
        self.resource_groups = resource_groups
        # query performance observatory: the profile archive must attach
        # BEFORE the dispatcher clones its engine lanes — lanes copy the
        # runner's store reference at clone time, so a start()-time attach
        # would leave lanes 1..N-1 storeless and silently skip archiving
        # (N-1)/N of served queries.  Idempotent no-op when
        # profile.archive-dir is unset or a store is already attached.
        from trino_tpu_torch.telemetry.profile_store import attach_profile_store

        attach_profile_store(self.runner)
        #: the concurrent dispatcher (runtime/dispatcher): replaces the old
        #: global engine lock — statements admit through weighted-fair
        #: resource groups onto engine lanes, overload sheds, queued time
        #: is bounded, and drain is graceful
        self.dispatcher = dispatcher or QueryDispatcher(
            self.runner, self.resource_groups
        )
        #: SQL surface: system.runtime.resource_groups reads live admission
        #: state through the runner binding
        self.runner.dispatcher = self.dispatcher
        self._httpd: Optional[HTTPServer] = None
        self.started_at = time.monotonic()
        #: True when start() launched the runner's heartbeat failure
        #: detector (so shutdown() knows to stop it: the coordinator owns
        #: the probe loop, callers do not opt in)
        self._detector_started = False

    # -- query lifecycle ------------------------------------------------------

    def submit(self, sql: str, user: Optional[str] = None) -> _Query:
        from trino_tpu_torch.runtime.dispatcher import (
            DispatcherStoppedError,
            QueryShedError,
        )
        from trino_tpu_torch.runtime.lifecycle import (
            QueryCanceledException,
            QueryQueuedTimeExceeded,
        )

        q = _Query(f"q_{next(self._qid)}", sql)
        self._queries[q.id] = q

        def fail(exc, name: str, etype: str, **extra) -> None:
            q.state = "FAILED"
            q.error = {
                "message": str(exc),
                "errorName": name,
                "errorType": etype,
                "errorCode": getattr(exc, "error_code", name),
                **extra,
            }
            q.done.set()

        def work():
            try:
                ticket = self.dispatcher.enqueue(user=user)
            except QueryShedError as e:
                fail(
                    e, "QUERY_QUEUE_FULL", "RESOURCE_ERROR",
                    retryable=True, retryAfterSeconds=e.retry_after_s,
                )
                return
            except DispatcherStoppedError as e:
                fail(e, "SERVER_SHUTTING_DOWN", "RESOURCE_ERROR")
                return
            ticket.on_force_kill = q.cancel
            q._attach_ticket(ticket)
            try:
                ticket.wait()
            except QueryCanceledException:
                # canceled while queued: never occupied the engine
                q.state = "CANCELED"
                q.error = {
                    "message": "canceled via DELETE /v1/query",
                    "errorName": "USER_CANCELED",
                    "errorType": "USER_ERROR",
                    "errorCode": "USER_CANCELED",
                }
                q.done.set()
                return
            except QueryQueuedTimeExceeded as e:
                fail(e, "EXCEEDED_QUEUED_TIME_LIMIT", "RESOURCE_ERROR")
                return
            except DispatcherStoppedError as e:
                fail(e, "SERVER_SHUTTING_DOWN", "RESOURCE_ERROR")
                return

            def run(lane_runner):
                # statement identity: a lane runs one statement at a time,
                # so the per-statement user is race-free
                lane_runner.user = user or "user"
                q.run(lane_runner)

            try:
                self.dispatcher.run_admitted(ticket, run)
            except QueryCanceledException:
                # cancel won the race against admission: slot handed back,
                # no engine time consumed
                q.state = "CANCELED"
                q.error = {
                    "message": "canceled via DELETE /v1/query",
                    "errorName": "USER_CANCELED",
                    "errorType": "USER_ERROR",
                    "errorCode": "USER_CANCELED",
                }
                q.done.set()
                return
            # successful SELECTs feed the prewarm replay set: the
            # manifest a restarted server replays IS the live workload
            pw = getattr(self.runner, "prewarm", None)
            if pw is not None and q.state == "FINISHED":
                pw.record(q.sql)

        threading.Thread(
            target=work, daemon=True, name=f"statement-{q.id}"
        ).start()
        return q

    def query(self, qid: str) -> Optional[_Query]:
        return self._queries.get(qid)

    # -- HTTP -----------------------------------------------------------------

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence default stderr noise
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                from trino_tpu_torch.server.security import AuthenticationError

                if self.path != "/v1/statement":
                    return self._send(404, {"error": {"message": "not found"}})
                try:
                    auth_user = self._authenticate()
                except AuthenticationError:
                    return
                user = auth_user or self.headers.get("X-Trino-User")
                # load shedding BEFORE the body is read (reference:
                # DispatchManager queue-full rejection): a full resource-
                # group queue answers 429 + Retry-After without touching
                # the statement text, so overload costs the coordinator a
                # header parse, not a body read + parse + thread
                shed_after = server.dispatcher.shed_probe(user)
                if shed_after is not None:
                    self.close_connection = True  # body intentionally unread
                    body = json.dumps(
                        {
                            "error": {
                                "message": (
                                    "resource group queue is full; retry "
                                    f"after {shed_after:.1f}s"
                                ),
                                "errorName": "QUERY_QUEUE_FULL",
                                "errorType": "RESOURCE_ERROR",
                                "errorCode": "QUERY_QUEUE_FULL",
                                "retryable": True,
                            }
                        }
                    ).encode()
                    self.send_response(429)
                    self.send_header(
                        "Retry-After", str(max(1, int(shed_after + 0.999)))
                    )
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                n = int(self.headers.get("Content-Length", 0))
                sql = self.rfile.read(n).decode()
                q = server.submit(sql, user=user)
                self._send(
                    200,
                    protocol.query_results(
                        q.id,
                        next_uri=f"/v1/statement/executing/{q.id}/0",
                        state=q.state,
                    ),
                )

            def _authenticate(self):
                """When an authenticator is configured, EVERY request needs
                credentials — result paging and the UI expose query text and
                data, not just statement submission."""
                if server.authenticator is None:
                    return None
                from trino_tpu_torch.server.security import AuthenticationError

                try:
                    return server.authenticator.authenticate_basic(
                        self.headers.get("Authorization")
                    )
                except AuthenticationError as e:
                    self._send(
                        401,
                        {
                            "error": {
                                "message": str(e),
                                "errorName": "AUTHENTICATION_FAILED",
                            }
                        },
                    )
                    raise

            def do_GET(self):
                from trino_tpu_torch.server.security import AuthenticationError

                try:
                    self._authenticate()
                except AuthenticationError:
                    return
                if self.path.startswith("/ui"):
                    from trino_tpu_torch.server.ui import handle_ui_get

                    out = handle_ui_get(server, self.path)
                    if out is not None:
                        status, ctype, body = out
                        self.send_response(status)
                        self.send_header("Content-Type", ctype)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                if self.path == "/v1/metrics":
                    # Prometheus text exposition (telemetry/metrics)
                    from trino_tpu_torch.telemetry import REGISTRY

                    body = REGISTRY.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # /v1/dictionary/{catalog}/{schema}/{table}/{column}
                # ?version=N — versioned global code assignment fetch
                # (runtime/dictionary_service): a worker holding a
                # `("ref", key, version)` wire dictionary it cannot resolve
                # locally pulls the exact recorded version from the
                # coordinator, never a "close enough" one
                if self.path.split("?", 1)[0].startswith("/v1/dictionary/"):
                    from urllib.parse import parse_qs, urlsplit

                    from trino_tpu_torch.runtime.dictionary_service import (
                        DICTIONARY_SERVICE,
                    )

                    u = urlsplit(self.path)
                    dparts = u.path.strip("/").split("/")
                    if len(dparts) != 6:
                        return self._send(
                            404, {"error": {"message": "not found"}}
                        )
                    key = tuple(dparts[2:6])
                    qs = parse_qs(u.query)
                    try:
                        version = int(qs.get("version", ["0"])[0])
                    except ValueError:
                        return self._send(
                            400, {"error": {"message": "bad version"}}
                        )
                    try:
                        entry = DICTIONARY_SERVICE.entry(key, version)
                    except KeyError:
                        return self._send(
                            404,
                            {
                                "error": {
                                    "message": "no such dictionary version"
                                }
                            },
                        )
                    from trino_tpu_torch.columnar.dictionary import (
                        UnorderedDictionary,
                    )

                    return self._send(
                        200,
                        {
                            "key": list(key),
                            "version": entry.version,
                            "values": list(entry.dictionary.values),
                            "ordered": not isinstance(
                                entry.dictionary, UnorderedDictionary
                            ),
                            "unique": entry.unique,
                        },
                    )
                parts = self.path.strip("/").split("/")
                # /v1/query/{id}/profile — the archived profile artifact
                # (telemetry/profile_store): accepts the coordinator's
                # q_N id (resolved to the engine query id through the
                # attached lifecycle) or an engine query_N / artifact key
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "query"]
                    and parts[3] == "profile"
                ):
                    store = getattr(server.runner, "profile_store", None)
                    if store is None:
                        return self._send(
                            404,
                            {
                                "error": {
                                    "message": "profile archive not "
                                    "configured (set profile.archive-dir "
                                    "or attach a ProfileStore)"
                                }
                            },
                        )
                    lookup = parts[2]
                    q = server.query(lookup)
                    if q is not None:
                        q.done.wait(timeout=poll_wait_s())
                        if not q.done.is_set():
                            # a KNOWN still-running query must answer
                            # "not yet" — falling through to the disk
                            # scan could serve a PREVIOUS incarnation's
                            # artifact under the same engine query_N id
                            return self._send(
                                404,
                                {
                                    "error": {
                                        "message": "no archived profile "
                                        "yet (query still running)"
                                    }
                                },
                            )
                        ctx = q.lifecycle
                        if ctx is not None:
                            lookup = ctx.query_id
                    art = store.get(lookup)
                    if art is None:
                        return self._send(
                            404,
                            {
                                "error": {
                                    "message": "no archived profile for "
                                    "this query (still running, or the "
                                    "artifact was pruned)"
                                }
                            },
                        )
                    return self._send(200, art)
                # /v1/query/{id}/decisions — the plan-decision ledger
                # (telemetry/decisions) out of the archived profile
                # artifact: what the planner chose, what it cost, and the
                # hindsight verdicts; same id resolution as /profile
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "query"]
                    and parts[3] == "decisions"
                ):
                    store = getattr(server.runner, "profile_store", None)
                    if store is None:
                        return self._send(
                            404,
                            {
                                "error": {
                                    "message": "profile archive not "
                                    "configured (set profile.archive-dir "
                                    "or attach a ProfileStore)"
                                }
                            },
                        )
                    lookup = parts[2]
                    q = server.query(lookup)
                    if q is not None:
                        q.done.wait(timeout=poll_wait_s())
                        if not q.done.is_set():
                            return self._send(
                                404,
                                {
                                    "error": {
                                        "message": "no decision ledger "
                                        "yet (query still running)"
                                    }
                                },
                            )
                        ctx = q.lifecycle
                        if ctx is not None:
                            lookup = ctx.query_id
                    art = store.get(lookup)
                    if art is None or art.get("decisions") is None:
                        return self._send(
                            404,
                            {
                                "error": {
                                    "message": "no decision ledger for "
                                    "this query (still running, or the "
                                    "artifact was pruned)"
                                }
                            },
                        )
                    return self._send(200, art["decisions"])
                # /v1/query/{id}/trace — Perfetto/Chrome-trace JSON
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "query"]
                    and parts[3] == "trace"
                ):
                    q = server.query(parts[2])
                    if q is None:
                        return self._send(
                            404, {"error": {"message": "no such query"}}
                        )
                    q.done.wait(timeout=poll_wait_s())
                    if q.trace is None:
                        return self._send(
                            404,
                            {
                                "error": {
                                    "message": "no trace for this query "
                                    "(still running, or query_trace off)"
                                }
                            },
                        )
                    return self._send(200, q.trace)
                # /v1/statement/executing/{id}/{token}
                if len(parts) != 5 or parts[:3] != ["v1", "statement", "executing"]:
                    return self._send(404, {"error": {"message": "not found"}})
                qid, token = parts[3], int(parts[4])
                q = server.query(qid)
                if q is None:
                    return self._send(404, {"error": {"message": "no such query"}})
                # long-poll like the reference's async responses
                q.done.wait(timeout=poll_wait_s())
                if q.state in ("FAILED", "CANCELED"):
                    return self._send(
                        200,
                        protocol.query_results(q.id, state=q.state, error=q.error),
                    )
                if not q.done.is_set():
                    return self._send(
                        200,
                        protocol.query_results(
                            q.id,
                            next_uri=f"/v1/statement/executing/{qid}/{token}",
                            state=q.state,
                        ),
                    )
                rows = q.result.rows
                page_sz = result_page_rows()
                page = rows[token * page_sz : (token + 1) * page_sz]
                has_more = (token + 1) * page_sz < len(rows)
                self._send(
                    200,
                    protocol.query_results(
                        q.id,
                        columns=q.columns_json(),
                        data=protocol.encode_rows(page),
                        next_uri=(
                            f"/v1/statement/executing/{qid}/{token + 1}"
                            if has_more
                            else None
                        ),
                        state="FINISHED",
                        stats={"rows": len(rows)},
                    ),
                )

            def do_PUT(self):
                from trino_tpu_torch.server.security import AuthenticationError

                try:
                    self._authenticate()
                except AuthenticationError:
                    return
                if self.path not in (
                    "/v1/worker/register", "/v1/worker/drain"
                ):
                    return self._send(
                        404, {"error": {"message": "not found"}}
                    )
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                # membership mutation is as privileged as task submission:
                # when the cluster secret is set, register/drain need the
                # intra-cluster HMAC (an unauthenticated PUT would let any
                # peer grow or shrink the mesh) — the same gate the
                # worker's own /v1/worker/shutdown enforces
                from trino_tpu_torch.server.worker import cluster_secret, sign_body

                secret = cluster_secret()
                if secret is not None:
                    import hmac as _hmac

                    sig = self.headers.get("X-Cluster-Auth", "")
                    if not _hmac.compare_digest(
                        sig, sign_body(secret, body)
                    ):
                        return self._send(
                            401, {"error": {"message": "bad signature"}}
                        )
                url = body.decode().strip()
                if self.path == "/v1/worker/register":
                    # the grow path (reference: DiscoveryNodeManager
                    # announcement): body = worker url; it joins the NEXT
                    # query's mesh, never a running one.  A restarted
                    # worker announces itself here (auto-rejoin).
                    add = getattr(server.runner, "add_worker", None)
                    if not url or add is None:
                        return self._send(
                            400,
                            {"error": {"message": "runner is not multi-host "
                                       "or no worker url given"}},
                        )
                    add(url)
                    return self._send(200, {"registered": url})
                # PUT /v1/worker/drain — graceful retirement: body = worker
                # url; the worker finishes running tasks, refuses new ones,
                # exits, and the next query's mesh excludes it
                drain = getattr(server.runner, "drain_worker", None)
                if not url or drain is None:
                    return self._send(
                        400,
                        {"error": {"message": "runner is not multi-host "
                                   "or no worker url given"}},
                    )
                drain(url)
                return self._send(200, {"draining": url})

            def do_DELETE(self):
                from trino_tpu_torch.server.security import AuthenticationError

                try:
                    self._authenticate()
                except AuthenticationError:
                    return
                parts = self.path.strip("/").split("/")
                # DELETE /v1/query/{id} — a REAL cancel (reference:
                # QueuedStatementResource cancel): the running statement
                # aborts at its next cooperative check, remote tasks get
                # their cancel fan-out, and the query shows CANCELED
                if len(parts) == 3 and parts[:2] == ["v1", "query"]:
                    q = server.query(parts[2])
                    if q is None:
                        return self._send(
                            404, {"error": {"message": "no such query"}}
                        )
                    q.cancel()
                    return self._send(204, {})
                if len(parts) >= 4 and parts[:3] == ["v1", "statement", "executing"]:
                    q = server._queries.pop(parts[3], None)
                    if q is not None:
                        q.cancel()  # abandoning the result cancels the query
                    return self._send(204, {})
                self._send(404, {"error": {"message": "not found"}})

        return Handler

    def start(self) -> None:
        self._httpd = HTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="coordinator-http",
        ).start()
        self._start_background()

    def _start_background(self) -> None:
        """Server-owned background services (started with the listener,
        stopped by shutdown()):

        * the runner's heartbeat failure detector probe loop: the server
          is the only process that should own it (only membership-backed detectors
          have a start/stop loop — the in-mesh detector refreshes at query
          start and needs none);
        * a prewarm executor the runner already carries (runtime/prewarm):
          replay its persisted workload manifest in the background so
          restart cost is paid before the first query, not by it."""
        det = getattr(self.runner, "failure_detector", None)
        if det is not None and callable(getattr(det, "start", None)) \
                and callable(getattr(det, "stop", None)):
            det.start()
            self._detector_started = True
        # the JSONL audit log attaches here when configured (idempotent
        # no-op without audit.log-path; the event pipeline is SHARED
        # across lanes, so unlike the profile store this can attach after
        # the dispatcher cloned them)
        from trino_tpu_torch.telemetry.audit import attach_audit_log

        attach_audit_log(self.runner)
        pw = getattr(self.runner, "prewarm", None)
        if pw is not None:
            # a pre-attached executor's replays admit through the
            # dispatcher's weight-capped system.prewarm resource group
            # (system_admission raises until prewarm is ported)
            pw.use_admission(self.dispatcher.system_admission)
            pw.run(reason="start")

    def shutdown(self) -> None:
        # graceful dispatcher drain FIRST: admission closes, queued
        # statements fail classified (SERVER_SHUTTING_DOWN), running ones
        # finish inside dispatcher.drain-wait or are force-killed through
        # their lifecycle tokens (the bounded force-kill contract)
        try:
            self.dispatcher.drain()
        except Exception:
            pass
        if self._detector_started:
            det = getattr(self.runner, "failure_detector", None)
            if det is not None:
                det.stop()
            self._detector_started = False
        pw = getattr(self.runner, "prewarm", None)
        if pw is not None:
            try:
                # the replay set observed this incarnation persists for the
                # next one (no-op without a manifest location / statements)
                pw.save()
            except Exception:
                pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None

    def serve(self) -> None:
        self._httpd = HTTPServer((self.host, self.port), self._handler())
        print(f"trino-tpu coordinator listening on {self.host}:{self.port}")
        self._start_background()
        self._httpd.serve_forever()

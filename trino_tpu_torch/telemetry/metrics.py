"""Process-wide metrics registry: counters, gauges, histograms.

Port of trino_tpu/telemetry/metrics.py (reference roles: the airlift
metrics the reference exports over JMX, rendered as Prometheus text).
`REGISTRY.counter/gauge/histogram(name, help, labelnames)` registers once
and returns the existing metric on re-registration, so callers bump
without caring who registered; `gauge_fn` registers a pull metric whose
callback runs at snapshot/render time (the step cache, the buffer pool
and the device gate surface that way).  Everything is a
host integer or float: bumping a metric never synchronizes with the
device.  `system.runtime.metrics` and `system.metrics.metrics` read
`REGISTRY.rows()`.

The engine vocabulary is the JAX package's, name for name.  The compile
series (`compile_seconds`, `compile_events_total`) read the compile
observatory (telemetry/compile_events: step-cache builds and kernel
builds/loads); task retries and spooling (`task_retries_total`,
`spooled_fragments_total`) count the mesh's fault-tolerant execution;
the profile archive and the audit log bump `profiles_archived_total`,
`profiles_pruned_total`, `audit_events_total` and
`audit_rotations_total`; the decision ledger bumps
`plan_decisions_total`; the circuit breakers of the multi-host HTTP tier
feed `breaker_trips_total` and `breaker_state` (runtime/retry.BREAKERS),
and cluster membership `membership_events_total` and `worker_alive`
(runtime/membership).  Prewarm is not ported yet, so nothing in the port
bumps `prewarm_runs_total`, `prewarm_statements_total` or
`prewarm_state`, which stay at their initial values.  The
trace-cache series read the port's step cache (parallel/spmd.TRACE_CACHE):
torch runs eagerly and traces nothing, so a miss builds a step closure
and `retraces` stays 0.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence

_PREFIX = "trino_tpu_"

#: default histogram buckets (seconds): query walls from sub-ms to minutes
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0,
)


#: guards per-metric series-dict RESIZE against concurrent scrapes: HTTP
#: handler threads render /v1/metrics while the query thread bumps.  Bumping
#: an EXISTING series never resizes its dict and stays lock-free (the hot
#: path); only first-touch inserts and the scrape-side copies take the lock.
_SERIES_LOCK = threading.Lock()


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _format_labels(labelnames: Sequence[str], labelvalues: Sequence) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


def _format_value(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


class _Child:
    """One (metric, label values) series."""

    __slots__ = ("metric", "labelvalues")

    def __init__(self, metric: "Metric", labelvalues: tuple):
        self.metric = metric
        self.labelvalues = labelvalues

    def inc(self, n=1) -> None:
        self.metric._inc(self.labelvalues, n)

    def set(self, v) -> None:
        self.metric._set(self.labelvalues, v)

    def observe(self, v) -> None:
        self.metric._observe(self.labelvalues, v)

    def value(self):
        return self.metric.value(self.labelvalues)


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: dict = {}  # labelvalues tuple -> number

    # -- label plumbing -------------------------------------------------------

    def labels(self, *values, **kv) -> _Child:
        if kv:
            values = tuple(kv[n] for n in self.labelnames)
        lv = tuple(str(v) for v in values)
        if len(lv) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {lv}"
            )
        return _Child(self, lv)

    # -- unlabeled shortcuts --------------------------------------------------

    def inc(self, n=1) -> None:
        self._inc((), n)

    def set(self, v) -> None:
        self._set((), v)

    def observe(self, v) -> None:
        self._observe((), v)

    def value(self, labelvalues: tuple = ()):
        return self._values.get(tuple(str(v) for v in labelvalues), 0)

    # -- storage (the engine runs one statement at a time, so bump-vs-bump
    # needs no lock; _SERIES_LOCK covers resize-vs-scrape only) ---------------

    def _inc(self, lv: tuple, n) -> None:
        try:
            self._values[lv] += n  # existing series: no resize, no lock
        except KeyError:
            with _SERIES_LOCK:
                self._values[lv] = self._values.get(lv, 0) + n

    def _set(self, lv: tuple, v) -> None:
        if lv in self._values:
            self._values[lv] = v  # overwrite: no resize, no lock
            return
        with _SERIES_LOCK:
            self._values[lv] = v

    def _observe(self, lv: tuple, v) -> None:
        raise TypeError(f"{self.kind} metric {self.name} has no observe()")

    def touch(self, *labelvalues) -> None:
        """Pre-register a series at 0 so it renders before the first bump
        ('registered once, bumped everywhere' — scrapes see the full
        vocabulary, not just counters that happened to fire)."""
        lv = tuple(str(v) for v in labelvalues)
        with _SERIES_LOCK:
            self._values.setdefault(lv, 0)

    # -- export ---------------------------------------------------------------

    def series(self) -> list:
        """[(suffix, labelnames, labelvalues, value)] for rendering."""
        with _SERIES_LOCK:
            items = list(self._values.items())
        return [("", self.labelnames, lv, v) for lv, v in sorted(items)]


class Counter(Metric):
    kind = "counter"

    def _set(self, lv, v):
        raise TypeError(f"counter {self.name} cannot be set(); use inc()")


class Gauge(Metric):
    kind = "gauge"


class CallbackGauge(Metric):
    """Pull-style metric: `fn` is evaluated at render/snapshot time and
    returns either a scalar (unlabeled) or {labelvalues tuple: value}.
    `kind_hint` lets a monotonically-increasing source render as a counter
    (TRACE_CACHE.hits is a counter even though we read it by callback)."""

    def __init__(self, name, help="", labelnames=(), fn: Callable = None,
                 kind_hint: str = "gauge"):
        super().__init__(name, help, labelnames)
        self.fn = fn
        self.kind = kind_hint

    def _inc(self, lv, n):
        raise TypeError(f"callback metric {self.name} is read-only")

    _set = _inc

    def series(self) -> list:
        try:
            out = self.fn()
        except Exception:
            return []
        if not isinstance(out, dict):
            return [("", self.labelnames, (), out)]
        return [
            ("", self.labelnames, tuple(str(x) for x in (lv if isinstance(lv, tuple) else (lv,))), v)
            for lv, v in sorted(out.items())
        ]

    def value(self, labelvalues: tuple = ()):
        for _, _, lv, v in self.series():
            if lv == tuple(str(x) for x in labelvalues):
                return v
        return 0


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.buckets = bs
        # labelvalues -> [counts per bucket, sum, count]
        self._obs: dict = {}

    def _observe(self, lv: tuple, v) -> None:
        st = self._obs.get(lv)
        if st is None:
            with _SERIES_LOCK:  # first observe for this series: dict insert
                st = self._obs.setdefault(
                    lv, [[0] * len(self.buckets), 0.0, 0]
                )
        counts, _, _ = st
        for i, b in enumerate(self.buckets):
            if v <= b:
                counts[i] += 1
                break
        st[1] += v
        st[2] += 1

    def _inc(self, lv, n):
        raise TypeError(f"histogram {self.name} has no inc(); use observe()")

    _set = _inc

    def value(self, labelvalues: tuple = ()):
        st = self._obs.get(tuple(str(v) for v in labelvalues))
        return 0 if st is None else st[2]

    def series(self) -> list:
        out = []
        with _SERIES_LOCK:
            items = list(self._obs.items())
        for lv, (counts, total, n) in sorted(items):
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                le = "+Inf" if math.isinf(b) else _format_value(float(b))
                out.append(
                    ("_bucket", self.labelnames + ("le",), lv + (le,), cum)
                )
            out.append(("_sum", self.labelnames, lv, total))
            out.append(("_count", self.labelnames, lv, n))
        return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: OrderedDict[str, Metric] = OrderedDict()
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, labelnames, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name} already registered as {m.kind}"
                    )
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def gauge_fn(self, name, help, fn, labelnames=(),
                 kind_hint: str = "gauge") -> CallbackGauge:
        return self._register(
            CallbackGauge, name, help, labelnames, fn=fn, kind_hint=kind_hint
        )

    def histogram(self, name, help="", labelnames=(), buckets=None) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """{metric name (+series suffix/labels): value}: the flat form a
        run records and diffs."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for suffix, lnames, lvalues, v in m.series():
                key = m.name + suffix + _format_labels(lnames, lvalues)
                out[key] = v
        return out

    def rows(self) -> list:
        """[(name, kind, labels, value)] — the system.metrics table feed."""
        out = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for suffix, lnames, lvalues, v in m.series():
                out.append(
                    (
                        m.name + suffix,
                        m.kind,
                        _format_labels(lnames, lvalues).strip("{}"),
                        float(v),
                    )
                )
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (served at GET /v1/metrics)."""
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for suffix, lnames, lvalues, v in m.series():
                lines.append(
                    m.name
                    + suffix
                    + _format_labels(lnames, lvalues)
                    + " "
                    + _format_value(v)
                )
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop all registered metrics (tests only)."""
        with self._lock:
            self._metrics.clear()
        _register_engine_metrics(self)


#: the process-wide registry (one engine process per host, like a worker JVM)
REGISTRY = MetricsRegistry()


# -- engine metric vocabulary -------------------------------------------------

#: MeshProfile counter names pre-registered so /v1/metrics exposes the full
#: vocabulary (exchange/speculation counters included) before any query runs;
#: names track verify/residency.ALLOWED_COUNTERS plus the violation counters
#: that must stay zero.
MESH_COUNTER_NAMES = (
    "host_restack",
    "host_gather",
    "result_gather",
    "state_gather",
    "scan_cache_hit",
    "scan_cache_miss",
    "scan_bucketize",
    "dynamic_filter_sync",
    "spool_read",
    "spool_write",
    "exchange_elided",
    "repartition_collective",
    "join_overflow_check",
    "join_capacity_sync",
    "join_speculative_retry",
    "join_capacity_proven",
    "collective_async",
    "memory_wave",
    "spill_bytes",
)


#: wave-capable operator vocabulary for trino_tpu_memory_waves_total,
#: pre-registered so the compare_bench zero-when-unconstrained gate reads
#: real zeros, not absent series
MEMORY_WAVE_OPERATORS = ("join", "aggregation", "window", "sort")


#: (kind, purpose) label pairs pre-registered on the per-collective byte
#: counter so scrapes see the attribution vocabulary before any query runs;
#: runner/exchange call sites bump through MeshProfile.add_collective.
COLLECTIVE_VOCABULARY = (
    ("all_to_all", "repartition"),
    ("all_gather", "broadcast"),
    ("reduce", "dynamic_filter"),
    ("gather", "capacity_sizing"),
    ("gather", "result_gather"),
    ("gather", "host_gather"),
)


#: decimal-sum kernel path vocabulary (ops/aggregation._sum128 + the
#: window frame sums), pre-registered so the zero-runtime-check gate in
#: tools/compare_bench.py reads real zeros, not absent series
DECIMAL_FASTPATHS = ("proven", "runtime_check", "limb")


#: join capacity-sizing outcome vocabulary (verify/capacity.py +
#: parallel/runner._sized_expansion): proven = a capacity certificate
#: licensed a fixed-capacity expand (no sizing gather, no overflow flag),
#: runtime_check = the speculative/sizing fallback ran its runtime
#: protocol.  Pre-registered so the compare_bench check_licenses gate
#: reads real zeros, not absent series.
JOIN_CAPACITY_OUTCOMES = ("proven", "runtime_check", "declined")


#: plan-decision vocabulary (telemetry/decisions.py), pre-registered on
#: BOTH exposition endpoints (coordinator and worker /v1/metrics render
#: the same process registry) so scrapes see the full (kind, outcome,
#: hindsight) grid at zero before the first statement decides anything.
#: `pending` counts recordings at decision time; the hindsight verdicts
#: count at finalize.
PLAN_DECISION_SERIES = (
    ("join_distribution", ("broadcast", "partitioned", "colocated")),
    ("join_capacity", ("licensed", "declined", "runtime_check")),
    ("dictionary_placement", ("coded_colocate",)),
    ("schedule_license", ("async", "sync")),
    ("wave", ("waves",)),
    ("exchange", ("repartition", "broadcast", "gather", "merge", "elide")),
    ("recovery", ("retry", "replan", "fail")),
)

PLAN_DECISION_HINDSIGHT = ("pending", "vindicated", "regret", "unmeasured")


#: membership transition vocabulary, pre-registered so scrapes see
#: join/drain/death at 0 before any transition fires
MEMBERSHIP_EVENT_KINDS = ("join", "drain", "death", "rejoin", "shrink_replan")


#: task-recovery classification vocabulary (the FTE retry-vs-replan-vs-
#: fail table in runtime/lifecycle), pre-registered so the chaos gate
#: reads real zeros for the outcomes that must NOT fire
TASK_RETRY_OUTCOMES = ("retry", "replan", "fail")


#: resource groups pre-registered on the serving metrics so scrapes see
#: the admission vocabulary before the first statement; the dispatcher
#: touches further groups at construction
DEFAULT_SERVE_GROUPS = ("global", "system.prewarm")


#: prewarm-run vocabulary, pre-registered so scrapes see every
#: (trigger, outcome) cell at 0 before the first replay fires
PREWARM_REASONS = ("start", "grow", "manual")
PREWARM_OUTCOMES = ("warm", "unclosed", "failed", "empty")

#: prewarm executor state -> trino_tpu_prewarm_state gauge code
PREWARM_STATE_CODES = {
    "IDLE": 0, "RUNNING": 1, "WARM": 2, "UNCLOSED": 3, "FAILED": 4,
}


#: device-gate histogram buckets (seconds): gate waits/holds are the
#: per-step time-slice granularity — sub-100µs uncontended, up to whole
#: fragment walls when a long build holds the gate against other lanes
GATE_SECONDS_BUCKETS = (
    0.00001, 0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def _compile_events_total():
    from trino_tpu_torch.telemetry.compile_events import OBSERVATORY

    return OBSERVATORY.count


def _trace_cache_series(stat: str):
    def read():
        from trino_tpu_torch.parallel.spmd import TRACE_CACHE

        return getattr(TRACE_CACHE, stat)

    return read


def _pool_series(stat_suffix: str):
    def read():
        from trino_tpu_torch.runtime.buffer_pool import POOL

        s = POOL.stats()
        return {
            ("host",): s[f"host_{stat_suffix}"],
            ("device",): s[f"device_{stat_suffix}"],
        }

    return read


def _register_engine_metrics(reg: MetricsRegistry) -> None:
    """Register the engine-wide vocabulary once (import time + reset)."""
    mesh = reg.counter(
        _PREFIX + "mesh_events_total",
        "mesh execution events by counter name (MeshProfile counters: "
        "transfers, cache hits, exchange elision, speculation)",
        labelnames=("counter",),
    )
    for name in MESH_COUNTER_NAMES:
        mesh.touch(name)
    completed = reg.counter(
        _PREFIX + "queries_total",
        "completed queries by state and error type",
        labelnames=("state", "error_type"),
    )
    completed.touch("FINISHED", "")
    completed.touch("FAILED", "USER_ERROR")
    completed.touch("FAILED", "INTERNAL_ERROR")
    completed.touch("FAILED", "RESOURCE_ERROR")
    completed.touch("CANCELED", "USER_ERROR")
    reg.histogram(
        _PREFIX + "query_wall_seconds",
        "end-to-end statement wall time",
    )
    reg.histogram(
        _PREFIX + "query_queued_seconds",
        "seconds a statement waited in its resource group's admission "
        "queue before an engine lane ran it (runtime/dispatcher); "
        "observed on admission, cancel, expiry, and shed",
    )
    queued = reg.gauge(
        _PREFIX + "queries_queued",
        "statements waiting in each resource group's admission queue",
        labelnames=("group",),
    )
    running = reg.gauge(
        _PREFIX + "queries_running",
        "statements running on engine lanes per resource group",
        labelnames=("group",),
    )
    shed = reg.counter(
        _PREFIX + "queries_shed_total",
        "statements shed because a resource group's queue was full "
        "(HTTP 429 + Retry-After before the body is read — a retryable "
        "client error, never a hang)",
        labelnames=("group",),
    )
    for g in DEFAULT_SERVE_GROUPS:
        queued.touch(g)
        running.touch(g)
        shed.touch(g)
    reg.counter(
        _PREFIX + "query_retraces_total",
        "SPMD retraces attributed to completed distributed queries "
        "(bumped per query by the stage executor; zero warm)",
    )
    reg.counter(
        _PREFIX + "memory_kills_total",
        "queries killed by the low-memory killer (largest reservation "
        "reclaimed when the shared pool blocks)",
    )
    waves = reg.counter(
        _PREFIX + "memory_waves_total",
        "partition waves executed under memory pressure, by operator "
        "(runtime/spill: an over-budget build/agg/window/sort degrades to "
        "k hash-partition waves instead of dying; zero when unconstrained)",
        labelnames=("operator",),
    )
    for op in MEMORY_WAVE_OPERATORS:
        waves.touch(op)
    reg.counter(
        _PREFIX + "spill_bytes_total",
        "bytes spilled host-side through the filesystem SPI by "
        "partition-wave execution (the FTE SpoolManager npz format; zero "
        "when unconstrained)",
    )
    reg.counter(
        _PREFIX + "memory_revocations_total",
        "memory revocations: a registered wave-capable operator asked to "
        "spill and release its reservation before the low-memory killer "
        "fires (the revoke tier of the exceed -> revoke -> wave -> kill "
        "escalation ladder)",
    )
    reg.counter(
        _PREFIX + "breaker_trips_total",
        "circuit-breaker transitions to OPEN on the multi-host HTTP tier",
    )
    reg.gauge_fn(
        _PREFIX + "breaker_state",
        "per-worker circuit breaker state (0 closed, 1 half-open, 2 open)",
        _breaker_series,
        labelnames=("worker",),
    )
    membership = reg.counter(
        _PREFIX + "membership_events_total",
        "cluster membership transitions by kind (runtime/membership: "
        "worker join/drain/death, rejoin after death, and mesh-shrink "
        "re-plans of running queries)",
        labelnames=("kind",),
    )
    for kind in MEMBERSHIP_EVENT_KINDS:
        membership.touch(kind)
    reg.gauge(
        _PREFIX + "worker_alive",
        "per-worker liveness from the heartbeat failure detector "
        "(1 = ACTIVE/DRAINING, 0 = DEAD)",
        labelnames=("worker",),
    )
    retries = reg.counter(
        _PREFIX + "task_retries_total",
        "task-level recovery classifications under fault-tolerant "
        "execution, by outcome (retry = same plan, lost tasks re-run from "
        "spooled intermediates; replan = mesh signature truly changed, "
        "re-fragment at the shrunk W; fail = user/semantic error, never "
        "retried)",
        labelnames=("outcome",),
    )
    for outcome in TASK_RETRY_OUTCOMES:
        retries.touch(outcome)
    reg.counter(
        _PREFIX + "spooled_fragments_total",
        "fragment outputs spooled through the filesystem SPI keyed by "
        "(query_id, fragment_id, attempt_id); zero when "
        "fault_tolerant_execution is off and retry_policy is not TASK",
    )
    prewarm = reg.counter(
        _PREFIX + "prewarm_runs_total",
        "prewarm-executor replays by trigger reason and outcome "
        "(runtime/prewarm: warm = closed key set, unclosed = the verify "
        "replay still compiled, failed = a statement raised)",
        labelnames=("reason", "outcome"),
    )
    for reason in PREWARM_REASONS:
        for outcome in PREWARM_OUTCOMES:
            prewarm.touch(reason, outcome)
    reg.counter(
        _PREFIX + "prewarm_statements_total",
        "statement executions performed by prewarm replays",
    )
    reg.gauge(
        _PREFIX + "prewarm_state",
        "prewarm executor state (0 idle, 1 running, 2 warm, 3 unclosed, "
        "4 failed)",
    )
    reg.counter(
        _PREFIX + "drain_force_kills_total",
        "tasks force-canceled because worker.drain-task-wait expired "
        "during a graceful drain (the bounded-drain escalation)",
    )
    # device-gate / lane contention telemetry (runtime/dispatcher
    # device_slice): wait is observed on CONTENDED acquires only, hold on
    # holds during which another lane waited — the uncontended single-lane
    # step stays one clock read (zero-cost-when-idle, the pressure-counter
    # contract), so an idle scrape sees both series present at 0
    reg.histogram(
        _PREFIX + "device_gate_wait_seconds",
        "seconds an engine lane waited to acquire the device time-slice "
        "gate (contended acquires only; uncontended steps never observe)",
        buckets=GATE_SECONDS_BUCKETS,
    )
    reg.histogram(
        _PREFIX + "device_gate_hold_seconds",
        "seconds the device gate was held while another lane waited "
        "(the contention-relevant holds; uncontended holds are not timed)",
        buckets=GATE_SECONDS_BUCKETS,
    )
    reg.gauge_fn(
        _PREFIX + "device_gate_occupied",
        "which engine lane currently holds the device time-slice gate "
        "(1 on the holding lane's series; empty when the gate is idle)",
        _gate_occupancy_series,
        labelnames=("lane",),
    )
    reg.gauge_fn(
        _PREFIX + "device_gate_waiters",
        "engine lanes currently blocked waiting for the device gate",
        _gate_waiters,
    )
    # query performance observatory (telemetry/profile_store +
    # telemetry/audit): pre-registered AND touched so scrapes see the
    # archive/audit vocabulary as real zeros before the first statement
    # completes (the project convention)
    reg.counter(
        _PREFIX + "profiles_archived_total",
        "per-query profile artifacts archived by the profile store "
        "(telemetry/profile_store; written through the filesystem SPI "
        "off the hot path after FINISHING)",
    ).touch()
    reg.counter(
        _PREFIX + "profiles_pruned_total",
        "archived profile artifacts deleted by the retention sweep "
        "(profile.retention-max-age / profile.retention-max-count)",
    ).touch()
    reg.counter(
        _PREFIX + "audit_events_total",
        "query-completion lines appended to the JSONL audit log "
        "(telemetry/audit.QueryAuditLog)",
    ).touch()
    reg.counter(
        _PREFIX + "audit_rotations_total",
        "audit-log size-based rotations (audit.rotate-bytes)",
    ).touch()
    reg.histogram(
        _PREFIX + "compile_seconds",
        "wall seconds per SPMD trace+XLA-compile (compile observatory "
        "events; see system.runtime.compilations)",
    )
    reg.gauge_fn(
        _PREFIX + "compile_events_total",
        "trace-cache misses recorded by the compile observatory "
        "(zero new events on warm replays)",
        _compile_events_total,
        kind_hint="counter",
    )
    fastpath = reg.counter(
        _PREFIX + "decimal_fastpath_total",
        "decimal-sum kernel path selections at TRACE time (ops/aggregation "
        "+ ops/window): proven = statically licensed single-plane i64 sum "
        "(range certificate or precision proof, no runtime check), "
        "runtime_check = a lax.cond fits probe was compiled in, limb = "
        "unconditional limb-plane arithmetic",
        labelnames=("path",),
    )
    for p in DECIMAL_FASTPATHS:
        fastpath.touch(p)
    joincap = reg.counter(
        _PREFIX + "join_capacity_total",
        "join expand-capacity decisions (parallel/runner._sized_expansion): "
        "proven = compiled at a capacity-certificate-licensed fixed "
        "capacity with ZERO runtime sizing (no gather, no overflow flag, "
        "no retry; verify/capacity.py), runtime_check = the speculative/"
        "sizing fallback ran its runtime protocol",
        labelnames=("outcome",),
    )
    for o in JOIN_CAPACITY_OUTCOMES:
        joincap.touch(o)
    decisions = reg.counter(
        _PREFIX + "plan_decisions_total",
        "plan-decision ledger entries (telemetry/decisions.py) by decision "
        "kind, chosen outcome, and hindsight verdict: pending counts at "
        "decision time; vindicated/regret/unmeasured count once the runner "
        "joins each decision with its measured outcome",
        labelnames=("kind", "outcome", "hindsight"),
    )
    for kind, outcomes in PLAN_DECISION_SERIES:
        for o in outcomes:
            for h in PLAN_DECISION_HINDSIGHT:
                decisions.touch(kind, o, h)
    reg.counter(
        _PREFIX + "collective_async_total",
        "independent child fragments pre-dispatched asynchronously under a "
        "collective-schedule license (verify/schedule.py): exchange "
        "dispatch overlapped the consumer fragment's host work",
    ).touch()
    collective = reg.counter(
        _PREFIX + "collective_bytes_total",
        "bytes moved by mesh collectives/gathers, by collective kind and "
        "purpose (the per-collective split of MeshProfile collective_bytes)",
        labelnames=("kind", "purpose"),
    )
    for kind, purpose in COLLECTIVE_VOCABULARY:
        collective.touch(kind, purpose)
    for stat, hint in (
        ("hits", "counter"),
        ("misses", "counter"),
        ("retraces", "counter"),
        ("evictions", "counter"),
    ):
        reg.gauge_fn(
            _PREFIX + f"trace_cache_{stat}_total",
            f"process-wide compiled-SPMD-program cache {stat}",
            _trace_cache_series(stat),
            kind_hint=hint,
        )
    reg.gauge_fn(
        _PREFIX + "trace_cache_entries",
        "live compiled programs in the trace cache",
        _trace_cache_entries,
    )
    for suffix, help_txt in (
        ("bytes", "buffer-pool resident bytes per tier"),
        ("hits", "buffer-pool hits per tier"),
        ("misses", "buffer-pool misses per tier"),
    ):
        reg.gauge_fn(
            _PREFIX + f"buffer_pool_{suffix}",
            help_txt,
            _pool_series(suffix),
            labelnames=("tier",),
            kind_hint="counter" if suffix != "bytes" else "gauge",
        )


def _trace_cache_entries():
    from trino_tpu_torch.parallel.spmd import TRACE_CACHE

    return TRACE_CACHE.stats()["entries"]


def _breaker_series():
    from trino_tpu_torch.runtime.retry import BREAKER_STATE_CODES, BREAKERS

    return {
        (worker,): BREAKER_STATE_CODES[state]
        for worker, state in BREAKERS.states().items()
    }


def _gate_occupancy_series():
    from trino_tpu_torch.runtime import dispatcher

    holder = dispatcher.gate_holder()
    return {} if holder < 0 else {(str(holder),): 1}


def _gate_waiters():
    from trino_tpu_torch.runtime import dispatcher

    return dispatcher.gate_waiters()


def mesh_events_counter() -> Counter:
    """The labeled mesh-event counter MeshProfile.bump mirrors into."""
    return REGISTRY.counter(_PREFIX + "mesh_events_total")


def decimal_fastpath_counter() -> Counter:
    """Trace-time decimal-sum path selections, labeled path=proven|
    runtime_check|limb.  Bumped when a kernel TRACES (path choice is
    static per compiled program): warm replays add nothing, so a warm run
    with runtime_check deltas == 0 proves the workload runs entirely on
    statically-licensed sums."""
    return REGISTRY.counter(_PREFIX + "decimal_fastpath_total")


def join_capacity_counter() -> Counter:
    """Join expand-capacity decisions, labeled outcome=proven|runtime_check.
    A warm licensed workload bumps ONLY proven — compare_bench
    check_licenses gates runtime_check == 0 over the benched warm runs."""
    return REGISTRY.counter(_PREFIX + "join_capacity_total")


def collective_async_counter() -> Counter:
    """Schedule-licensed asynchronous child-fragment pre-dispatches."""
    return REGISTRY.counter(_PREFIX + "collective_async_total")


def plan_decisions_counter() -> Counter:
    """Plan-decision ledger entries, labeled (kind, outcome, hindsight).
    compare_bench check_decisions gates regret == 0 over the warm benched
    set."""
    return REGISTRY.counter(_PREFIX + "plan_decisions_total")


def queries_counter() -> Counter:
    return REGISTRY.counter(_PREFIX + "queries_total")


def query_retraces_counter() -> Counter:
    return REGISTRY.counter(_PREFIX + "query_retraces_total")


def query_wall_histogram() -> Histogram:
    return REGISTRY.histogram(_PREFIX + "query_wall_seconds")


def query_queued_histogram() -> Histogram:
    """Admission-queue wait per statement (runtime/dispatcher)."""
    return REGISTRY.histogram(_PREFIX + "query_queued_seconds")


def queries_queued_gauge() -> Gauge:
    """Queued statements per resource group (dispatcher-maintained)."""
    return REGISTRY.gauge(_PREFIX + "queries_queued")


def queries_running_gauge() -> Gauge:
    """Running statements per resource group (dispatcher-maintained)."""
    return REGISTRY.gauge(_PREFIX + "queries_running")


def queries_shed_counter() -> Counter:
    """Statements shed on a full resource-group queue (HTTP 429)."""
    return REGISTRY.counter(_PREFIX + "queries_shed_total")


def memory_kills_counter() -> Counter:
    """Victims chosen by the LowMemoryKiller (runtime/lifecycle)."""
    return REGISTRY.counter(_PREFIX + "memory_kills_total")


def memory_waves_counter() -> Counter:
    """Partition waves executed under memory pressure, labeled by the
    wave-capable operator (runtime/spill)."""
    return REGISTRY.counter(_PREFIX + "memory_waves_total")


def spill_bytes_counter() -> Counter:
    """Bytes spilled through the filesystem SPI by partition-wave
    execution (runtime/spill SpillManager)."""
    return REGISTRY.counter(_PREFIX + "spill_bytes_total")


def memory_revocations_counter() -> Counter:
    """Revoke-tier activations: an operator spilled + released before the
    killer fired (runtime/spill MemoryEscalation)."""
    return REGISTRY.counter(_PREFIX + "memory_revocations_total")


def breaker_trips_counter() -> Counter:
    return REGISTRY.counter(_PREFIX + "breaker_trips_total")


def membership_events_counter() -> Counter:
    """Cluster membership transitions (runtime/membership)."""
    return REGISTRY.counter(_PREFIX + "membership_events_total")


def worker_alive_gauge() -> Gauge:
    """Per-worker liveness set by the heartbeat failure detector."""
    return REGISTRY.gauge(_PREFIX + "worker_alive")


def task_retries_counter() -> Counter:
    """Task-level recovery classifications (runtime FTE), labeled
    outcome=retry (same plan, lost tasks only) | replan (mesh signature
    truly changed: re-fragment at the shrunk W) | fail (user/semantic —
    never retried).  The chaos gate reads this: a retryable worker kill
    under fault_tolerant_execution must bump retry and leave replan/fail
    untouched."""
    return REGISTRY.counter(_PREFIX + "task_retries_total")


def spooled_fragments_counter() -> Counter:
    """Fragment outputs spooled through the filesystem SPI keyed by
    (query_id, fragment_id, attempt_id) — the replayable intermediates a
    recovery pass resumes from instead of re-running finished stages."""
    return REGISTRY.counter(_PREFIX + "spooled_fragments_total")


def compile_seconds_histogram() -> Histogram:
    """Per-event compile wall (bumped by the compile observatory)."""
    return REGISTRY.histogram(_PREFIX + "compile_seconds")


def collective_bytes_counter() -> Counter:
    """The labeled per-collective byte counter MeshProfile.add_collective
    mirrors into."""
    return REGISTRY.counter(_PREFIX + "collective_bytes_total")


def prewarm_runs_counter() -> Counter:
    """Prewarm replays by (reason, outcome) — runtime/prewarm."""
    return REGISTRY.counter(_PREFIX + "prewarm_runs_total")


def prewarm_statements_counter() -> Counter:
    return REGISTRY.counter(_PREFIX + "prewarm_statements_total")


def prewarm_state_gauge() -> Gauge:
    """Executor state as a code (PREWARM_STATE_CODES)."""
    return REGISTRY.gauge(_PREFIX + "prewarm_state")


def drain_force_kills_counter() -> Counter:
    """Tasks force-canceled by the bounded-drain escalation."""
    return REGISTRY.counter(_PREFIX + "drain_force_kills_total")


def gate_wait_histogram() -> Histogram:
    """Contended device-gate acquire waits (runtime/dispatcher)."""
    return REGISTRY.histogram(_PREFIX + "device_gate_wait_seconds")


def gate_hold_histogram() -> Histogram:
    """Device-gate holds during which another lane waited."""
    return REGISTRY.histogram(_PREFIX + "device_gate_hold_seconds")


def profiles_archived_counter() -> Counter:
    """Profile artifacts archived (telemetry/profile_store)."""
    return REGISTRY.counter(_PREFIX + "profiles_archived_total")


def profiles_pruned_counter() -> Counter:
    """Artifacts deleted by the retention sweep."""
    return REGISTRY.counter(_PREFIX + "profiles_pruned_total")


def audit_events_counter() -> Counter:
    """Lines appended to the JSONL audit log (telemetry/audit)."""
    return REGISTRY.counter(_PREFIX + "audit_events_total")


def audit_rotations_counter() -> Counter:
    """Audit-log size-based rotations."""
    return REGISTRY.counter(_PREFIX + "audit_rotations_total")


_register_engine_metrics(REGISTRY)

"""Unified query telemetry: span tracer + process-wide metrics registry.

Port of trino_tpu/telemetry/__init__.py.  Reference roles: the
OpenTelemetry Tracer the reference threads from dispatch through
exchange, QueryMonitor/QueryStatistics (the per-query stats payload event
listeners receive), and the JMX/airlift metrics beans rendered as
Prometheus text.

  * `spans` — per-query span trees (query -> analyze -> optimize ->
    fragment -> schedule -> per-fragment mesh launches), exportable as
    Chrome-trace/Perfetto JSON; zero-overhead NULL_TRACER when off.
  * `metrics` — counters/gauges/histograms registered once and bumped
    everywhere.
  * `compile_events` — the compile observatory: step-cache builds and
    kernel builds/loads as events (system.runtime.compilations).
  * `decisions` — the per-statement plan-decision ledger with hindsight
    verdicts (system.runtime.plan_decisions).
  * `profile_store` — the per-query profile archive
    (`profile.archive-dir`, system.runtime.query_profiles).
  * `audit` — the JSONL query audit log (`audit.log-path`).
"""

from trino_tpu_torch.telemetry.metrics import (
    REGISTRY,
    CallbackGauge,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from trino_tpu_torch.telemetry.spans import (
    NULL_TRACER,
    NullTracer,
    Span,
    SpanTracer,
    now,
)

__all__ = [
    "REGISTRY",
    "CallbackGauge",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "SpanTracer",
    "now",
]

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

The compile observatory, the decision ledger, the profile store and the
audit log of the JAX package's telemetry are not ported yet.
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

"""Process-wide metrics (port of trino_tpu/telemetry: the registry and the
memory-pressure counters; the span tracer and the other series are not
ported yet)."""

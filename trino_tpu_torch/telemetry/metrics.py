"""Process-wide metrics registry: the memory-pressure counters.

Port of part of trino_tpu/telemetry/metrics.py (reference roles: the
airlift metrics the reference exports over JMX, rendered as Prometheus
text).  `REGISTRY.counter(name, help, labelnames)` registers once and
returns the existing metric on re-registration, so callers bump without
caring who registered.  Everything is a host integer: bumping a metric
never synchronizes with the device.

Ported series: the four counters of the memory-pressure ladder
(runtime/spill.py, runtime/lifecycle.py).  Gauges, histograms, callback
gauges and the engine's other series are not ported yet.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Sequence

_PREFIX = "trino_tpu_"

#: guards a series dict's RESIZE against a concurrent scrape; bumping an
#: existing series never resizes its dict and stays lock-free
_SERIES_LOCK = threading.Lock()

#: wave-capable operator vocabulary of trino_tpu_memory_waves_total,
#: pre-registered so an unconstrained run reads real zeros
MEMORY_WAVE_OPERATORS = ("join", "aggregation", "window", "sort")


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


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: dict = {}  # labelvalues tuple -> number

    def labels(self, *values, **kv) -> _Child:
        if kv:
            values = tuple(kv[n] for n in self.labelnames)
        lv = tuple(str(v) for v in values)
        if len(lv) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {lv}"
            )
        return _Child(self, lv)

    def inc(self, n=1) -> None:
        self._inc((), n)

    def value(self, labelvalues: tuple = ()):
        return self._values.get(tuple(str(v) for v in labelvalues), 0)

    def _inc(self, lv: tuple, n) -> None:
        try:
            self._values[lv] += n  # existing series: no resize, no lock
        except KeyError:
            with _SERIES_LOCK:
                self._values[lv] = self._values.get(lv, 0) + n

    def touch(self, *labelvalues) -> None:
        """Pre-register a series at 0 so it renders before the first bump."""
        lv = tuple(str(v) for v in labelvalues)
        with _SERIES_LOCK:
            self._values.setdefault(lv, 0)

    def series(self) -> list:
        """[(labelnames, labelvalues, value)] for rendering."""
        with _SERIES_LOCK:
            items = list(self._values.items())
        return [(self.labelnames, lv, v) for lv, v in sorted(items)]


class Counter(Metric):
    kind = "counter"


class MetricsRegistry:
    def __init__(self):
        self._metrics: OrderedDict[str, Metric] = OrderedDict()
        self._lock = threading.Lock()

    def counter(self, name, help="", labelnames=()) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help, labelnames)
                self._metrics[name] = m
            return m

    def snapshot(self) -> dict:
        """{metric name + labels: value}, the flat form a run records."""
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            for lnames, lvalues, v in m.series():
                out[m.name + _format_labels(lnames, lvalues)] = v
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for lnames, lvalues, v in m.series():
                lines.append(
                    m.name + _format_labels(lnames, lvalues) + " " + _format_value(v)
                )
        return "\n".join(lines) + "\n"


def _register_engine_metrics(reg: MetricsRegistry) -> None:
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
        "partition-wave execution (zero when unconstrained)",
    )
    reg.counter(
        _PREFIX + "memory_revocations_total",
        "memory revocations: a registered wave-capable operator asked to "
        "spill and release its reservation before the low-memory killer "
        "fires",
    )


#: the process-wide registry
REGISTRY = MetricsRegistry()
_register_engine_metrics(REGISTRY)


def memory_kills_counter() -> Counter:
    """Victims chosen by the LowMemoryKiller (runtime/lifecycle)."""
    return REGISTRY.counter(_PREFIX + "memory_kills_total")


def memory_waves_counter() -> Counter:
    """Partition waves executed under memory pressure, labeled by the
    wave-capable operator (runtime/spill)."""
    return REGISTRY.counter(_PREFIX + "memory_waves_total")


def spill_bytes_counter() -> Counter:
    """Bytes spilled through the filesystem SPI (runtime/spill)."""
    return REGISTRY.counter(_PREFIX + "spill_bytes_total")


def memory_revocations_counter() -> Counter:
    """Revoke-tier activations: an operator spilled and released before
    the killer fired (runtime/spill MemoryEscalation)."""
    return REGISTRY.counter(_PREFIX + "memory_revocations_total")

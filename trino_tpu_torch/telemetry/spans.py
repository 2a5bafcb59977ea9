"""Structured span tracer: one tree of timed spans per query.

Reference roles: io.opentelemetry spans threaded through DispatchManager ->
SqlQueryExecution -> exchange (the reference wires a Tracer through every
layer and tags spans with QueryId/StageId), and the Chrome-trace JSON the
trace is exported as loads directly in Perfetto / chrome://tracing.

Design constraints:

  * zero overhead when off — the shared NULL_TRACER's `span()` returns one
    preallocated no-op context manager and `record()` is a pass; hot paths
    additionally guard on `tracer.enabled` before building attribute dicts;
  * no host syncs — spans time HOST wall only (`now()` below); device work
    is attributed exactly the way MeshProfile already attributes it (the
    phase of the launch that dispatched it), so enabling tracing cannot add
    transfers and `verify.device_residency` holds with tracing on;
  * spans nest by runtime containment: the tracer keeps an open-span stack,
    `span()` pushes/pops, `record()` appends an already-closed child to the
    innermost open span (the shape `parallel/runner.py::_call` needs — it
    knows the duration only after the launch returned).

Port of trino_tpu/telemetry/spans.py: a copy, with the package renamed.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Optional

#: THE phase-timing clock.  Every engine-side wall measurement (spans,
#: MeshProfile phases, stage self-time) reads this one callable so span and
#: profile timestamps are directly comparable; tools/lint_tpu.py flags raw
#: `time.perf_counter()` phase timing added to device code outside here.
now = time.perf_counter


class Span:
    """One timed node of the query trace tree."""

    __slots__ = ("span_id", "parent_id", "name", "start_s", "end_s",
                 "attrs", "children")

    def __init__(self, span_id: int, parent_id: int, name: str,
                 start_s: float, attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.attrs = attrs if attrs is not None else {}
        self.children: list[Span] = []

    def duration_s(self) -> float:
        end = self.end_s if self.end_s is not None else now()
        return max(0.0, end - self.start_s)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "duration_ms": round(self.duration_s() * 1e3, 3),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


class _OpenSpan:
    """Context manager returned by SpanTracer.span()."""

    __slots__ = ("tracer", "sp")

    def __init__(self, tracer: "SpanTracer", sp: Span):
        self.tracer = tracer
        self.sp = sp

    def __enter__(self) -> Span:
        return self.sp

    def __exit__(self, et, ev, tb) -> bool:
        self.sp.end_s = now()
        if et is not None:
            self.sp.attrs["error"] = et.__name__
        stack = self.tracer._stack
        if stack and stack[-1] is self.sp:
            stack.pop()
        return False


class _NullCtx:
    """Shared no-op context manager (the off-path of span())."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *a) -> bool:
        return False


_NULL_CTX = _NullCtx()


class SpanTracer:
    """Per-query span tree.  Not thread-safe: the engine serializes one
    statement at a time (the coordinator's engine lock), matching the
    reference's per-query trace context."""

    enabled = True

    def __init__(self, query_id: str = ""):
        self.query_id = query_id
        self.root: Optional[Span] = None
        self._stack: list[Span] = []
        self._ids = itertools.count(1)
        self.t0 = now()

    # -- recording ------------------------------------------------------------

    def span(self, name: str, **attrs) -> _OpenSpan:
        """Open a nested span; use as a context manager."""
        parent = self._stack[-1] if self._stack else None
        sp = Span(
            next(self._ids),
            parent.span_id if parent is not None else 0,
            name,
            now(),
            attrs,
        )
        if parent is not None:
            parent.children.append(sp)
        elif self.root is None:
            self.root = sp
        else:  # second top-level span: keep one tree, attach to the root
            sp.parent_id = self.root.span_id
            self.root.children.append(sp)
        self._stack.append(sp)
        return _OpenSpan(self, sp)

    def record(self, name: str, start_s: float, end_s: float,
               attrs: Optional[dict] = None) -> Optional[Span]:
        """Append an already-measured leaf span under the innermost open
        span (launch sites know their duration only after the fact).
        Returns the span so the caller can attach() children to it (compile
        stalls nest under their launch)."""
        parent = self._stack[-1] if self._stack else self.root
        sp = Span(
            next(self._ids),
            parent.span_id if parent is not None else 0,
            name,
            start_s,
            attrs,
        )
        sp.end_s = end_s
        if parent is not None:
            parent.children.append(sp)
        elif self.root is None:
            self.root = sp
        return sp

    def attach(self, parent: Span, name: str, start_s: float, end_s: float,
               attrs: Optional[dict] = None) -> Span:
        """Graft an already-closed span under an explicit parent (compile
        child spans of a launch; worker span trees merged under the
        coordinator's fragment span by the multi-host scheduler)."""
        sp = Span(next(self._ids), parent.span_id, name, start_s, attrs)
        sp.end_s = end_s
        parent.children.append(sp)
        return sp

    def graft(self, parent: Span, tree: dict, offset_s: float = 0.0) -> Span:
        """Merge a foreign span tree (Span.to_dict form — e.g. a worker
        task's spans pulled over HTTP) under `parent`, re-issuing span ids
        from THIS tracer so the merged trace has one id space.  `offset_s`
        shifts the foreign clock onto ours: worker `now()` readings are
        per-process perf counters with unrelated epochs, so the caller
        anchors the foreign root at a locally-observed instant (task
        submission) and every descendant keeps its relative position."""
        start = float(tree["start_s"]) + offset_s
        sp = self.attach(
            parent, tree["name"], start,
            start + float(tree.get("duration_ms", 0.0)) / 1e3,
            dict(tree.get("attrs") or {}),
        )
        for child in tree.get("children", ()):
            self.graft(sp, child, offset_s)
        return sp

    # -- export ---------------------------------------------------------------

    def _walk(self):
        def rec(sp):
            yield sp
            for c in sp.children:
                yield from rec(c)

        if self.root is not None:
            yield from rec(self.root)

    def flat_spans(self) -> list:
        """Depth-first flattened spans as plain dicts (the
        system.runtime.spans feed)."""
        out = []
        for sp in self._walk():
            out.append(
                {
                    "query_id": self.query_id,
                    "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "name": sp.name,
                    "start_ms": round((sp.start_s - self.t0) * 1e3, 3),
                    "duration_ms": round(sp.duration_s() * 1e3, 3),
                    "attributes": json.dumps(sp.attrs, default=str)
                    if sp.attrs
                    else "",
                }
            )
        return out

    def to_chrome_trace(self) -> dict:
        """Chrome-trace JSON (the 'traceEvents' array form): loads in
        Perfetto (ui.perfetto.dev) and chrome://tracing.  Complete ('X')
        events; ts/dur in microseconds relative to query admission."""
        events = []
        for sp in self._walk():
            events.append(
                {
                    "ph": "X",
                    "name": sp.name,
                    "cat": "query",
                    "ts": round((sp.start_s - self.t0) * 1e6, 1),
                    "dur": round(sp.duration_s() * 1e6, 1),
                    "pid": 1,
                    "tid": 1,
                    "args": {k: str(v) for k, v in sp.attrs.items()},
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"query_id": self.query_id},
        }

    def render_text(self) -> str:
        """Indented span tree (the EXPLAIN ANALYZE VERBOSE rendering)."""
        lines = [f"Query trace (spans, query_id={self.query_id}):"]

        def rec(sp: Span, depth: int) -> None:
            attrs = ""
            if sp.attrs:
                attrs = " " + " ".join(
                    f"{k}={v}" for k, v in sp.attrs.items()
                )
            lines.append(
                "  " * (depth + 1)
                + f"{sp.name} {sp.duration_s() * 1e3:.2f}ms{attrs}"
            )
            for c in sp.children:
                rec(c, depth + 1)

        if self.root is not None:
            rec(self.root, 0)
        return "\n".join(lines)


class NullTracer:
    """The off state: every operation is a no-op; `span()` hands back one
    shared context manager so the off-path allocates nothing."""

    enabled = False
    query_id = ""
    root = None

    def span(self, name: str, **attrs) -> _NullCtx:
        return _NULL_CTX

    def record(self, name, start_s, end_s, attrs=None) -> None:
        pass

    def attach(self, parent, name, start_s, end_s, attrs=None) -> None:
        pass

    def graft(self, parent, tree, offset_s=0.0) -> None:
        pass

    def flat_spans(self) -> list:
        return []

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def render_text(self) -> str:
        return "Query trace: tracing disabled (SET SESSION query_trace = true)"


#: the shared off-tracer (identity-comparable: `tracer is NULL_TRACER`)
NULL_TRACER = NullTracer()

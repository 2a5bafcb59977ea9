"""Compile observatory: every step-cache miss and kernel build as a
structured event.

Port of trino_tpu/telemetry/compile_events.py.  The JAX package's compile
event is an XLA trace + compile, opened by a trace-cache miss and closed
by the launch that paid for it.  A torch step is not compiled, so the
port's events are the two costs a cold process pays that a warm one does
not:

  * **a step-cache miss** (`step` = the step's label, "chain", "locate",
    "fused_expand", ...): `parallel/spmd.TraceCache.get` opens the event
    with the build's seconds; the step's next launch closes it
    (`close_open`, from the stage executor's `_call` or, outside a
    statement, the step's launcher) and its wall is the build plus that
    first launch, with the launch's shape bucket and fragment;
  * **a kernel build or load** (`step` = "kernel:<name>"):
    `kernels/build.py` records one closed event per nvcc run (its
    seconds) and one per library load (the `dlopen` seconds).

A warm replay records ZERO new events — an assertable fact, not an
assumption.  `OBSERVATORY` keeps the recent events (the
`system.runtime.compilations` window) and the deduplicated manifest of
(step, bucket, mesh) keys with their seconds
(`LocalQueryRunner.compile_manifest()`).  Everything here is host-side
bookkeeping on the miss path only: a cache hit never touches the lock.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional

from trino_tpu_torch.runtime.lifecycle import current_query
from trino_tpu_torch.telemetry.spans import now

#: recent-event ring size (the system.runtime.compilations window)
RING_LIMIT = 512
#: distinct compile keys the manifest tracks before evicting oldest
MANIFEST_LIMIT = 4096


def key_fingerprint(key) -> str:
    """Stable short fingerprint of a trace-cache key (manifest identity)."""
    return hashlib.blake2s(repr(key).encode()).hexdigest()[:16]


def _parse_key(key) -> tuple:
    """(step label, mesh signature) best-effort from a step-cache key.

    `cached_spmd_step` keys are ("spmd", collective, mesh_key, <caller
    key...>) where the caller key leads with a string tag ("chain",
    "fused_expand", "locate", ...) — the step label of the event."""
    step: str = "?"
    mesh: tuple = ()
    rest = key if isinstance(key, tuple) else (key,)
    if len(rest) >= 3 and rest[0] == "spmd":
        if isinstance(rest[2], tuple):
            mesh = rest[2]
        rest = rest[3:]
    for el in rest:
        if isinstance(el, str):
            step = el
            break
    return step, mesh


@dataclass
class CompileEvent:
    """One step-cache miss or kernel build/load this process paid for."""

    seq: int
    step: str
    key_fp: str
    #: truncated repr of the full cache key (debug/manifest readability)
    key: str
    #: mesh signature the program was compiled for (workers, device ids)
    mesh: tuple
    #: trailing row capacity of the launch's first stacked batch (the pow2
    #: shape bucket); None until the launch site closes the event (and for
    #: kernel events)
    bucket: Optional[int] = None
    query_id: str = ""
    fragment: Optional[int] = None
    #: wall seconds (attributed at close): the step's build plus its first
    #: launch, or the kernel's nvcc / load seconds
    wall_s: float = 0.0
    #: telemetry.now() timestamp of the miss
    at_s: float = 0.0
    closed: bool = False
    #: seconds the step cache spent building the step (open events)
    build_s: float = 0.0


class CompileObservatory:
    """Process-wide compile-event ring + manifest (see module doc).

    Protocol: `open_miss(key)` on every step-cache miss and `built(ev, s)`
    once the step is built; the next launch closes ALL open events with
    `close_open(dt, ...)` — a statement dispatches one launch at a time,
    so every open event belongs to the imminent launch (the miss fires
    when the step is BUILT, which precedes its launch).  A close with no
    open event synthesizes a `retrace` event (kept from the JAX package's
    protocol; the port's launch sites close only when `has_open()`).
    `record_kernel` books a kernel build or load, closed at once."""

    def __init__(self, ring_limit: int = RING_LIMIT,
                 manifest_limit: int = MANIFEST_LIMIT):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring_limit)
        #: events awaiting wall attribution by their launch site
        self._open: list = []
        #: key_fp -> manifest entry (insertion-ordered for bounded eviction)
        self._manifest: OrderedDict = OrderedDict()
        self._manifest_limit = manifest_limit
        #: events ever opened (monotonic — the warm-replay-zero assertion)
        self.count = 0
        #: total attributed compile wall seconds (monotonic)
        self.total_wall_s = 0.0

    # -- recording ------------------------------------------------------------

    def mark(self) -> int:
        """Watermark for close_since (the current event count)."""
        with self._lock:
            return self.count

    def has_open(self) -> bool:
        """Whether a built step awaits its first launch (the launch sites'
        cheap check: a warm launch reads one list length)."""
        return bool(self._open)  # lint: allow(unguarded-state)

    def open_miss(self, key) -> CompileEvent:
        """Record a step-cache miss (called by TraceCache.get)."""
        step, mesh = _parse_key(key)
        ctx = current_query()
        ev = CompileEvent(
            seq=0,
            step=step,
            key_fp=key_fingerprint(key),
            key=repr(key)[:240],
            mesh=mesh,
            query_id=ctx.query_id if ctx is not None else "",
            at_s=now(),
        )
        with self._lock:
            self.count += 1
            ev.seq = self.count
            self._ring.append(ev)
            self._open.append(ev)
            self._note_open(ev)
        return ev

    def built(self, ev: CompileEvent, seconds: float) -> None:
        """Record the seconds the step cache spent building `ev`'s step."""
        with self._lock:
            ev.build_s = float(seconds)

    def record_kernel(self, name: str, seconds: float, what: str) -> CompileEvent:
        """Book one kernel build (`what` = "nvcc") or library load
        ("load") as a closed `kernel:<name>` event."""
        from trino_tpu_torch.telemetry.metrics import compile_seconds_histogram

        ctx = current_query()
        key = ("kernel", name, what)
        ev = CompileEvent(
            seq=0,
            step=f"kernel:{name}",
            key_fp=key_fingerprint(key),
            key=f"{what} {name}",
            mesh=(),
            query_id=ctx.query_id if ctx is not None else "",
            wall_s=float(seconds),
            at_s=now(),
            closed=True,
        )
        with self._lock:
            self.count += 1
            ev.seq = self.count
            self._ring.append(ev)
            self._note_open(ev)
            self.total_wall_s += ev.wall_s
            self._note_close(ev)
        compile_seconds_histogram().observe(ev.wall_s)
        return ev

    def abort(self, ev: CompileEvent) -> None:
        """Withdraw an open event whose build raised (nothing was built):
        remove it from the pending set so the next launch doesn't
        inherit its attribution.  The ring keeps the row (wall 0.0,
        closed=False) — the attempt is part of the record."""
        with self._lock:
            if ev in self._open:
                self._open.remove(ev)

    def close_open(self, wall_s: float, bucket: Optional[int] = None,
                   fragment: Optional[int] = None, mesh: tuple = ()) -> list:
        """Attribute `wall_s` (one launch's seconds) to every open event,
        in equal shares on top of each event's own build seconds; returns
        them.  Synthesizes a `retrace` event when none is open."""
        with self._lock:
            events, self._open = self._open, []
            if not events:
                ctx = current_query()
                self.count += 1
                ev = CompileEvent(
                    seq=self.count,
                    step="retrace",
                    key_fp="",
                    key="",
                    mesh=mesh,
                    query_id=ctx.query_id if ctx is not None else "",
                    at_s=now(),
                )
                self._ring.append(ev)
                self._note_open(ev)
                events = [ev]
            share = wall_s / len(events)
            for ev in events:
                ev.wall_s = ev.build_s + share
                ev.closed = True
                if ev.bucket is None:
                    ev.bucket = bucket
                if ev.fragment is None:
                    ev.fragment = fragment
                self.total_wall_s += ev.wall_s
                self._note_close(ev)
        from trino_tpu_torch.telemetry.metrics import compile_seconds_histogram

        hist = compile_seconds_histogram()
        for ev in events:
            hist.observe(ev.wall_s)
        return events

    # -- manifest (the deduplicated key set) ----------------------------------

    def _note_open(self, ev: CompileEvent) -> None:  # lint: allow(unguarded-state)
        # caller holds self._lock (open_miss / close_open)
        fp = ev.key_fp or f"retrace:{ev.step}"
        entry = self._manifest.get(fp)
        if entry is None:
            entry = self._manifest[fp] = {
                "key_fp": fp,
                "step": ev.step,
                "mesh": str(ev.mesh),
                "key": ev.key,
                "buckets": set(),
                "count": 0,
                "compile_s": 0.0,
            }
            while len(self._manifest) > self._manifest_limit:
                self._manifest.popitem(last=False)
        entry["count"] += 1

    def _note_close(self, ev: CompileEvent) -> None:  # lint: allow(unguarded-state)
        # caller holds self._lock (close_open)
        fp = ev.key_fp or f"retrace:{ev.step}"
        entry = self._manifest.get(fp)
        if entry is None:  # evicted under manifest pressure
            return
        entry["compile_s"] += ev.wall_s
        if ev.bucket is not None:
            entry["buckets"].add(int(ev.bucket))

    def manifest(self) -> list:
        """The deduplicated compile-key set this process has needed, most
        expensive first: [{key_fp, step, mesh, key, buckets, count,
        compile_s}] (the enumeration a prewarm pass would replay)."""
        with self._lock:
            entries = [
                dict(e, buckets=sorted(e["buckets"]),
                     compile_s=round(e["compile_s"], 4))
                for e in self._manifest.values()
            ]
        return sorted(entries, key=lambda e: (-e["compile_s"], e["step"]))

    # -- export ---------------------------------------------------------------

    def events(self) -> list:
        """Recent events, oldest first (the ring window)."""
        with self._lock:
            return list(self._ring)

    def events_above(self, watermark: int) -> list:
        """Events recorded after a `mark()` watermark (closure forensics:
        a warm replay that still builds names the leaking steps instead of
        just counting them).  Bounded by the ring window — the
        COUNT above the watermark is always `count - watermark` even when
        the ring has rotated past some of the events."""
        with self._lock:
            return [e for e in self._ring if e.seq > watermark]

    def rows(self) -> list:
        """system.runtime.compilations feed: (seq, step, bucket, mesh,
        query_id, fragment, wall_s, key_fp, key) per recent event."""
        return [
            (
                e.seq, e.step, e.bucket, str(e.mesh), e.query_id,
                e.fragment, round(e.wall_s, 6), e.key_fp, e.key,
            )
            for e in self.events()
        ]

    def clear(self) -> None:
        """Drop all recorded state (tests only)."""
        with self._lock:
            self._ring.clear()
            self._open = []
            self._manifest.clear()
            self.count = 0
            self.total_wall_s = 0.0


#: the process-wide observatory (one engine process per host)
OBSERVATORY = CompileObservatory()

"""Per-operator and per-fragment statistics (EXPLAIN ANALYZE backing).

Port of trino_tpu/runtime/query_stats.py.  Reference roles:
operator/OperatorStats.java + the plan printer's per-node stats, and
StageStats for the mesh.  The local execution planner wraps every node's
batch stream in `StatsCollector.instrument`, which counts rows and
batches and splits each pull's time into the host's wall and the wait for
the batch's device work.  On the mesh, `MeshProfile` holds one
`FragmentStats` per stage: its self wall and its phases (`trace` = step
builds in the port's step cache, `compute`, `collective`, `transfer`,
`other` = the remainder, so the phases always sum to the wall), the bytes
each stage moved, and the query's event counters, mirrored into the
metrics registry.  A blocking profile (EXPLAIN ANALYZE) waits on the
device inside each phase window, which serializes the pipeline: its
phase times measure a serialized run.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from trino_tpu_torch.telemetry import NULL_TRACER, now
from trino_tpu_torch.telemetry.decisions import observe_collective
from trino_tpu_torch.telemetry.metrics import (
    collective_bytes_counter,
    mesh_events_counter,
)


#: collective kinds that move bytes across the mesh interconnect — only
#: these bump the aggregate collective_bytes (pre-existing semantics:
#: all_to_all repartitions + all_gather broadcasts, now plus the psum
#: dynamic-filter reduce); "gather" attributions are host pulls
COLLECTIVE_KINDS = ("all_to_all", "all_gather", "reduce")

#: phase vocabulary of the mesh fragment profile (order = render order)
MESH_PHASES = ("trace", "compute", "collective", "transfer", "other")


@dataclass
class FragmentStats:
    """Per-fragment, per-phase breakdown of one distributed stage
    (reference role: StageStats / the per-stage rollup of OperatorStats).

    wall_s is the stage's SELF time (child-stage walls excluded); phases
    always sum to wall_s because `other` absorbs the untracked remainder,
    so `sum(phases) == wall` is an invariant, not an approximation."""

    fragment_id: int
    kind: str = ""
    wall_s: float = 0.0
    phases: dict = field(default_factory=lambda: {p: 0.0 for p in MESH_PHASES})
    #: bytes moved by this stage, by direction/kind
    bytes_to_device: int = 0
    bytes_to_host: int = 0
    collective_bytes: int = 0
    #: per-collective attribution: (kind, purpose) -> bytes.  Entries whose
    #: kind is a mesh collective (COLLECTIVE_KINDS) also land in
    #: collective_bytes, so the collective breakdown sums to the aggregate
    #: by construction (the Q3 "collective/expand bound" claim as a
    #: measured per-collective split, not one undifferentiated number).
    #: "gather" entries are host-side pulls — attributed here for the
    #: purpose split but NOT in collective_bytes (full-batch gathers are
    #: already counted in bytes_to_host; tiny capacity syncs never were).
    collective_by: dict = field(default_factory=dict)
    #: issue-ordered (kind, purpose) sequence of this stage's mesh
    #: collectives (COLLECTIVE_KINDS only) — the observed half of the
    #: collective-uniformity contract: verify.device_residency compares it
    #: against the statically recorded signature (verify/collectives.py)
    collective_seq: list = field(default_factory=list)

    def close(self) -> None:
        tracked = sum(v for k, v in self.phases.items() if k != "other")
        self.phases["other"] = max(0.0, self.wall_s - tracked)

    def line(self) -> str:
        ph = " ".join(
            f"{k}={self.phases.get(k, 0.0) * 1e3:.1f}ms" for k in MESH_PHASES
        )
        by = ""
        if self.collective_by:
            by = " " + " ".join(
                f"{k}/{p}={b}"
                for (k, p), b in sorted(self.collective_by.items())
            )
        return (
            f"Fragment {self.fragment_id} [{self.kind}] "
            f"wall={self.wall_s * 1e3:.1f}ms {ph} "
            f"bytes(to_device={self.bytes_to_device} "
            f"to_host={self.bytes_to_host} "
            f"collective={self.collective_bytes}{by})"
        )

    def to_json(self) -> dict:
        return {
            "fragment": self.fragment_id,
            "kind": self.kind,
            "wall_s": round(self.wall_s, 4),
            "phases_ms": {
                k: round(v * 1e3, 2) for k, v in self.phases.items()
            },
            "bytes_to_device": self.bytes_to_device,
            "bytes_to_host": self.bytes_to_host,
            "collective_bytes": self.collective_bytes,
            "collective_bytes_by": {
                f"{k}/{p}": b
                for (k, p), b in sorted(self.collective_by.items())
            },
        }


class MeshProfile:
    """Per-query mesh execution profile: one FragmentStats per distributed
    stage plus query-wide transfer/trace counters.  `blocking=True` (EXPLAIN
    ANALYZE / bench) blocks on device results inside each phase so the
    breakdown measures device time, not dispatch time — measurement mode
    only, it serializes the async pipeline."""

    def __init__(self, blocking: bool = False, tracer=NULL_TRACER,
                 device=None):
        self.blocking = blocking
        #: the mesh's torch device: a blocking profile waits on it inside
        #: each phase window (`wait`)
        self.device = torch.device("cpu") if device is None else torch.device(device)
        #: per-query span tracer (telemetry.spans): launch/transfer phases
        #: recorded here are also emitted as child spans of the enclosing
        #: fragment span; NULL_TRACER when tracing is off
        self.tracer = tracer
        self.fragments: dict[int, FragmentStats] = {}
        #: query-wide event counters: host_gather (device->host exchanges),
        #: host_restack (host->device re-stacks BETWEEN fragments — zero on
        #: the device-resident path), scan_cache_hit/miss
        self.counters: dict[str, int] = {}
        self.trace_hits = 0
        self.trace_misses = 0
        self.retraces = 0

    def fragment(self, fid: int) -> FragmentStats:
        st = self.fragments.get(fid)
        if st is None:
            st = self.fragments[fid] = FragmentStats(fid)
        return st

    def bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n
        # single-home mirror: every mesh event also lands in the process
        # metrics registry (served at /v1/metrics), labeled by counter name
        mesh_events_counter().labels(counter).inc(n)

    def add_collective(self, fid: int, nbytes: int, kind: str,
                       purpose: str) -> None:
        """Attribute collective/gather traffic: bumps the fragment's
        (kind, purpose) breakdown and the labeled
        trino_tpu_collective_bytes_total series, and — for mesh-collective
        kinds only — the aggregate collective_bytes.  ONE path, so the
        collective entries always sum to the aggregate, and host-side
        gathers (already in bytes_to_host) never inflate it."""
        st = self.fragment(fid)
        if kind in COLLECTIVE_KINDS:
            st.collective_bytes += nbytes
            st.collective_seq.append((kind, purpose))
        key = (kind, purpose)
        st.collective_by[key] = st.collective_by.get(key, 0) + nbytes
        collective_bytes_counter().labels(kind, purpose).inc(nbytes)
        # decision-ledger attribution (telemetry/decisions): the same
        # bytes, credited to the planner choice whose scope is active —
        # host-side bookkeeping on an int the profile already holds
        observe_collective(fid, nbytes, kind, purpose)

    def collective_sequences(self) -> dict:
        """{fragment id: ((kind, purpose), ...)} of mesh collectives in
        issue order (the shape signature_problems compares)."""
        return {
            fid: tuple(st.collective_seq)
            for fid, st in self.fragments.items()
            if st.collective_seq
        }

    def wait(self) -> None:
        """Blocking mode: wait for the device's queued work, so the phase
        window that calls this measures device time.  The CPU queues
        nothing, so there it returns at once."""
        if self.blocking and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, fid: int, name: str):
        """Time a phase of fragment `fid` (caller blocks inside the window
        when self.blocking, so the phase measures device time)."""
        t0 = now()
        try:
            yield
            self.wait()
        finally:
            t1 = now()
            self.add_phase(fid, name, t1 - t0)
            if self.tracer.enabled:
                self.tracer.record(name, t0, t1, {"fragment": fid})

    def add_phase(self, fid: int, name: str, seconds: float) -> None:
        st = self.fragment(fid)
        st.phases[name] = st.phases.get(name, 0.0) + seconds

    def collective_totals(self) -> dict:
        """Query-wide (kind, purpose) -> bytes summed over fragments."""
        totals: dict = {}
        for st in self.fragments.values():
            for key, b in st.collective_by.items():
                totals[key] = totals.get(key, 0) + b
        return totals

    def phase_totals(self) -> dict:
        """Query-wide per-phase seconds summed over fragments (the
        QueryStatistics payload event listeners receive)."""
        totals: dict[str, float] = {}
        for st in self.fragments.values():
            for k, v in st.phases.items():
                totals[k] = totals.get(k, 0.0) + v
        return {k: round(v, 6) for k, v in totals.items()}

    def render(self) -> str:
        lines = [
            "Mesh execution profile (per-fragment; wall = stage self time):"
        ]
        for fid in sorted(self.fragments):
            lines.append("  " + self.fragments[fid].line())
        lines.append(
            "  trace cache: "
            f"hits={self.trace_hits} misses={self.trace_misses} "
            f"retraces={self.retraces}"
        )
        if self.counters:
            lines.append(
                "  transfers: "
                + " ".join(
                    f"{k}={v}" for k, v in sorted(self.counters.items())
                )
            )
        coll = self.collective_totals()
        if coll:
            lines.append(
                "  collective bytes: "
                + " ".join(
                    f"{k}/{p}={b}" for (k, p), b in sorted(coll.items())
                )
            )
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "fragments": [
                self.fragments[fid].to_json()
                for fid in sorted(self.fragments)
            ],
            "trace_cache": {
                "hits": self.trace_hits,
                "misses": self.trace_misses,
                "retraces": self.retraces,
            },
            "counters": dict(self.counters),
            "collective_bytes_by": {
                f"{k}/{p}": b
                for (k, p), b in sorted(self.collective_totals().items())
            },
        }


@dataclass
class OperatorStats:
    node_id: int
    name: str
    detail: str = ""
    output_rows: int = 0
    output_batches: int = 0
    wall_s: float = 0.0  # inclusive of upstream dispatch
    device_s: float = 0.0  # blocked-on-device time for THIS op's outputs
    depth: int = 0

    def line(self) -> str:
        pad = "  " * self.depth
        return (
            f"{pad}{self.name}[{self.detail}] rows={self.output_rows} "
            f"batches={self.output_batches} wall={self.wall_s * 1e3:.1f}ms "
            f"device={self.device_s * 1e3:.1f}ms"
        )


class StatsCollector:
    def __init__(self):
        self.operators: list[OperatorStats] = []
        self._next_id = 0
        #: per-query MemoryContext set by the execution planner so peak
        #: reservations render with the stats
        self.memory = None
        #: MeshProfile attached by the distributed runner so EXPLAIN ANALYZE
        #: renders the per-fragment breakdown
        self.mesh_profile = None
        #: local-execution pressure counters (memory_wave / spill_bytes),
        #: bumped by runtime/spill's PressureObserver so EXPLAIN ANALYZE
        #: shows the degradation a constrained query took
        self.counters: dict = {}

    def bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def register(self, name: str, detail: str = "", depth: int = 0) -> OperatorStats:
        st = OperatorStats(self._next_id, name, detail, depth=depth)
        self._next_id += 1
        self.operators.append(st)
        return st

    def instrument(self, st: OperatorStats, stream):
        """Wrap a batch stream, recording rows/batches/wall per pull."""

        def gen():
            it = iter(stream)
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    st.wall_s += time.perf_counter() - t0
                    return
                t1 = time.perf_counter()
                st.wall_s += t1 - t0
                # wait for THIS op's device work so the host-feed vs
                # device-compute split is attributed per operator (the
                # CPU has nothing queued)
                if b.device.type == "cuda":
                    torch.cuda.synchronize(b.device)
                st.device_s += time.perf_counter() - t1
                st.output_batches += 1
                st.output_rows += b.num_rows_host()
                yield b

        return gen()

    def render(self) -> str:
        # operators register in post-order (children first); reverse gives a
        # root-first rendering like the reference plan printer
        lines = [
            "Query execution statistics (wall = inclusive of subtree; "
            "device = blocked-on-device per op):"
        ]
        if self.mesh_profile is not None:
            lines.append(self.mesh_profile.render())
        for st in reversed(self.operators):
            lines.append(st.line())
        total_dev = sum(st.device_s for st in self.operators)
        lines.append(f"total device-blocked: {total_dev * 1e3:.1f}ms")
        if self.counters:
            lines.append(
                "memory pressure: "
                + " ".join(
                    f"{k}={v}" for k, v in sorted(self.counters.items())
                )
            )
        if self.memory is not None:
            lines.append(
                f"peak device memory reserved: {self.memory.peak} bytes"
            )
            from trino_tpu_torch.runtime.buffer_pool import POOL

            s = POOL.stats()
            lines.append(
                "buffer pool: "
                f"device={s['device_bytes']}B hits={s['device_hits']} "
                f"misses={s['device_misses']}; host={s['host_bytes']}B"
            )
        return "\n".join(lines)

"""Per-operator statistics for EXPLAIN ANALYZE (reference role:
operator/OperatorStats.java + the plan printer's per-node stats).

Port of the OperatorStats and StatsCollector of
trino_tpu/runtime/query_stats.py.  The local execution planner wraps every
node's batch stream in `StatsCollector.instrument`, which counts rows and
batches and splits each pull's time into the host's wall and the wait for
the batch's device work.  The mesh's per-fragment profile (MeshProfile) is
not ported: a mesh EXPLAIN ANALYZE raises NotImplementedError naming it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


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

"""Query lifecycle: the memory-pool part.

Port of the memory half of trino_tpu/runtime/lifecycle.py (reference
roles: memory/LowMemoryKiller.java + TotalReservationLowMemoryKiller, pick
the query with the largest reservation when the pool blocks, and the
per-statement QueryContext that owns a statement's memory contexts and
spill stores).  One `QueryContext` per statement, created by
`LocalQueryRunner.execute` and published through a contextvar, so the
planners reserve on the shared process pool and a spill store registers
with the statement that owns it.  At statement end, success or failure,
the runner closes the statement's spill stores and releases its memory.

The rest of the query lifecycle (the state machine, deadlines,
cancellation of remote tasks, resource-group sub-pools) is not ported
yet.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Optional


class QueryKilledException(RuntimeError):
    """Chosen as the low-memory killer's victim (CLUSTER_OUT_OF_MEMORY)."""


class QueryContext:
    """Per-statement handle: the kill token, the statement's query-level
    memory contexts on the shared pool, and its live spill stores."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self._lock = threading.Lock()
        self._killed = threading.Event()
        self.kill_reason: Optional[str] = None
        self.kill_detail: Optional[str] = None
        #: query-level MemoryContexts reserved on the shared pool; released
        #: when the statement finishes (success or failure)
        self._memory: list = []
        #: live SpillManagers (runtime/spill registers them): a statement
        #: that ends mid-wave deletes its spill partitions at once, not
        #: when the abandoned wave generator is collected
        self._spills: list = []
        #: the largest peak reservation among the statement's query-level
        #: memory contexts, set when they are released
        self.peak_memory = 0

    # -- kill token -----------------------------------------------------------

    def kill(self, reason: str, detail: Optional[str] = None) -> None:
        """Arm the token; the query aborts at its next check.  The first
        reason wins."""
        with self._lock:
            if self.kill_reason is None:
                self.kill_reason = reason
                self.kill_detail = detail
        self._killed.set()

    def check(self) -> None:
        """Cooperative abort point: raises once the killer chose this
        query."""
        if self._killed.is_set():
            with self._lock:
                reason, detail = self.kill_reason, self.kill_detail
            raise QueryKilledException(
                f"query {self.query_id} {detail or reason}"
            )

    # -- memory ---------------------------------------------------------------

    def attach_memory(self, ctx) -> None:
        with self._lock:
            self._memory.append(ctx)

    def release_memory(self) -> None:
        with self._lock:
            mem, self._memory = self._memory, []
        for m in mem:
            self.peak_memory = max(self.peak_memory, m.peak)
            m.force_release()

    # -- spill ----------------------------------------------------------------

    def register_spill(self, spiller) -> None:
        """Track a live SpillManager so statement end deletes its
        partitions."""
        with self._lock:
            self._spills.append(spiller)

    def unregister_spill(self, spiller) -> None:
        with self._lock:
            if spiller in self._spills:
                self._spills.remove(spiller)

    def release_spills(self) -> None:
        """Close every still-open SpillManager.  Close is idempotent, so a
        wave loop's own finally running later is harmless."""
        with self._lock:
            spills, self._spills = self._spills, []
        for s in spills:
            s.close()


# -- current-query contextvar -------------------------------------------------

_CURRENT: "contextvars.ContextVar[Optional[QueryContext]]" = (
    contextvars.ContextVar("trino_tpu_torch_current_query", default=None)
)


def current_query() -> Optional[QueryContext]:
    return _CURRENT.get()


def set_current(ctx: Optional[QueryContext]):
    """Install `ctx` as the executing query; returns the reset token."""
    return _CURRENT.set(ctx)


def reset_current(token) -> None:
    _CURRENT.reset(token)


def register_spill(spiller) -> None:
    """Attach a SpillManager to the executing statement (no-op without
    one): its partitions are released at statement end even when the wave
    generator that owns it is abandoned mid-stream."""
    ctx = _CURRENT.get()
    if ctx is not None:
        ctx.register_spill(spiller)


# -- low-memory killer --------------------------------------------------------


class LowMemoryKiller:
    """TotalReservationLowMemoryKiller analog: when a reservation would
    exceed the shared pool, kill the query holding the LARGEST reservation
    (never the requesting one while another holds more), reclaim its
    accounting, and let the blocked reservation retry."""

    def __call__(self, pool_root, requesting, delta: int) -> bool:
        """MemoryContext on_exceeded hook: True = freed something, retry;
        False = raise to the requester."""
        req_query = requesting.query_root()
        candidates = [q for q in pool_root.query_children if q.reserved > 0]
        if not candidates:
            return False
        victim = max(candidates, key=lambda q: q.reserved)
        if victim is req_query:
            # the requester holds the largest reservation: failing its
            # reservation IS the kill (never shoot a smaller bystander)
            return False
        from trino_tpu_torch.telemetry.metrics import memory_kills_counter

        memory_kills_counter().inc()
        if victim.owner is not None:
            victim.owner.kill(
                "memory",
                detail=(
                    f"killed by the low-memory killer: largest reservation "
                    f"({victim.reserved} bytes) when "
                    f"{requesting.name} requested {delta} more"
                ),
            )
        victim.force_release()
        return True


#: the process-wide memory pool every statement reserves on (reference:
#: MemoryPool.java's GENERAL pool); unlimited until set_memory_pool_limit
_GLOBAL_POOL = None
_POOL_LOCK = threading.Lock()


def memory_pool():
    """The process memory pool with the escalation hook installed: the
    revoke tier (runtime/spill.MemoryEscalation: the largest registered
    wave-capable operator spills and releases) runs first, the low-memory
    killer stays the last resort."""
    global _GLOBAL_POOL
    with _POOL_LOCK:
        if _GLOBAL_POOL is None:
            from trino_tpu_torch.runtime.memory import MemoryPool
            from trino_tpu_torch.runtime.spill import MemoryEscalation

            _GLOBAL_POOL = MemoryPool()
            _GLOBAL_POOL.root.on_exceeded = MemoryEscalation(LowMemoryKiller())
        return _GLOBAL_POOL


def set_memory_pool_limit(limit_bytes: int) -> None:
    """Arm (limit > 0) or disarm (0) the shared pool limit."""
    memory_pool().root.limit_bytes = int(limit_bytes)


def query_memory_context(limit_bytes: int = 0):
    """Per-query memory context for the execution planners: on the SHARED
    pool (visible to the killer, released by the runner at statement end)
    when a statement is executing, else on a private throwaway pool
    (planners built directly, as tests do)."""
    from trino_tpu_torch.runtime.memory import MemoryPool

    ctx = current_query()
    if ctx is None:
        return MemoryPool().query_context("query", limit_bytes)
    mem = memory_pool().query_context(ctx.query_id, limit_bytes)
    mem.owner = ctx
    ctx.attach_memory(mem)
    return mem

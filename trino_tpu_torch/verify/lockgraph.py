"""Dynamic lock-order verification: record the acquisition-order graph at
runtime and fail on cycles.

Port of trino_tpu/verify/lockgraph.py.  The static pass
(verify/concurrency.py) sees lexically nested `with` statements; what it
cannot see is cross-function nesting: a dispatcher lane holds the device
gate and calls into the metrics registry (which takes its own lock) while
another lane, inside a registry-locked section, waits on the gate.  Each
call chain looks fine alone; together they deadlock.  This module catches
that class at test time:

  * `InstrumentedLock` wraps a real `threading.Lock`, reporting every
    acquire/release to a `LockGraph`.  Each thread's currently-held set is
    tracked; acquiring L while holding K records the edge K -> L with a
    witness call site.  Reentrant acquires of one lock never self-edge.
  * `InstrumentedRLock` does the same for a `threading.RLock`, with the
    owner-and-count semantics of a reentrant lock, and forwards
    `_is_owned`, `_release_save` and `_acquire_restore`, so a
    `threading.Condition` built over it can `wait()` while the lock is
    held (the dispatcher's condition is built over its RLock).  The JAX
    package's graph covers plain locks only; the port's gate and several
    state locks are RLocks, so its graph covers those too.
  * `LockGraph.assert_acyclic()` raises `LockOrderViolation` naming the
    cycle and the witness sites — an order inversion is a deadlock waiting
    for the right interleaving, so the check fails even when the run
    happened not to hang.
  * `capture()` patches `threading.Lock` and `threading.RLock` for a scope
    so every lock created inside it is instrumented, named by its
    allocation site.
  * `instrument_attr(obj, "_lock", name)` wraps one existing lock in place
    (for process singletons created before the capture began);
    `instrument_singletons()` does it for the port's own process-wide
    locks.

Everything is deterministic: the graph is about ORDER, not interleaving, so
a single thread acquiring A->B then B->A is enough to prove the hazard.
"""

from __future__ import annotations

import _thread
import threading
from contextlib import contextmanager
from typing import Optional


class LockOrderViolation(Exception):
    """The recorded acquisition-order graph has a cycle."""


def _site() -> str:
    """file:line of the acquiring frame (first frame outside this module)."""
    import sys

    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename.endswith("lockgraph.py"):
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class LockGraph:
    """Thread-safe acquisition-order edge set over named locks."""

    def __init__(self):
        # raw _thread lock: the graph's own mutex must never be an
        # InstrumentedLock (capture() patches threading.Lock)
        self._mu = _thread.allocate_lock()
        #: (held, acquired) -> first witness "thread | site"
        self._edges: dict = {}
        self._local = threading.local()

    def _held(self) -> list:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held

    # -- recording ------------------------------------------------------------

    def note_acquire(self, name: str) -> None:
        held = self._held()
        if name in held:  # reentrant / same-name: no self-edges
            held.append(name)
            return
        if held:
            site = _site()
            tname = threading.current_thread().name
            with self._mu:
                for h in held:
                    if h != name:
                        self._edges.setdefault((h, name), f"{tname} at {site}")
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        # release the most recent acquisition of this name (lock discipline
        # is not necessarily LIFO across different locks)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def note_release_all(self, name: str) -> int:
        """Drop every acquisition of `name` this thread holds (an RLock
        released whole by `Condition.wait`); returns how many."""
        held = self._held()
        n = held.count(name)
        held[:] = [h for h in held if h != name]
        return n

    # -- queries ---------------------------------------------------------------

    def edges(self) -> dict:
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> list:
        """Closed walks in the edge set, each as [a, b, ..., a]."""
        from trino_tpu_torch.verify.concurrency import find_cycles

        return find_cycles([(a, b) for (a, b) in self.edges()])

    def assert_acyclic(self) -> None:
        cycles = self.cycles()
        if not cycles:
            return
        edges = self.edges()
        lines = []
        for cyc in cycles:
            pairs = list(zip(cyc, cyc[1:]))
            witness = "; ".join(
                f"{a} -> {b} ({edges.get((a, b), '?')})" for a, b in pairs
            )
            lines.append(" -> ".join(cyc) + f" [{witness}]")
        raise LockOrderViolation(
            "lock acquisition order has "
            f"{len(cycles)} cycle(s) — a deadlock waiting for the right "
            "interleaving:\n  " + "\n  ".join(lines)
        )


#: graph used when none is passed explicitly (tests usually scope their own)
DEFAULT_GRAPH = LockGraph()


class InstrumentedLock:
    """A threading.Lock wrapper reporting acquisition order to a LockGraph.
    Supports the full Lock protocol (context manager, blocking/timeout,
    locked) so it drops into any `with self._lock:` site unchanged."""

    def __init__(self, name: str, graph: Optional[LockGraph] = None,
                 inner=None):
        self._name = name
        self._graph = graph or DEFAULT_GRAPH
        self._inner = inner if inner is not None else _thread.allocate_lock()

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking and timeout == -1:
            # record the INTENT edge before an indefinite block: if this
            # acquire deadlocks, the graph already holds the evidence
            self._graph.note_acquire(self._name)
            try:
                return self._inner.acquire(blocking)
            except BaseException:
                self._graph.note_release(self._name)
                raise
        # try-lock / bounded acquire: record only on SUCCESS — a failed
        # try-acquire backs off instead of waiting, so it can never
        # deadlock, and its edge would fabricate cycles for the standard
        # ordering-sidestep pattern (`if a.acquire(False): ... else: ...`)
        ok = (
            self._inner.acquire(blocking, timeout)
            if timeout != -1
            else self._inner.acquire(blocking)
        )
        if ok:
            self._graph.note_acquire(self._name)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._graph.note_release(self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        return f"<{type(self).__name__} {self._name} {self._inner!r}>"


class InstrumentedRLock(InstrumentedLock):
    """A threading.RLock wrapper: the owner may re-acquire (no self-edge),
    and the Condition protocol is forwarded so `Condition(lock).wait()`
    releases every level of the hold and restores it after the wait."""

    def __init__(self, name: str, graph: Optional[LockGraph] = None,
                 inner=None):
        super().__init__(name, graph, inner if inner is not None else _thread.RLock())

    def locked(self) -> bool:
        # RLock has no locked() before Python 3.14: a held RLock fails a
        # try-acquire from another thread; the owner sees it as held
        if self._inner._is_owned():
            return True
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        return state, self._graph.note_release_all(self._name)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        self._inner._acquire_restore(state)
        for _ in range(max(1, depth)):
            self._graph.note_acquire(self._name)


def _wrapper_for(inner, name: str, graph: Optional[LockGraph]):
    cls = InstrumentedRLock if hasattr(inner, "_is_owned") else InstrumentedLock
    return cls(name, graph, inner=inner)


def instrument_attr(obj, attr: str, name: Optional[str] = None,
                    graph: Optional[LockGraph] = None):
    """Wrap an existing lock attribute in place (an RLock keeps its
    reentrant protocol); returns a restore callable.  `obj` may be an
    object or a module."""
    inner = getattr(obj, attr)
    if isinstance(inner, InstrumentedLock):  # already wrapped
        return lambda: None
    label = name or f"{type(obj).__name__}.{attr}"
    setattr(obj, attr, _wrapper_for(inner, label, graph))

    def restore():
        setattr(obj, attr, inner)

    return restore


def _singleton_sites() -> list:
    """(object, attribute, graph name) of every process-wide lock the port
    creates at import time."""
    from trino_tpu_torch import config as cfg
    from trino_tpu_torch.expr import functions, ir
    from trino_tpu_torch.kernels import build
    from trino_tpu_torch.ops import aggregation, grouped_sums, locate_sorted
    from trino_tpu_torch.parallel import serde, spmd
    from trino_tpu_torch.partitioning.speculative import CAP_HISTORY
    from trino_tpu_torch.runtime import buffer_pool, dispatcher, lifecycle, spill
    from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE
    from trino_tpu_torch.telemetry import metrics

    return [
        (dispatcher, "_DEVICE_GATE", "dispatcher:_DEVICE_GATE"),
        (dispatcher, "_WAITERS_LOCK", "dispatcher:_WAITERS_LOCK"),
        (spmd.TRACE_CACHE, "_lock", "TRACE_CACHE._lock"),
        (grouped_sums, "_LAUNCHES_LOCK", "grouped_sums:_LAUNCHES_LOCK"),
        (locate_sorted, "_LAUNCHES_LOCK", "locate_sorted:_LAUNCHES_LOCK"),
        (metrics, "_SERIES_LOCK", "metrics:_SERIES_LOCK"),
        (metrics.REGISTRY, "_lock", "REGISTRY._lock"),
        (ir, "_KEY_IDS_LOCK", "ir:_KEY_IDS_LOCK"),
        (functions, "_HOST_TABLES_LOCK", "functions:_HOST_TABLES_LOCK"),
        (aggregation, "_DICT_HASHES_LOCK", "aggregation:_DICT_HASHES_LOCK"),
        (serde, "_VALUE_HASHES_LOCK", "serde:_VALUE_HASHES_LOCK"),
        (build, "_LOCK", "kernels.build:_LOCK"),
        (buffer_pool.POOL, "lock", "POOL.lock"),
        (lifecycle, "_POOL_LOCK", "lifecycle:_POOL_LOCK"),
        (cfg, "_LOCK", "config:_LOCK"),
        (spill.REVOCABLES, "_lock", "REVOCABLES._lock"),
        (DICTIONARY_SERVICE, "_lock", "DICTIONARY_SERVICE._lock"),
        (CAP_HISTORY, "_lock", "CAP_HISTORY._lock"),
    ]


def instrument_singletons(graph: Optional[LockGraph] = None) -> list:
    """Wrap the port's process-wide locks (created at import time, before
    any capture() could see them).  Returns restore callables."""
    return [
        instrument_attr(obj, attr, name, graph)
        for obj, attr, name in _singleton_sites()
    ]


@contextmanager
def capture(graph: Optional[LockGraph] = None, singletons: bool = True):
    """Scope in which every `threading.Lock()` and `threading.RLock()`
    creation yields an instrumented lock named by its allocation site,
    feeding `graph` (a fresh LockGraph when None — yielded to the caller).
    With `singletons`, the port's import-time locks are wrapped for the
    scope too.

    The patch is process-global for the scope: locks created by OTHER
    threads during it are instrumented as well — which is the point, the
    engine lanes are where the ordering bugs live."""
    g = graph or LockGraph()
    real_lock, real_rlock = threading.Lock, threading.RLock

    def make_lock():
        return InstrumentedLock(f"lock@{_site()}", g, inner=real_lock())

    def make_rlock():
        return InstrumentedRLock(f"rlock@{_site()}", g, inner=real_rlock())

    restores = instrument_singletons(g) if singletons else []
    threading.Lock, threading.RLock = make_lock, make_rlock
    try:
        yield g
    finally:
        threading.Lock, threading.RLock = real_lock, real_rlock
        for r in reversed(restores):
            r()

"""Hierarchical memory accounting and per-query budgets.

Port of trino_tpu/runtime/memory.py (reference: lib/trino-memory-context,
AggregatedMemoryContext's operator -> driver -> pipeline -> task -> pool
reservation tree, and memory/MemoryPool.java:44).  Batches report their
device footprint (tensor bytes, masks and the dictionaries their coded
columns reference); blocking operators reserve before materializing.  A
reservation past a node's limit raises ExceededMemoryLimitException, the
signal on which partition waves and spill (runtime/spill.py) take over.

The budget is logical accounting, not the CUDA caching allocator:
releasing a reservation frees no device memory by itself.

Thread safety: the tree shares ONE reentrant lock per root (children adopt
their parent's lock), because a reservation mutates every ancestor.  The
`on_exceeded` hook (the revoke tier and the low-memory killer,
runtime/spill.py and runtime/lifecycle.py) runs OUTSIDE the lock:
revocation spills through operator code that takes its own locks and
re-enters the tree to release.
"""

from __future__ import annotations

import threading
from typing import Optional


class ExceededMemoryLimitException(RuntimeError):
    def __init__(self, message: str, node: Optional["MemoryContext"] = None):
        super().__init__(message)
        #: the tree node whose limit blocked the reservation (the pool root
        #: for cluster-wide pressure, a query context for per-query budgets)
        self.node = node


def dictionary_bytes(d) -> int:
    """Footprint of one dictionary: the i32 code tables string kernels
    gather through, one validity byte per entry, plus the value bytes.
    PatternDictionary values are lazy; they account the per-entry overhead
    without forcing them."""
    n = len(d)
    overhead = n * 4 + n
    if not isinstance(d.values, tuple):
        return overhead
    return overhead + sum(len(v) for v in d.values)


def _cached_dictionary_bytes(d) -> int:
    """Memoized on the (immutable) dictionary itself: an id()-keyed side
    table would go stale when CPython reuses a dead dictionary's address."""
    v = getattr(d, "_nbytes", None)
    if v is None:
        v = dictionary_bytes(d)
        try:
            object.__setattr__(d, "_nbytes", v)
        except AttributeError:  # no slot (foreign dictionary type)
            pass
    return v


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def batch_bytes(batch, _seen_dicts: Optional[set] = None) -> int:
    """Device footprint of a Batch (columns + validity + row mask + the
    dictionaries its coded columns reference, each counted once).
    `_seen_dicts` lets `batches_bytes` dedupe dictionaries across a list."""
    total = 0
    seen = set() if _seen_dicts is None else _seen_dicts
    for c in batch.columns:
        total += _tensor_bytes(c.data)
        if c.valid is not None:
            total += _tensor_bytes(c.valid)
        if c.lengths is not None:
            total += _tensor_bytes(c.lengths)
        d = c.dictionary
        if d is not None and id(d) not in seen:
            seen.add(id(d))
            total += _cached_dictionary_bytes(d)
    if batch.row_mask is not None:
        total += _tensor_bytes(batch.row_mask)
    return int(total)


def batches_bytes(batches) -> int:
    """Footprint of a batch list with shared dictionaries counted once:
    accumulating operators (sort runs, aggregation states, join builds) sum
    through this, or a dictionary shared by every scan batch would count
    once per batch and trip the budget spuriously."""
    seen: set = set()
    return sum(batch_bytes(b, _seen_dicts=seen) for b in batches)


class MemoryContext:
    """One node of the reservation tree; a reservation also counts at every
    ancestor.  The whole tree is guarded by its root's reentrant lock."""

    def __init__(self, parent: Optional["MemoryContext"] = None, name: str = "root",
                 limit_bytes: int = 0):
        self.parent = parent
        self.name = name
        self.limit_bytes = limit_bytes  # 0 = unlimited (checked at this node)
        self.reserved = 0
        self.peak = 0
        #: pool-root hook: hook(blocked_node, requesting_ctx, delta) when a
        #: reservation exceeds this node's limit; True = something was
        #: freed, retry
        self.on_exceeded = None
        #: query roots registered on a pool root (the killer's candidates)
        self.query_children: list = []
        #: True for per-query nodes (MemoryPool.query_context)
        self.is_query_root = False
        #: the lifecycle QueryContext of a query root (a killed victim
        #: aborts through it at its next check)
        self.owner = None
        self._lock = parent._lock if parent is not None else threading.RLock()

    def child(self, name: str) -> "MemoryContext":
        return MemoryContext(self, name)

    def query_root(self) -> "MemoryContext":
        """The nearest ancestor (or self) flagged `is_query_root`, else the
        node directly under the pool root."""
        with self._lock:
            node = self
            while node is not None:
                if node.is_query_root:
                    return node
                node = node.parent
            node = self
            while node.parent is not None and node.parent.parent is not None:
                node = node.parent
            return node

    def set_bytes(self, n: int) -> None:
        """Set this node's reservation to exactly `n`.  The delta is
        computed under the tree lock, so a concurrent set_bytes (the revoke
        tier zeroing an operator its owner is still accounting) cannot
        apply a stale delta; the escalation hook runs outside the lock and
        the retry recomputes the delta."""
        while True:
            delta = 0
            try:
                with self._lock:
                    delta = n - self.reserved
                    return self._reserve(delta)
            except ExceededMemoryLimitException as e:
                hook = e.node.on_exceeded if e.node is not None else None
                if hook is None or delta <= 0 or not hook(e.node, self, delta):
                    raise

    def close(self) -> None:
        self.set_bytes(0)

    def add_bytes(self, delta: int) -> None:
        while True:
            try:
                return self._reserve(delta)
            except ExceededMemoryLimitException as e:
                # the escalation hook (revoke tier, then the killer) lives
                # on the pool root; a per-query budget has none and raises
                # to the requester, the wave fallback's signal
                hook = e.node.on_exceeded if e.node is not None else None
                if hook is None or delta <= 0 or not hook(e.node, self, delta):
                    raise

    def _reserve(self, delta: int) -> None:
        with self._lock:
            visited = []
            node = self
            try:
                while node is not None:
                    node.reserved += delta
                    visited.append(node)
                    # releases never fail: after a mid-query limit shrink
                    # the tree may sit above its new limit, and refusing to
                    # give memory back would wedge it there
                    if delta > 0 and node.limit_bytes and node.reserved > node.limit_bytes:
                        raise ExceededMemoryLimitException(
                            f"memory limit exceeded at {node.name}: "
                            f"{node.reserved} > {node.limit_bytes} bytes",
                            node=node,
                        )
                    node.peak = max(node.peak, node.reserved)
                    node = node.parent
            except ExceededMemoryLimitException:
                for v in visited:  # undo, so the accounting stays consistent
                    v.reserved -= delta
                raise

    def force_release(self) -> None:
        """Reclaim this subtree's accounting without its operators (the
        killer's reclaim and statement-end cleanup): the reservation leaves
        every ancestor and the node detaches, so late close() calls of a
        dying query cannot corrupt the shared pool."""
        with self._lock:
            node, delta = self.parent, -self.reserved
            while node is not None:
                if self in node.query_children:
                    node.query_children.remove(self)
                node.reserved += delta
                node = node.parent
            self.reserved = 0
            self.parent = None


class MemoryPool:
    """Per-query (or per-process) pool root (reference: MemoryPool.java:44)."""

    def __init__(self, limit_bytes: int = 0):
        self.root = MemoryContext(None, "pool", limit_bytes)

    def query_context(self, query_id: str, limit_bytes: int = 0) -> MemoryContext:
        ctx = self.root.child(f"query:{query_id}")
        ctx.limit_bytes = limit_bytes
        ctx.is_query_root = True
        with self.root._lock:
            self.root.query_children.append(ctx)
        return ctx

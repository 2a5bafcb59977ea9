"""Graceful degradation under memory pressure: budgeted partition waves,
filesystem-SPI spill, and memory revocation.

Port of trino_tpu/runtime/spill.py.  Reference: the Trino revoke and spill
machinery, mapped onto a budgeted k-pass partition loop:

  * ``HashBuilderOperator.startMemoryRevoke:372``: a blocking operator
    asked to give memory back spills its state and releases its
    reservation (here: :class:`RevocableOperator` + :class:`MemoryEscalation`);
  * ``GenericPartitioningSpiller``: state hash-partitions by the row value
    hash and persists through the spill SPI (here: :class:`SpillManager`
    over the npz ``SpoolManager`` and the filesystem SPI);
  * ``SpillingJoinProcessor``: spilled join partitions process in
    sequential waves (here: :func:`partition_wave_join` and the mesh wave
    paths of ``parallel/runner``).

The escalation ladder a reservation climbs:

  1. **budget**: blocking operators (join build, hash aggregation,
     order-by sort, window) reserve their device footprint on the memory
     pool BEFORE materializing;
  2. **revoke**: when the shared pool blocks, the largest *registered
     revocable* operator is asked to spill and release its reservation
     (``trino_tpu_memory_revocations_total``);
  3. **wave**: an operator whose own reservation cannot fit degrades to
     ``k = next_pow2(need / budget)`` hash-partition waves, with the
     partitions that are not resident spilled host-side
     (``trino_tpu_memory_waves_total``, ``trino_tpu_spill_bytes_total``);
  4. **kill**: the LowMemoryKiller stays the last resort.

None of this engages without a budget: an unconstrained query records
zero waves, zero spill and zero revocations.

Host boundary on the card: device rows cross to the host only in
:func:`pull_host` (every copy is started without blocking, then the
stream is synchronized once, before numpy reads a buffer), and return to
the card only in :func:`to_device` (pinned host buffers, copies ordered on
the current stream).  The budget is logical accounting (``batches_bytes``),
not the CUDA caching allocator.
"""

from __future__ import annotations

import math
import threading
import uuid
from typing import Callable, Optional

import numpy as np
import torch

#: partition-wave fan-out ceiling (a 64-pass query is already degraded far
#: past useful; beyond this the killer is the kinder answer)
MAX_WAVES = 64


# -- budget arithmetic ---------------------------------------------------------


def session_budget(properties) -> int:
    """Per-query session budget in bytes: the smallest nonzero of
    ``query_max_memory`` and the legacy ``query_max_memory_bytes``."""
    vals = []
    if properties is not None:
        for knob in ("query_max_memory", "query_max_memory_bytes"):
            v = int(properties.get(knob))
            if v > 0:
                vals.append(v)
    return min(vals) if vals else 0


def effective_budget(properties=None, memory_ctx=None) -> int:
    """The per-query device budget in bytes (0 = unconstrained): the
    smallest nonzero of the session budget, the query context's own limit,
    and any ancestor pool limit (``memory.pool-limit-bytes``)."""
    candidates = []
    sb = session_budget(properties)
    if sb > 0:
        candidates.append(sb)
    node = memory_ctx
    while node is not None:
        if node.limit_bytes:
            candidates.append(int(node.limit_bytes))
        node = node.parent
    return min(candidates) if candidates else 0


def wave_count(need: int, budget: int, properties=None) -> int:
    """``k = next_pow2(need / budget)`` partition-wave fan-out, clamped to
    [2, MAX_WAVES]; the ``memory_wave_partitions`` session property
    overrides."""
    if properties is not None:
        k = int(properties.get("memory_wave_partitions"))
        if k > 0:
            return max(2, min(MAX_WAVES, k))
    if budget <= 0:
        return 2
    from trino_tpu_torch.ops.common import next_pow2

    return max(
        2,
        min(MAX_WAVES, next_pow2(max(1, math.ceil(need / budget)), floor=2)),
    )


def spill_to_disk(properties) -> bool:
    """The ``spill_enabled`` session knob: False stages the partitions of
    waves that are not resident in host RAM instead of the filesystem."""
    if properties is None:
        return True
    return bool(properties.get("spill_enabled"))


# -- observability -------------------------------------------------------------


class PressureObserver:
    """Routes wave and spill events to the metrics registry plus an
    optional per-query sink (anything with ``bump(name, n)``)."""

    def __init__(self, sink=None):
        self.sink = sink

    def waves(self, operator: str, k: int) -> None:
        from trino_tpu_torch.telemetry.metrics import memory_waves_counter

        memory_waves_counter().labels(operator).inc(k)
        if self.sink is not None:
            self.sink.bump("memory_wave", k)

    def spilled(self, nbytes: int) -> None:
        from trino_tpu_torch.telemetry.metrics import spill_bytes_counter

        spill_bytes_counter().inc(nbytes)
        if self.sink is not None:
            self.sink.bump("spill_bytes", nbytes)


# -- the host boundary ---------------------------------------------------------


def pull_host_async(b, copies: list):
    """`b`'s copy to the host, started without waiting (a host batch
    passes through); the batch returned is valid only after
    `wait_pulls(copies)`."""
    from trino_tpu_torch.columnar import Batch, Column

    if b.device.type == "cpu":
        return b

    def get(t):
        if t is None:
            return None
        h = t.to("cpu", non_blocking=True)
        copies.append(t.device)
        return h

    cols = [
        Column(get(c.data), c.type, get(c.valid), c.dictionary, get(c.lengths))
        for c in b.columns
    ]
    return Batch(cols, get(b.row_mask))


def pull_host(*items):
    """The spill tier's declared host boundary: batches (or lists of
    batches) on the card cross to the host here, immediately before they
    are partitioned and spilled.  Every copy is started without blocking;
    one synchronization of the card's stream then makes every host buffer
    valid before numpy reads it (a read before that would see stale rows
    and raise nothing).  Host batches pass through."""
    copies: list = []
    out = [
        [pull_host_async(b, copies) for b in x] if isinstance(x, list)
        else pull_host_async(x, copies)
        for x in items
    ]
    wait_pulls(copies)
    return out if len(out) > 1 else out[0]


def wait_pulls(copies: list) -> None:
    """One synchronization of the card's stream, after which every copy
    `pull_host_async` started into `copies` is valid on the host."""
    if copies:
        torch.cuda.current_stream(copies[0]).synchronize()


def to_device(hb, device):
    """A host batch back on `device`: on the card through pinned buffers
    and copies ordered on the current stream (the consumer's kernels run
    on that stream after them)."""
    if device.type == "cpu":
        return hb
    return hb.pin_memory().to(device, non_blocking=True)


# -- the partitioning spiller --------------------------------------------------


class SpillManager:
    """Partitioned host-side spill store (GenericPartitioningSpiller role):
    persists lists of host batches per (tag, partition) through the npz
    ``SpoolManager``, which rides the filesystem SPI."""

    def __init__(self, directory: Optional[str] = None, observer=None):
        from trino_tpu_torch.runtime.fte import SpoolManager

        if directory is None:
            from trino_tpu_torch.config import get_config

            directory = get_config().memory.spill_dir or None
        self.spool = SpoolManager(directory)
        #: unique per manager, so shared spill directories never collide
        self._prefix = f"spill_{uuid.uuid4().hex[:12]}"
        #: (tag, part) -> (symbols, dictionaries): the schema to rehydrate
        self._meta: dict = {}
        self._seq: dict = {}
        self.bytes_spilled = 0
        self._closed = False
        self.observer = observer if observer is not None else PressureObserver()
        # a statement that ends mid-wave abandons its wave generator, whose
        # finally runs only at collection: register with the statement so
        # its end deletes our partitions at once
        from trino_tpu_torch.runtime.lifecycle import register_spill

        register_spill(self)

    def _fid(self, tag: str, part: int) -> int:
        key = (tag, part)
        fid = self._seq.get(key)
        if fid is None:
            fid = len(self._seq)
            self._seq[key] = fid
        return fid

    def save(self, tag: str, part: int, batches: list) -> int:
        """Spill host batches as one partition; returns bytes written.
        Dictionaries are unified across the partition's batches first, so
        one dictionary list rehydrates every batch exactly."""
        from trino_tpu_torch.ops.sort import _unify_host_dictionaries
        from trino_tpu_torch.planner import plan as P
        from trino_tpu_torch.runtime.memory import batches_bytes

        if not batches:
            return 0
        batches = _unify_host_dictionaries(list(batches))
        first = batches[0]
        symbols = [P.Symbol(f"c{i}", c.type) for i, c in enumerate(first.columns)]
        self.spool.save(self._prefix + "_" + tag, self._fid(tag, part), batches, symbols)
        self._meta[(tag, part)] = (symbols, [c.dictionary for c in first.columns])
        nbytes = batches_bytes(batches)
        self.bytes_spilled += nbytes
        self.observer.spilled(nbytes)
        return nbytes

    def load(self, tag: str, part: int) -> list:
        """Rehydrate one partition's host batches ([] when the partition
        was empty and never written)."""
        meta = self._meta.get((tag, part))
        if meta is None:
            return []
        symbols, dicts = meta
        out = self.spool.load(self._prefix + "_" + tag, self._fid(tag, part), symbols, dicts)
        return out if out is not None else []

    def close(self) -> None:
        # idempotent: statement-end cleanup and the wave loop's own finally
        # may both close
        if self._closed:
            return
        self._closed = True
        from trino_tpu_torch.runtime.lifecycle import current_query

        ctx = current_query()
        if ctx is not None:
            ctx.unregister_spill(self)
        # a configured spill directory is shared: the spool removes only a
        # directory it created, so delete our own partition files
        for (tag, part), fid in list(self._seq.items()):
            if (tag, part) in self._meta:
                try:
                    self.spool.fs.delete(self.spool._path(self._prefix + "_" + tag, fid))
                except OSError:  # already swept
                    pass
        self._meta.clear()
        self.spool.close()


class _DiskSide:
    """One operator input, hash-partitioned into k on-disk partitions."""

    def __init__(self, spiller: SpillManager, tag: str):
        self.spiller = spiller
        self.tag = tag

    def load_part(self, part: int) -> list:
        return self.spiller.load(self.tag, part)


class _RamSide:
    """spill_enabled=false: partitions stay in host RAM."""

    def __init__(self, buckets: list):
        self.buckets = buckets

    def load_part(self, part: int) -> list:
        return self.buckets[part]


def partition_side(host_batches: list, key_channels, k: int,
                   spiller: Optional[SpillManager], tag: str):
    """Hash-partition host batches by the row value hash
    (``serde.stable_row_hash``) into k partitions; spilled to disk when a
    spiller is given, staged in RAM otherwise."""
    from trino_tpu_torch.parallel.serde import partition_batches

    buckets = partition_batches(host_batches, list(key_channels), k)
    if spiller is None:
        return _RamSide(buckets)
    for part, bucket in enumerate(buckets):
        if bucket:
            spiller.save(tag, part, bucket)
        buckets[part] = None  # free RAM as partitions land on disk
    return _DiskSide(spiller, tag)


# -- partition-wave join (SpillingJoinProcessor role) --------------------------


def partition_wave_join(make_op, build_side, probe_side, n_waves: int,
                        ctx, observer: PressureObserver, device):
    """k-pass partition-wave join: each wave materializes only its slice of
    the build side on `device` while both sides re-feed from the spill
    tier.  Partitioning both sides by the same key-value hash keeps inner,
    left and full joins exact: every potential match pair lands in the
    same wave, and each row is emitted by exactly one wave."""
    from trino_tpu_torch.runtime.memory import batches_bytes

    observer.waves("join", n_waves)
    for wave in range(n_waves):
        wave_build = [to_device(b, device) for b in build_side.load_part(wave)]
        if ctx is not None:
            # the raw slice and its dense copy
            reserve_wave_working_set(ctx, 2 * batches_bytes(wave_build))
        op = make_op()
        op.set_build(wave_build, device)
        del wave_build

        def probe_feed(w=wave):
            for hb in probe_side.load_part(w):
                yield to_device(hb, device)

        yield from op.process(probe_feed())
        del op
    if ctx is not None:
        ctx.close()


def reserve_wave_working_set(ctx, nbytes: int) -> None:
    """Account one wave's working set on the reservation tree, best
    effort: the wave path is already the degradation tier, so its own
    bookkeeping must never kill the query it is saving.  When even one wave
    cannot fit the (possibly shrunk) budget, the wave proceeds with the
    reservation pinned at what was admitted (reference analog: revocable
    memory is accounted outside the query limit)."""
    from trino_tpu_torch.runtime.memory import ExceededMemoryLimitException

    try:
        ctx.set_bytes(nbytes)
    except ExceededMemoryLimitException:
        pass


# -- memory revocation (startMemoryRevoke role) --------------------------------


class RevocableOperator:
    """A registered wave-capable blocking operator: when the shared pool
    blocks, the escalation hook asks the largest one to spill its state and
    release its reservation instead of shooting a query.

    The handle's lock serializes the revoker (another thread) against the
    owner: ``revoke()`` runs the spill callback under it, and the owner's
    ``revoked`` reads take it too, so an owner that observes ``revoked``
    knows the spill completed."""

    def __init__(self, operator: str, ctx, spill_fn: Callable[[], int]):
        self.operator = operator
        self.ctx = ctx
        self._spill_fn = spill_fn
        #: reentrant: owners guard their own state with it too, and an
        #: owner-thread reservation that triggers the escalation hook may
        #: revoke its own handle
        self.lock = threading.RLock()
        self._revoked = False
        self._done = False

    @property
    def revoked(self) -> bool:
        with self.lock:
            return self._revoked

    def reserved_bytes(self) -> int:
        """Ranking key for victim choice (a point-in-time read)."""
        return int(self.ctx.reserved) if self.ctx is not None else 0

    def revoke(self) -> int:
        """Spill and release; returns bytes freed (0 when already revoked
        or finished: the registry then tries the next candidate)."""
        with self.lock:
            if self._revoked or self._done:
                return 0
            freed = int(self._spill_fn() or 0)
            self._revoked = True
        REVOCABLES.unregister(self)
        return freed

    def finish(self) -> None:
        """The owner completed (normally or not): no longer revocable."""
        with self.lock:
            self._done = True
        REVOCABLES.unregister(self)


class RevocableRegistry:
    """Process-wide registry the escalation hook consults (reference role:
    the memory manager's revoking candidates)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list = []

    def register(self, handle: RevocableOperator) -> RevocableOperator:
        with self._lock:
            self._entries.append(handle)
        return handle

    def unregister(self, handle) -> None:
        with self._lock:
            if handle in self._entries:
                self._entries.remove(handle)

    def live(self) -> list:
        with self._lock:
            return list(self._entries)

    def revoke_largest(self) -> int:
        """Ask the revocable with the largest reservation to spill; falls
        through to smaller ones if the largest races to completion first.
        Returns bytes freed (0 = nothing revocable)."""
        for h in sorted(self.live(), key=lambda e: e.reserved_bytes(), reverse=True):
            freed = h.revoke()
            if freed > 0:
                return freed
        return 0


#: the process registry
REVOCABLES = RevocableRegistry()


class MemoryEscalation:
    """Pool-root ``on_exceeded`` hook: the revoke tier runs BEFORE the
    low-memory killer (spilling a cooperative operator is kinder than
    shooting a query); the killer's choice is unchanged when revocation
    frees nothing."""

    def __init__(self, killer=None):
        if killer is None:
            from trino_tpu_torch.runtime.lifecycle import LowMemoryKiller

            killer = LowMemoryKiller()
        self.killer = killer

    def __call__(self, pool_root, requesting, delta: int) -> bool:
        freed = REVOCABLES.revoke_largest()
        if freed > 0:
            from trino_tpu_torch.telemetry.metrics import memory_revocations_counter

            memory_revocations_counter().inc()
            return True  # something released: retry the reservation
        return self.killer(pool_root, requesting, delta)


# -- host-side wave slicing (aggregation and window waves) ---------------------


def host_wave_slice(hb, key_channels: list, n_waves: int, wave: int):
    """Rows of a HOST batch whose key VALUE hash lands in `wave`, as a
    dense host batch (None when empty).  Value hashing keeps groups whole
    across batches whose dictionaries are batch-local."""
    from trino_tpu_torch.columnar import Batch, Column
    from trino_tpu_torch.parallel.serde import stable_row_hash

    h = stable_row_hash(hb, key_channels)
    keep = hb.mask().numpy() & ((h % np.uint64(n_waves)) == np.uint64(wave))
    n = int(keep.sum())
    if n == 0:
        return None
    idx = torch.from_numpy(np.nonzero(keep)[0])
    cols = [c.map_rows(lambda x: x[idx]) for c in hb.columns]
    return Batch(cols, torch.ones(n, dtype=torch.bool))


class SpillingAccumulator:
    """Bounded accumulation of host batches with an optional disk tier:
    chunks pushed over a stream land in RAM or (spiller given) the
    filesystem, and are re-read a chunk at a time per wave.  The shared
    shape under the aggregation-state and window wave streams."""

    def __init__(self, spiller: Optional[SpillManager], tag: str):
        self.spiller = spiller
        self.tag = tag
        self._chunks: list = []  # part index (disk) or [host batches] (RAM)
        self.total_bytes = 0

    def push_chunk(self, host_batches: list) -> None:
        from trino_tpu_torch.runtime.memory import batches_bytes

        if not host_batches:
            return
        self.total_bytes += batches_bytes(host_batches)
        if self.spiller is not None:
            part = len(self._chunks)
            self.spiller.save(self.tag, part, list(host_batches))
            self._chunks.append(part)
        else:
            self._chunks.append(list(host_batches))

    def chunks(self):
        """Iterate a chunk at a time (one chunk resident in RAM when disk
        backed): yields lists of host batches."""
        for c in self._chunks:
            if isinstance(c, int):
                yield self.spiller.load(self.tag, c)
            else:
                yield c

    def wave_parts(self, key_channels: list, n_waves: int, wave: int) -> list:
        """Every chunk's slice for one wave (host batches).  Disk-backed
        chunks are re-read once per wave (k-fold read amplification): k is
        known only after the last chunk lands, and the states and window
        inputs this serves are compacted; the join paths, whose spilled
        data is the raw input, partition at write time instead
        (partition_side) and read each wave once."""
        parts = []
        for chunk in self.chunks():
            for hb in chunk:
                p = host_wave_slice(hb, key_channels, n_waves, wave)
                if p is not None:
                    parts.append(p)
        return parts

"""Stacked-batch SPMD utilities over a mesh of logical workers.

Port of trino_tpu/parallel/spmd.py.  A distributed batch is an ordinary
Batch whose tensors carry a leading worker axis [W, cap].  The JAX package
shards that axis over W XLA devices and runs every per-worker step under
shard_map; here the W workers are logical workers on ONE torch device (the
reference's DistributedQueryRunner runs N workers in one JVM the same
way), a per-worker step runs once per shard of the stacked tensors, and
the shards' outputs are stacked again.  The collectives (exchange.py)
become permutations of the stacked tensors on the device.

PyTorch runs eagerly, so there is no trace to cache: `TRACE_CACHE` keeps the
built step closures per semantic key, which is what the runner's keys
fingerprint.  A mesh across several cards is not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import pad_elements
from trino_tpu_torch.ops.common import next_pow2


class TraceCache:
    """Process-wide cache of built per-worker step closures, keyed on the
    step's semantic fingerprint + shape bucket (the JAX package's cache of
    jitted SPMD programs; torch does not compile, so a hit saves only the
    closure construction).

    `hits` and `misses` count lookups (a miss builds a step); `retraces`
    stays 0, since nothing is traced; `evictions` counts entries dropped
    past `limit`.  While a mesh statement runs, `on_build(seconds)` (set
    by the stage executor for its thread) receives each build's seconds,
    which its profile books as the fragment's `trace` phase.  `audit`
    (verify.cache_key_audit) is called as audit(key, build) on every get,
    hits included, so cache-key completeness is checked against live
    traffic."""

    def __init__(self, limit: int = 512):
        self.limit = limit
        self._fns: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.retraces = 0
        self.evictions = 0
        self._local = threading.local()
        #: verify.cache_key_audit's hook (None = off)
        self.audit: Optional[Callable] = None

    @property
    def on_build(self) -> Optional[Callable]:
        return getattr(self._local, "on_build", None)

    @on_build.setter
    def on_build(self, fn: Optional[Callable]) -> None:
        self._local.on_build = fn

    def get(self, key, build: Callable):
        audit = self.audit  # snapshot: a concurrent audit exit may null it
        if audit is not None:
            audit(key, build)
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self._fns.move_to_end(key)
                self.hits += 1
                return fn
            self.misses += 1
        t0 = time.perf_counter()
        fn = build()
        dt = time.perf_counter() - t0
        hook = self.on_build
        with self._lock:
            self._fns[key] = fn
            while len(self._fns) > self.limit:
                self._fns.popitem(last=False)
                self.evictions += 1
        if hook is not None:
            hook(dt)
        return fn

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._fns),
                "hits": self.hits,
                "misses": self.misses,
                "retraces": self.retraces,
                "evictions": self.evictions,
            }

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()


#: the process-wide cache (cleared only by tests / explicit calls)
TRACE_CACHE = TraceCache()


class WorkerMesh:
    """The engine's view of the worker set: `n` logical workers on one torch
    device (reference role: the worker set of DiscoveryNodeManager)."""

    def __init__(self, n_workers: int, device=None):
        from trino_tpu_torch.device import resolve_device

        if isinstance(device, (list, tuple)):
            devs = {str(torch.device(d)) for d in device}
            if len(devs) > 1:
                raise NotImplementedError("multi-card mesh: not ported yet")
            device = next(iter(devs))
        if int(n_workers) < 1:
            raise ValueError(f"mesh size must be >= 1, got {n_workers}")
        self.device = resolve_device(device)
        self.n = int(n_workers)


def mesh_key(wm: WorkerMesh) -> tuple:
    """Stable fingerprint of the mesh for cache keys."""
    return (wm.n, str(wm.device))


def bucket_cap(n: int, floor: int = 64) -> int:
    """Pow2 shape bucket for batch capacities."""
    return next_pow2(max(1, n), floor=floor)


# -- shards of a stacked value ------------------------------------------------


def shard(x, w: int):
    """Worker `w`'s view of a stacked value (a Batch, tensor, or a tuple or
    list of them); the port's counterpart of `jax.tree.map(lambda x: x[w])`."""
    if isinstance(x, Batch):
        cols = [c.map_rows(lambda t: t[w]) for c in x.columns]
        return Batch(cols, None if x.row_mask is None else x.row_mask[w])
    if torch.is_tensor(x):
        return x[w]
    if isinstance(x, (tuple, list)):
        return type(x)(shard(v, w) for v in x)
    return x


def _recode_onto_union(pcs: Sequence[Column], ch: int) -> list:
    """Workers' varchar columns recoded onto the union of their
    dictionaries.  A per-row host render (concat_ws, format) builds each
    worker's dictionary from that worker's rows; the JAX package's
    shard_map traces one program with one dictionary per column and raises
    for them on its mesh."""
    from trino_tpu_torch.columnar.column import take_table
    from trino_tpu_torch.columnar.dictionary import union_many

    if any(c.dictionary is None or c.lengths is not None for c in pcs):
        raise ValueError(f"per-worker outputs diverged dictionaries (channel {ch})")
    merged, tables = union_many([c.dictionary for c in pcs])
    return [
        Column(c.data if t is None else take_table(t, c.data).to(c.data.dtype),
               c.type, c.valid, merged)
        for c, t in zip(pcs, tables)
    ]


def _stack_batches_of(parts: Sequence[Batch]) -> Batch:
    first = parts[0]
    cols = []
    for ch, c0 in enumerate(first.columns):
        pcs = [p.columns[ch] for p in parts]
        if any(c.dictionary is not c0.dictionary and c.dictionary != c0.dictionary for c in pcs):
            pcs = _recode_onto_union(pcs, ch)
            c0 = pcs[0]
        valid = None
        if any(c.valid is not None for c in pcs):
            valid = torch.stack([c.valid_mask() for c in pcs])
        lengths = None
        if any(c.lengths is not None for c in pcs):
            # array/map columns: workers' element widths padded to the widest
            pcs = pad_elements(pcs)
            lengths = torch.stack([c.lengths for c in pcs])
        cols.append(
            Column(torch.stack([c.data for c in pcs]), c0.type, valid, c0.dictionary, lengths)
        )
    return Batch(cols, torch.stack([p.mask() for p in parts]))


def stack_shards(parts: Sequence):
    """Stack per-worker values (Batch / tensor / tuple / None) along a new
    leading worker axis: the inverse of `shard`."""
    first = parts[0]
    if isinstance(first, Batch):
        return _stack_batches_of(parts)
    if torch.is_tensor(first):
        return torch.stack(list(parts))
    if isinstance(first, (tuple, list)):
        return type(first)(
            stack_shards([p[i] for p in parts]) for i in range(len(first))
        )
    if first is None:
        return None
    raise TypeError(f"cannot stack per-worker values of type {type(first).__name__}")


def trailing_cap(stacked: Batch) -> int:
    """Row capacity of a stacked [W, cap] batch (Batch.capacity would report
    the leading worker axis)."""
    if stacked.columns:
        return stacked.columns[0].data.shape[1]
    return stacked.row_mask.shape[-1]


# -- host <-> stacked ---------------------------------------------------------


def _pad_host(col_data: np.ndarray, cap: int, fill=0) -> np.ndarray:
    if col_data.shape[0] == cap:
        return col_data
    pad = np.full((cap - col_data.shape[0],) + col_data.shape[1:], fill, dtype=col_data.dtype)
    return np.concatenate([col_data, pad])


def stack_batches(batches: Sequence[Optional[Batch]], wm: WorkerMesh, cap: Optional[int] = None) -> Batch:
    """Stack one host Batch per worker (None = empty) into a [W, cap]
    stacked batch on the mesh's device.  Dictionaries are unioned so codes
    are comparable across workers (exchange serde role)."""
    from trino_tpu_torch.columnar.dictionary import union_many
    from trino_tpu_torch.types import DecimalType

    real = [b for b in batches if b is not None and b.width]
    assert real, "stack_batches needs at least one non-empty batch"
    width = real[0].width
    types = [c.type for c in real[0].columns]
    cap = cap or next_pow2(max(b.capacity for b in real), floor=1)

    cols = []
    for ch in range(width):
        dicts = [
            (b.columns[ch].dictionary if b is not None and b.width else None)
            for b in batches
        ]
        if any(d is not None for d in dicts):
            # empty workers have no dictionary; give them the first real one
            # (their slots are dead rows, codes never read)
            fallback = next(d for d in dicts if d is not None)
            dictionary, tables = union_many(
                [d if d is not None else fallback for d in dicts]
            )
        else:
            dictionary, tables = None, [None] * len(batches)
        any_valid = any(
            b is not None and b.width and b.columns[ch].valid is not None
            for b in batches
        )
        is_long_dec = isinstance(types[ch], DecimalType) and types[ch].is_long
        # array/map columns: every worker padded to the widest element width
        parts = [
            None if b is None or not b.width else b.columns[ch] for b in batches
        ]
        any_lengths = any(c is not None and c.lengths is not None for c in parts)
        if any_lengths:
            padded = iter(pad_elements([c.to("cpu") for c in parts if c is not None]))
            parts = [None if c is None else next(padded) for c in parts]
            k = next(c.data.shape[1] for c in parts if c is not None)
        datas, valids, lens = [], [], []
        for wi, c in enumerate(parts):
            if c is None:
                shape = (cap, k) if any_lengths else (cap, 2) if is_long_dec else (cap,)
                datas.append(np.zeros(shape, dtype=types[ch].np_dtype))
                valids.append(np.zeros(cap, dtype=bool))
                lens.append(np.zeros(cap, dtype=np.int32))
                continue
            data = c.data.cpu().numpy()
            if is_long_dec and data.ndim == 1:
                # short-valued rows under a long type: widen to limb planes
                data = np.stack([data >> 63, data], axis=-1)
            if tables[wi] is not None:
                data = np.asarray(tables[wi])[data.astype(np.int64)].astype(data.dtype)
            datas.append(_pad_host(data, cap))
            v = (
                c.valid.cpu().numpy()
                if c.valid is not None
                else np.ones(data.shape[0], dtype=bool)
            )
            valids.append(_pad_host(v, cap))
            if any_lengths:
                lens.append(_pad_host(c.lengths.cpu().numpy().astype(np.int32), cap))
        data_t = torch.from_numpy(np.stack(datas)).to(wm.device)
        valid_t = torch.from_numpy(np.stack(valids)).to(wm.device) if any_valid else None
        lengths_t = torch.from_numpy(np.stack(lens)).to(wm.device) if any_lengths else None
        cols.append(Column(data_t, types[ch], valid_t, dictionary, lengths_t))
    masks = []
    for b in batches:
        if b is None or not b.width:
            masks.append(np.zeros(cap, dtype=bool))
        else:
            masks.append(_pad_host(b.mask().cpu().numpy(), cap, fill=False))
    return Batch(cols, torch.from_numpy(np.stack(masks)).to(wm.device))


def unstack_batch(stacked: Batch) -> Batch:
    """[W, cap] stacked batch -> one flat Batch [W*cap] on the same device
    (the gather-to-coordinator exchange: the coordinator's local engine
    runs on the mesh's device, so the rows need not leave it)."""
    # keep the trailing element (or limb) axis of array, map and long
    # decimal columns
    cols = [
        c.map_rows(lambda t: t.reshape((-1,) + tuple(t.shape[2:])))
        for c in stacked.columns
    ]
    return Batch(cols, stacked.row_mask.reshape(-1))


# -- per-worker steps ---------------------------------------------------------


def spmd_step(wm: WorkerMesh, step: Callable) -> Callable:
    """Lift a per-worker Batch step to the stacked layout: `step` sees one
    worker's shard of every argument and returns one value; the results of
    the W workers are stacked."""

    def run(*args):
        return stack_shards(
            [step(*(shard(a, w) for a in args)) for w in range(wm.n)]
        )

    return run


#: per-thread launch hook: while a mesh statement runs, the stage executor
#: routes every cached step's launch through it (its cancel check and phase
#: timing); None runs the step directly
_LAUNCH = threading.local()


def set_launch_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install `hook(fn, args, phase)` for this thread; returns the one it
    replaces."""
    prev = getattr(_LAUNCH, "hook", None)
    _LAUNCH.hook = hook
    return prev


def _launcher(fn: Callable, phase: str) -> Callable:
    def launch(*args):
        hook = getattr(_LAUNCH, "hook", None)
        if hook is None:
            return fn(*args)
        return hook(fn, args, phase)

    return launch


def cached_spmd_step(wm: WorkerMesh, key: tuple, build_step: Callable,
                     collective: bool = False) -> Callable:
    """TRACE_CACHE-backed spmd_step: `build_step()` constructs the step only
    on a cache miss.  A `collective` step sees the whole stacked arguments
    (it moves rows between workers itself).  Launches go through this
    thread's launch hook, as phase `collective` or `compute`."""
    fn = TRACE_CACHE.get(
        ("spmd", collective, mesh_key(wm)) + tuple(key),
        lambda: build_step() if collective else spmd_step(wm, build_step()),
    )
    return _launcher(fn, "collective" if collective else "compute")

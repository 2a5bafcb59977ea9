"""Collective exchange kernels (the data plane) over logical workers.

Port of trino_tpu/parallel/exchange.py.  Reference roles: the
PartitionedOutputOperator/PagePartitioner + ExchangeOperator pair becomes a
hash-bucketize + all-to-all; BroadcastOutputBuffer becomes an all-gather.
All W logical workers share one device, so both collectives are
permutations of the stacked [W, cap] tensors, done for every worker at once:

  * all-to-all: each source worker scatters its rows into [W_dst, slot]
    pieces; `transpose(0, 1)` of the stacked [W_src, W_dst, slot] pieces and
    a reshape give [W_dst, W_src * slot] — the JAX package's
    `all_to_all(split_axis=0, concat_axis=0)` order, source-major;
  * all-gather: [W, cap] -> one [W * cap] row set, seen by every worker.

The row hash is bit-equal to the JAX package's uint64 hash, computed on
int64 tensors holding the same bit patterns: wrapping multiplication is the
same, `>>` is made logical by masking, and the destination `h % W` is the
unsigned remainder.

Shape discipline: the all-to-all needs a static per-destination slot
capacity.  A counts pass reads the [W, W] row counts to the host, which
picks the pow2 slot capacity; the exchange then runs at that capacity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.ops.common import _i64_const, _shr_logical, next_pow2
from trino_tpu_torch.parallel.spmd import WorkerMesh, cached_spmd_step, shard

_MIX = np.uint64(0x9E3779B97F4A7C15)
#: FNV offset basis seeding the row hash; shared with the host-side layout
#: mirror (partitioning/layout.host_bucket_hash) — the two MUST stay equal
HASH_INIT = np.uint64(1469598103934665603)
#: NULL key sentinel (nulls group together, SQL GROUP BY semantics)
_NULL_HASH = 0xDEADBEEF

_MIX_I64 = _i64_const(int(_MIX))
_HASH_INIT_I64 = _i64_const(int(HASH_INIT))


def _hash_rows(batch: Batch, key_channels: Sequence[int], row_ndim: int = 1) -> torch.Tensor:
    """64-bit row hash over key columns (uint64 bit patterns in int64); NULL
    hashes as a distinct constant.  `row_ndim` is the number of row axes:
    1 for a worker's batch, 2 for a stacked [W, cap] batch."""
    mask = batch.mask()
    h = torch.full(mask.shape, _HASH_INIT_I64, dtype=torch.int64, device=mask.device)
    for ch in key_channels:
        c = batch.columns[ch]
        if c.lengths is not None:
            raise NotImplementedError(f"hashing a key of type {c.type.name}")
        v = c.data
        if v.dtype == torch.bool:
            v = v.to(torch.int8)
        # long-decimal limb planes: mix each limb as its own word
        planes = (
            [v[..., i] for i in range(v.shape[-1])] if v.ndim > row_ndim else [v]
        )
        for p in planes:
            bits = p.to(torch.int64)
            if c.valid is not None:
                bits = torch.where(c.valid, bits, _NULL_HASH)
            x = (bits ^ _shr_logical(bits, 33)) * _MIX_I64
            x = x ^ _shr_logical(x, 29)
            h = (h ^ x) * _MIX_I64
    return h


def unsigned_mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """`h % n` with h read as uint64 (torch's int64 floor-mod differs for a
    negative h whenever n is not a power of two)."""
    return ((_shr_logical(h, 1) % n) * 2 + (h & 1)) % n


def _destinations(stacked: Batch, key_channels, n_workers: int) -> torch.Tensor:
    """[W, cap] destination worker of every row; dead rows get n_workers."""
    h = _hash_rows(stacked, key_channels, row_ndim=2)
    return torch.where(stacked.mask(), unsigned_mod(h, n_workers), n_workers)


def _counts(stacked: Batch, key_channels, n_workers: int) -> torch.Tensor:
    """[W, W] rows each source worker sends to each destination."""
    dest = _destinations(stacked, key_channels, n_workers)
    w = dest.shape[0]
    counts = torch.zeros((w, n_workers + 1), dtype=torch.int64, device=dest.device)
    counts.scatter_add_(1, dest, torch.ones_like(dest))
    return counts[:, :n_workers]


def _exchange(stacked: Batch, key_channels, n_workers: int, slot_cap: int) -> Batch:
    """Bucketize every worker's rows by destination (stable, dead rows
    last) into [W_dst, slot_cap] pieces, then the all-to-all."""
    dest = _destinations(stacked, key_channels, n_workers)
    w, cap = dest.shape
    dev = dest.device
    order = torch.sort(dest, dim=1, stable=True).indices
    d_sorted = torch.gather(dest, 1, order)
    pos = torch.arange(cap, dtype=torch.int64, device=dev).expand(w, cap)
    # slot within destination = position - first position of that dest
    first = torch.full(
        (w, n_workers + 1), cap, dtype=torch.int64, device=dev
    ).scatter_reduce_(1, d_sorted, pos, "amin", include_self=True)
    slot = pos - torch.gather(first, 1, d_sorted)
    valid_slot = torch.logical_and(d_sorted < n_workers, slot < slot_cap)
    dump = n_workers * slot_cap
    flat = torch.where(valid_slot, d_sorted * slot_cap + slot, dump)
    rows = torch.arange(w, device=dev)[:, None]

    def move(x: torch.Tensor, fill) -> torch.Tensor:
        """[W_src, cap, ...] -> [W_dst, W_src * slot_cap, ...]: scatter into
        the destination pieces (the spare slot takes dropped rows), then
        the transpose that is the all-to-all."""
        trail = tuple(x.shape[2:])
        out = torch.full((w, dump + 1) + trail, fill, dtype=x.dtype, device=dev)
        out[rows, flat] = x[rows, order]
        out = out[:, :dump].reshape((w, n_workers, slot_cap) + trail)
        return out.transpose(0, 1).reshape((n_workers, w * slot_cap) + trail)

    cols = [
        Column(
            move(c.data, 0),
            c.type,
            None if c.valid is None else move(c.valid, False),
            c.dictionary,
            None if c.lengths is None else move(c.lengths, 0),
        )
        for c in stacked.columns
    ]
    return Batch(cols, move(stacked.mask(), False))


def exchange_slot_cap(stacked: Batch, key_channels: Sequence[int], wm: WorkerMesh) -> int:
    """Phase 1 of the two-step exchange: the counts pass, one tiny [W, W]
    host read, and the pow2 slot-capacity bucket."""
    from trino_tpu_torch.runtime.lifecycle import check_current

    counts = _counts(stacked, tuple(key_channels), wm.n)
    slot_cap = next_pow2(max(1, int(counts.max())), floor=64)
    # cancellation point: the counts read waited for the producer's device
    # work, so a deadline that passed meanwhile stops the exchange here
    check_current()
    return slot_cap


def fused_repartition(
    stacked: Batch,
    key_channels: Sequence[int],
    wm: WorkerMesh,
    consumer=None,
    key: tuple = (),
    slot_cap: Optional[int] = None,
) -> Batch:
    """Hash-repartition a stacked [W, cap] batch so equal keys land on the
    same worker, then (when given) run the consumer's per-worker step on
    what each worker received.  Returns a stacked [W, W * slot_cap] batch —
    or the consumer's output.  `key` fingerprints the consumer for the
    step cache."""
    assert consumer is None or key, "a fused consumer needs a cache key"
    if slot_cap is None:
        slot_cap = exchange_slot_cap(stacked, key_channels, wm)
    chans = tuple(key_channels)

    def build():
        def run(st: Batch):
            out = _exchange(st, chans, wm.n, slot_cap)
            if consumer is None:
                return out
            from trino_tpu_torch.parallel.spmd import stack_shards

            return stack_shards([consumer(shard(out, w)) for w in range(wm.n)])

        return run

    fn = cached_spmd_step(
        wm, ("fused_exchange", chans, slot_cap) + tuple(key), build,
        collective=True,
    )
    return fn(stacked)


def repartition(stacked: Batch, key_channels: Sequence[int], wm: WorkerMesh) -> Batch:
    """Hash-repartition a stacked [W, cap] batch so equal keys land on the
    same worker.  Returns a stacked [W, W * slot_cap] batch."""
    return fused_repartition(stacked, key_channels, wm)


def broadcast(stacked: Batch, wm: WorkerMesh) -> Batch:
    """Replicate every worker's rows to all workers (the all-gather):
    stacked [W, cap] -> stacked [W, W * cap].  The W copies are one
    expanded view of the gathered rows, not W copies in memory."""

    def bcast(x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape((-1,) + tuple(x.shape[2:]))
        return flat.unsqueeze(0).expand((wm.n,) + tuple(flat.shape))

    cols = [c.map_rows(bcast) for c in stacked.columns]
    return Batch(cols, bcast(stacked.mask()))

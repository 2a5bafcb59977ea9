"""Exchange wire format for the multi-host data plane, and host-side row
hashing and partitioning.

Port of trino_tpu/parallel/serde.py (reference roles: PagesSerde, the
page serializer of HTTP exchanges between workers, and
InterpretedHashGenerator for partitioned exchanges).  A page set on the
wire is a zlib (level 1) pickle of host numpy planes (data, validity,
array lengths, the live-row mask), column types and dictionary payloads,
the JAX package's format.  Everything here runs on the host over batches
of CPU tensors: `batches_to_bytes` reads CPU batches (the caller moves a
task's output off the card once, `Batch.to("cpu")`) and `bytes_to_batches`
returns CPU batches, which the consumer moves to its own device.  A long
decimal travels as its [n, 2] limb plane, an array column as its
[rows, K] block plus lengths, a timestamp with time zone as its packed
int64.  The spill tier partitions its waves by the value hash below,
which is process-stable and bit-equal to the JAX package's.

Difference from the JAX package: a long-decimal key column (an [n, 2]
limb plane) hashes as its two limbs, high then low, each mixed like a
column of its own; the JAX package's hash raises a broadcasting error on
such a key.  Every other key hashes bit for bit as there.
"""

from __future__ import annotations

import pickle
import threading
import zlib
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column, StringDictionary


def _dict_payload(d):
    """Wire form of a column dictionary: a `("ref", key, version)` global
    dictionary ref when the service knows the assignment (global codes ship
    with no value bytes), else the value tuple."""
    if d is None:
        return None
    from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE

    ref = DICTIONARY_SERVICE.ref_of(d)
    if ref is not None:
        key, version = ref
        return ("ref", key, version)
    return tuple(d.values)


def _dict_restore(payload):
    if payload is None:
        return None
    if (
        isinstance(payload, tuple)
        and len(payload) == 3
        and payload[0] == "ref"
        and isinstance(payload[1], tuple)  # a real values tuple holds strings
    ):
        from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE

        # resolve raises on an unresolvable ref: decoding through a wrong
        # dictionary would give wrong results silently
        return DICTIONARY_SERVICE.resolve(payload[1], payload[2])
    return StringDictionary(list(payload))


def _np(t) -> np.ndarray:
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _opt_np(t):
    return None if t is None else _np(t)


def _opt_tensor(a):
    return None if a is None else torch.from_numpy(a)


def batches_to_bytes(batches: Sequence[Batch]) -> bytes:
    """Serialize host batches (CPU tensors; a batch on the card raises)."""
    doc = []
    for b in batches:
        cols = []
        for c in b.columns:
            cols.append(
                {
                    "data": _np(c.data),
                    "valid": _opt_np(c.valid),
                    "lengths": _opt_np(c.lengths),
                    "type": c.type,
                    "dict": _dict_payload(c.dictionary),
                }
            )
        doc.append({"cols": cols, "mask": _np(b.mask())})
    return zlib.compress(pickle.dumps(doc, protocol=pickle.HIGHEST_PROTOCOL), 1)


def bytes_to_batches(payload: bytes) -> list:
    """The batches of one page set, as CPU batches."""
    doc = pickle.loads(zlib.decompress(payload))
    out = []
    for b in doc:
        cols = []
        for c in b["cols"]:
            d = _dict_restore(c["dict"])
            cols.append(
                Column(
                    torch.from_numpy(c["data"]), c["type"],
                    _opt_tensor(c["valid"]), d, _opt_tensor(c["lengths"]),
                )
            )
        out.append(Batch(cols, torch.from_numpy(b["mask"])))
    return out


#: id(dictionary) -> (dictionary, crc32 of every value): a wave re-hashes
#: the same dictionaries once per chunk and wave, and a dictionary's table
#: costs a pass over its values (a lazy dictionary materializes them).  The
#: entry pins its dictionary, so the id stays valid while it is cached.
_VALUE_HASHES: "OrderedDict[int, tuple]" = OrderedDict()
_VALUE_HASHES_LIMIT = 256
_VALUE_HASHES_LOCK = threading.Lock()


def _value_hashes(d) -> np.ndarray:
    """crc32 of each dictionary value, as uint64 (the key hash of a string)."""
    with _VALUE_HASHES_LOCK:
        hit = _VALUE_HASHES.get(id(d))
        if hit is not None and hit[0] is d:
            _VALUE_HASHES.move_to_end(id(d))
            return hit[1]
    values = d.values
    table = np.fromiter(
        (zlib.crc32(v.encode() if isinstance(v, str) else bytes(v)) for v in values),
        dtype=np.uint64,
        count=len(values),
    )
    with _VALUE_HASHES_LOCK:
        _VALUE_HASHES[id(d)] = (d, table)
        while len(_VALUE_HASHES) > _VALUE_HASHES_LIMIT:
            _VALUE_HASHES.popitem(last=False)
    return table


def _mix(acc: np.ndarray, h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer of one word per row, folded into `acc`."""
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h = h ^ (h >> np.uint64(31))
    return acc * np.uint64(31) + h


def stable_row_hash(batch: Batch, channels: Sequence[int]) -> np.ndarray:
    """Process-stable uint64 hash of the key columns' VALUES of a host
    batch (dictionary codes are producer-local, so strings hash by value,
    gathered by code).  NULL hashes as 0 before mixing."""
    n = batch.capacity
    acc = np.full(n, 0x9E3779B97F4A7C15, dtype=np.uint64)
    for ch in channels:
        c = batch.columns[ch]
        if c.lengths is not None:
            raise NotImplementedError(f"hashing a key of type {c.type.name}")
        data = _np(c.data)
        if c.dictionary is not None:
            table = _value_hashes(c.dictionary)
            words = [table[np.clip(data.astype(np.int64), 0, len(table) - 1)]]
        elif data.dtype == np.bool_:
            words = [data.astype(np.uint64)]
        elif data.dtype.kind == "f":
            # canonicalize before viewing bits: -0.0 == 0.0, and every NaN
            # payload lands in one bucket
            f = data.astype(np.float64) + 0.0
            f = np.where(np.isnan(f), np.float64(np.nan), f)
            words = [f.view(np.uint64).copy()]
        elif data.ndim == 2:
            # long-decimal limb plane: the high limb, then the low limb
            words = [
                data[:, i].astype(np.int64).view(np.uint64).copy()
                for i in range(data.shape[1])
            ]
        else:
            words = [data.astype(np.int64).view(np.uint64).copy()]
        for h in words:
            if c.valid is not None:
                h = np.where(_np(c.valid), h, np.uint64(0))
            acc = _mix(acc, h)
    return acc


def partition_batches(
    batches: Sequence[Batch], channels: Sequence[int], n: int
) -> list:
    """Split host batches into n bucket lists by key hash (live rows only,
    each bucket's batches dense)."""
    buckets: list = [[] for _ in range(n)]
    for b in batches:
        h = stable_row_hash(b, channels)
        mask = _np(b.mask())
        part = (h % np.uint64(n)).astype(np.int64)
        cols = [
            tuple(None if x is None else _np(x) for x in (c.data, c.valid, c.lengths))
            for c in b.columns
        ]
        for i in range(n):
            keep = mask & (part == i)
            if not keep.any():
                continue
            idx = np.nonzero(keep)[0]
            out = [
                Column(
                    torch.from_numpy(data[idx]),
                    c.type,
                    None if valid is None else torch.from_numpy(valid[idx]),
                    c.dictionary,
                    None if lengths is None else torch.from_numpy(lengths[idx]),
                )
                for (data, valid, lengths), c in zip(cols, b.columns)
            ]
            buckets[i].append(Batch(out, torch.ones(len(idx), dtype=torch.bool)))
    return buckets

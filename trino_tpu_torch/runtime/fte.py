"""Fault-tolerant execution: spooled stage outputs and attempt dedup.

Port of trino_tpu/runtime/fte.py (reference:
EventDrivenFaultTolerantQueryScheduler — stage-by-stage execution with
replayable intermediates; ExchangeManager + plugin/trino-exchange-filesystem
— spooled exchange storage; DeduplicatingDirectExchangeBuffer —
exactly-once consumption of duplicate task attempts).

A "task" is one fragment execution over the mesh; its output (a stacked
batch) is the replayable unit.  The spool persists fragment outputs as
host-side npz files keyed by ``(query_id, fragment_id, attempt_id)``
through the filesystem SPI (filesystem.py), so a failed downstream
fragment retries WITHOUT re-running its finished children.  Writes are
crash-atomic: the npz streams into a ``.tmp`` sibling that is renamed into
place, so a writer killed mid-save never leaves a torn ``.npz`` that a
retrying consumer would load.  Duplicate attempt outputs are deduplicated
at the CONSUMER: ``AttemptDedup`` commits exactly one attempt per
fragment, and every other attempt's output is discarded unread.  The
spill tier (runtime/spill.py) rides the same spool with attempt 0.

Batches given to the spool hold CPU tensors; loaded batches hold CPU
tensors too.  The heartbeat failure detector lives in runtime/membership
(one implementation, sticky death, breaker integration); the alias below
keeps this module's import surface, as in the JAX module.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

# the ONE heartbeat failure detector (runtime/membership); re-exported here
# for the module's historical import surface
from trino_tpu_torch.runtime.membership import (  # noqa: F401
    HeartbeatFailureDetector,
)

#: spool files older than this are orphans of a crashed process; swept on
#: construction of any manager sharing the directory
SPOOL_ORPHAN_MAX_AGE_S = 6 * 3600.0

#: committed spool filename shape: {query_id}_f{fid}.npz for attempt 0
#: (the name the spill tier uses) and {query_id}_f{fid}_a{attempt}.npz for
#: retry attempts
_ATTEMPT_RE = re.compile(r"_f(\d+)(?:_a(\d+))?\.npz$")


def _np(t) -> np.ndarray:
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


class AttemptDedup:
    """Consumer-side exactly-once attempt selection (reference:
    DeduplicatingDirectExchangeBuffer): duplicate task attempts may each
    spool an output for the same ``(query_id, fragment_id)``; the FIRST
    attempt a consumer commits wins, every consumer thereafter reads that
    same attempt, and the duplicates are discarded unread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._committed: dict[tuple, int] = {}

    def commit(self, query_id: str, fragment_id: int, attempt_id: int) -> int:
        """Commit an attempt for consumption; returns the attempt EVERY
        consumer must read (the first committed one — a later attempt's
        commit is a no-op and is told which attempt won)."""
        key = (query_id, int(fragment_id))
        with self._lock:
            return self._committed.setdefault(key, int(attempt_id))

    def committed(self, query_id: str, fragment_id: int) -> Optional[int]:
        with self._lock:
            return self._committed.get((query_id, int(fragment_id)))

    def clear(self, query_id: str) -> None:
        with self._lock:
            for key in [k for k in self._committed if k[0] == query_id]:
                del self._committed[key]


class SpoolManager:
    """Persist per-fragment outputs (lists of host batches) to local files
    (reference role: FileSystemExchangeManager /
    LocalFileSystemExchangeStorage).  A manager given no directory makes
    its own temporary one (`trino_tpu_torch_spool_*`) and deletes it at
    `close`."""

    def __init__(
        self,
        directory: Optional[str] = None,
        orphan_max_age_s: float = SPOOL_ORPHAN_MAX_AGE_S,
        clock: Callable[[], float] = time.time,
    ):
        from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

        self._own = directory is None
        self.clock = clock
        self.fs = filesystem_for(directory)
        self.dir = strip_scheme(
            directory or tempfile.mkdtemp(prefix="trino_tpu_torch_spool_")
        )
        self.fs.mkdirs(self.dir)
        #: exactly-once attempt selection for this spool's consumers
        self.dedup = AttemptDedup()
        if not self._own:
            # a SHARED directory accumulates the {qid}_f{fid}[_a{n}].npz
            # files of processes that crashed before close(); sweep them by
            # age
            self.gc(orphan_max_age_s)

    def _path(self, query_id: str, fragment_id: int, attempt_id: int = 0) -> str:
        suffix = f"_a{attempt_id}" if attempt_id else ""
        return os.path.join(self.dir, f"{query_id}_f{fragment_id}{suffix}.npz")

    def save(self, query_id: str, fragment_id: int, batches, symbols,
             attempt_id: int = 0) -> str:
        """Spool host batches (CPU tensors) for one fragment attempt,
        crash-atomic; returns the committed path."""
        arrays: dict = {"__nbatches__": np.asarray(len(batches))}
        for bi, b in enumerate(batches):
            arrays[f"b{bi}_mask"] = _np(b.mask())
            for ci, c in enumerate(b.columns):
                arrays[f"b{bi}_c{ci}_data"] = _np(c.data)
                if c.valid is not None:
                    arrays[f"b{bi}_c{ci}_valid"] = _np(c.valid)
                if c.lengths is not None:
                    # array/map columns: the per-row element counts ride
                    # along, so a spooled batch rehydrates exactly
                    arrays[f"b{bi}_c{ci}_len"] = _np(c.lengths)
        path = self._path(query_id, fragment_id, attempt_id)
        tmp = path + ".tmp"
        try:
            with self.fs.open_output(tmp) as f:  # streaming: no double buffer
                np.savez(f, **arrays)
        except BaseException:
            # a failed write must not leave the torn sibling behind
            try:
                self.fs.delete(tmp)
            except OSError:
                pass
            raise
        self.fs.rename(tmp, path)
        return path

    def load(self, query_id: str, fragment_id: int, symbols, dictionaries,
             attempt_id: int = 0):
        """Rehydrate one attempt's spooled batches as CPU tensors (schema
        from `symbols`); None when nothing was spooled.  `dictionaries` is
        checked against the stored codes: a stale or mis-keyed dictionary
        list would decode codes into the wrong strings silently — a clear
        error at load beats corrupt results downstream."""
        from trino_tpu_torch.columnar import Batch, Column

        path = self._path(query_id, fragment_id, attempt_id)
        if not self.fs.exists(path):
            return None
        if len(dictionaries) != len(symbols):
            raise ValueError(
                f"spool load {query_id}/f{fragment_id}: {len(dictionaries)} "
                f"dictionaries for {len(symbols)} columns"
            )
        with self.fs.open_input(path) as f:
            z = np.load(f, allow_pickle=False)
            out = []
            for bi in range(int(z["__nbatches__"])):
                cols = []
                mask = z[f"b{bi}_mask"]
                for ci, sym in enumerate(symbols):
                    data = z[f"b{bi}_c{ci}_data"]
                    vkey = f"b{bi}_c{ci}_valid"
                    valid = z[vkey] if vkey in z.files else None
                    lkey = f"b{bi}_c{ci}_len"
                    lengths = torch.from_numpy(z[lkey]) if lkey in z.files else None
                    d = dictionaries[ci]
                    if d is not None and data.size:
                        live = mask.astype(bool)
                        if valid is not None:
                            live = live & valid.astype(bool)
                        codes = data[live]
                        if codes.size and int(codes.max()) >= len(d):
                            raise ValueError(
                                f"spool load {query_id}/f{fragment_id} column "
                                f"{sym.name}: stored code {int(codes.max())} out "
                                f"of range for dictionary of {len(d)} values — "
                                "the dictionary list does not match the spooled "
                                "batches"
                            )
                    cols.append(
                        Column(
                            torch.from_numpy(data), sym.type,
                            None if valid is None else torch.from_numpy(valid), d,
                            lengths,
                        )
                    )
                out.append(Batch(cols, torch.from_numpy(mask)))
        return out

    def exists(self, query_id: str, fragment_id: int, attempt_id: int = 0) -> bool:
        return self.fs.exists(self._path(query_id, fragment_id, attempt_id))

    def attempts(self, query_id: str, fragment_id: int) -> list:
        """Committed (fully renamed) attempt ids spooled for a fragment,
        ascending.  ``.tmp`` siblings are invisible by construction: an
        attempt appears here only after its atomic rename."""
        prefix = f"{query_id}_f"
        out = []
        for p in list(self.fs.list(self.dir)):
            name = os.path.basename(p)
            if not name.startswith(prefix):
                continue
            m = _ATTEMPT_RE.search(name)
            if m is None or int(m.group(1)) != int(fragment_id):
                continue
            out.append(int(m.group(2) or 0))
        return sorted(out)

    def discard_duplicates(self, query_id: str, fragment_id: int,
                           keep_attempt: int) -> int:
        """Delete every spooled attempt EXCEPT the committed one (the
        DeduplicatingDirectExchangeBuffer discard: duplicate outputs must
        never be consumed, and holding them costs spool volume).  Returns
        the number of duplicates removed."""
        removed = 0
        for att in self.attempts(query_id, fragment_id):
            if att == keep_attempt:
                continue
            try:
                self.fs.delete(self._path(query_id, fragment_id, att))
                removed += 1
            except OSError:
                continue
        return removed

    def gc(self, max_age_s: float) -> list:
        """Delete spool files not modified within `max_age_s` seconds;
        returns the paths removed.  Only files the spool writes are
        touched (``.npz`` and torn ``.npz.tmp`` siblings)."""
        cutoff = self.clock() - max_age_s
        removed = []
        for p in list(self.fs.list(self.dir)):
            if not (p.endswith(".npz") or p.endswith(".npz.tmp")):
                continue
            try:
                if self.fs.mtime(p) < cutoff:
                    self.fs.delete(p)
                    removed.append(p)
            except OSError:
                continue  # deleted concurrently by another manager's sweep
        return removed

    def close(self) -> None:
        """Remove the spool's directory when this manager created it."""
        if self._own:
            for p in list(self.fs.list(self.dir)):
                self.fs.delete(p)
            self.fs.delete_recursive(self.dir)

"""Spooled host batches: the npz spool the spill tier rides on.

Port of the SpoolManager of trino_tpu/runtime/fte.py (reference role:
FileSystemExchangeManager / LocalFileSystemExchangeStorage).  A spool
persists lists of host batches as npz files keyed by ``(id, fragment)``
through the filesystem SPI (filesystem.py).  Writes are crash-atomic: the
npz streams into a ``.tmp`` sibling that is renamed into place, so a
writer killed mid-save never leaves a torn ``.npz`` behind.

Batches given to the spool hold CPU tensors; loaded batches hold CPU
tensors too.  Fault-tolerant execution (`AttemptDedup`, task retries,
heartbeats) is not ported yet.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

#: spool files older than this are orphans of a crashed process; swept on
#: construction of any manager sharing the directory
SPOOL_ORPHAN_MAX_AGE_S = 6 * 3600.0


def _np(t) -> np.ndarray:
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


class SpoolManager:
    """Persist lists of host batches to local files."""

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
            directory or tempfile.mkdtemp(prefix="trino_tpu_torch_spill_")
        )
        self.fs.mkdirs(self.dir)
        if not self._own:
            # a SHARED directory accumulates the files of processes that
            # crashed before close(); sweep them by age
            self.gc(orphan_max_age_s)

    def _path(self, query_id: str, fragment_id: int) -> str:
        return os.path.join(self.dir, f"{query_id}_f{fragment_id}.npz")

    def save(self, query_id: str, fragment_id: int, batches, symbols) -> str:
        """Spool host batches (CPU tensors) for one fragment, crash-atomic."""
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
        path = self._path(query_id, fragment_id)
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

    def load(self, query_id: str, fragment_id: int, symbols, dictionaries):
        """Rehydrate spooled batches as CPU tensors (schema from
        `symbols`); None when nothing was spooled.  `dictionaries` is
        checked against the stored codes: a mis-keyed dictionary list would
        decode codes into the wrong strings silently."""
        from trino_tpu_torch.columnar import Batch, Column

        path = self._path(query_id, fragment_id)
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

    def gc(self, max_age_s: float) -> list:
        """Delete spool files not modified within `max_age_s` seconds;
        returns the paths removed.  Only files the spool writes are
        touched."""
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

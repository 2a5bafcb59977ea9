"""Table scan: connector pages -> padded device batches.

Port of trino_tpu/ops/scan.py (reference role: operator/TableScanOperator
.java:47).  A host page is padded to a pow2 capacity in numpy, placed in
page-locked memory and copied to the card asynchronously on the current
stream.  Immutable splits (connector.scan_version != None) are served
through the port's two-tier buffer pool: repeated scans hit batches that
already live on the device; the host tier keeps the padded (pinned) host
batches.  Device-tier keys carry the device, so CPU and CUDA runs in one
process share generated host pages but never device batches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.connectors.api import Connector, Split
from trino_tpu_torch.ops.common import next_pow2
from trino_tpu_torch.types import Type


def page_to_batch(page, types: Sequence[Type]) -> Batch:
    """Pad host ColumnData to a pow2 capacity and build a host (CPU) Batch."""
    n = len(page[0].values) if page else 0
    cap = next_pow2(n)
    cols = []
    for cd, t in zip(page, types):
        data = np.asarray(cd.values, dtype=t.np_dtype)
        if len(data) < cap:
            pad_shape = (cap - len(data),) + data.shape[1:]
            data = np.concatenate([data, np.zeros(pad_shape, dtype=t.np_dtype)])
        valid = None
        if cd.valid is not None:
            v = np.asarray(cd.valid, dtype=bool)
            valid = np.concatenate([v, np.zeros(cap - len(v), dtype=bool)])
        cols.append(Column.from_numpy(data, t, valid, cd.dictionary))
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = True
    return Batch(cols, torch.from_numpy(mask))


class ScanOperator:
    """Streams one split's pages as device batches."""

    def __init__(
        self,
        connector: Connector,
        split: Split,
        column_names: Sequence[str],
        column_types: Sequence[Type],
        device: torch.device,
        page_rows: int = 1 << 17,
        use_cache: bool = True,
    ):
        self.connector = connector
        self.split = split
        self.column_names = list(column_names)
        self.column_types = list(column_types)
        self.device = device
        self.page_rows = page_rows
        self.use_cache = use_cache

    def _cache_key(self):
        """The host tier's key; the device tier appends the device."""
        if not self.use_cache:
            return None
        version = self.connector.scan_version(self.split.table)
        if version is None:
            return None
        from trino_tpu_torch.runtime.buffer_pool import BufferPool

        return BufferPool.split_key(
            self.split, self.column_names, self.page_rows, version
        )

    def _host_batch(self, page) -> Batch:
        """A padded host batch, page-locked whenever a card is present so
        any later copy to it is asynchronous."""
        b = page_to_batch(page, self.column_types)
        return b.pin_memory() if torch.cuda.is_available() else b

    def _to_device(self, b: Batch) -> Batch:
        if self.device.type == "cpu":
            return b
        return b.to(self.device, non_blocking=True)

    def host_batches(self) -> list:
        """The split's padded host batches (the mesh scan stacks them per
        worker itself), served from and kept in the host tier."""
        from trino_tpu_torch.runtime.buffer_pool import POOL

        key = self._cache_key()
        if key is not None:
            host = POOL.get_host(key)
            if host is not None:
                return list(host)
        src = self.connector.page_source(
            self.split, self.column_names, max_rows_per_page=self.page_rows
        )
        out = [page_to_batch(page, self.column_types) for page in src.pages()]
        if key is not None:
            POOL.put_host(key, out)
        return out

    def batches(self):
        from trino_tpu_torch.runtime.buffer_pool import POOL

        key = self._cache_key()
        dev_key = None if key is None else key + (str(self.device),)
        if key is not None:
            cached = POOL.get_device(dev_key)
            if cached is not None:
                yield from cached
                return
            host = POOL.get_host(key)
            if host is not None:
                dev = []
                for b in host:
                    d = self._to_device(b)
                    dev.append(d)
                    yield d
                POOL.put_device(dev_key, dev)
                return
        src = self.connector.page_source(
            self.split, self.column_names, max_rows_per_page=self.page_rows
        )
        host_acc, dev_acc = [], []
        for page in src.pages():
            b = self._host_batch(page)
            d = self._to_device(b)
            if key is not None:
                host_acc.append(b)
                dev_acc.append(d)
            yield d
        if key is not None:
            POOL.put_host(key, host_acc)
            POOL.put_device(dev_key, dev_acc)

"""Hash-bucketed table layouts (reference: connector table layouts /
SystemPartitioningHandle + Hive bucketing).

A TableLayout declares that a table's rows are (or should be) placed by
`hash(bucket_columns) % bucket_count`.  The hash is EXACTLY the exchange
data plane's row hash (`parallel/exchange._hash_rows`), mirrored here on
host numpy, so a scan that shards rows by layout puts every row on the same
worker a hash-repartition exchange on the same keys would have chosen:
co-partitioned scans make the exchange a no-op (`bucket_count` must be a
multiple of the worker count W — then `(h % B) % W == h % W`).

Layouts come from three places, consulted in order by `LayoutResolver`:

  * the `table_layouts` session property (declare layouts on generated
    TPC-H/TPC-DS tables: ``set session table_layouts =
    'tpch.sf1.lineitem:l_orderkey:8,tpch.sf1.orders:o_orderkey:8'``);
  * the process-wide registry (`declare_layout`), fed by
    ``CREATE TABLE ... WITH (bucketed_by = ARRAY['x'], bucket_count = 8)``;
  * the connector itself (`Connector.table_layout`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from trino_tpu_torch import types as T


@dataclass(frozen=True)
class TableLayout:
    """Declared hash-bucketing of one table."""

    bucket_columns: tuple
    bucket_count: int

    def __str__(self):
        return f"bucketed_by=[{', '.join(self.bucket_columns)}] buckets={self.bucket_count}"


#: process-wide declared layouts: (catalog, schema, table) -> TableLayout
GLOBAL_LAYOUTS: dict[tuple, TableLayout] = {}


def declare_layout(qualified, bucket_columns, bucket_count: int) -> TableLayout:
    """Register a layout for `catalog.schema.table` (string or 3-tuple)."""
    if isinstance(qualified, str):
        parts = tuple(qualified.split("."))
    else:
        parts = tuple(qualified)
    if len(parts) != 3:
        raise ValueError(f"layout table must be catalog.schema.table: {qualified!r}")
    cols = tuple(str(c) for c in bucket_columns)
    n = int(bucket_count)
    if not cols or n <= 0:
        raise ValueError("a layout needs bucket columns and a positive bucket_count")
    layout = TableLayout(cols, n)
    GLOBAL_LAYOUTS[parts] = layout
    return layout


def drop_layout(qualified) -> None:
    parts = tuple(qualified.split(".")) if isinstance(qualified, str) else tuple(qualified)
    GLOBAL_LAYOUTS.pop(parts, None)


def parse_layout_property(text: str) -> dict:
    """Parse the `table_layouts` session property:
    ``cat.schema.table:col1+col2:bucket_count`` entries, comma-separated."""
    out: dict[tuple, TableLayout] = {}
    for entry in (text or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad table_layouts entry {entry!r} "
                "(want catalog.schema.table:col1+col2:buckets)"
            )
        name = tuple(parts[0].strip().split("."))
        if len(name) != 3:
            raise ValueError(f"bad table name in table_layouts entry {entry!r}")
        cols = tuple(c.strip() for c in parts[1].split("+") if c.strip())
        out[name] = TableLayout(cols, int(parts[2]))
    return out


class LayoutResolver:
    """handle -> Optional[TableLayout]; session property wins over the
    process registry, which wins over the connector's own declaration."""

    def __init__(self, catalogs=None, properties=None):
        self.catalogs = catalogs
        self._session: dict[tuple, TableLayout] = {}
        #: whether plan claims may lean on the global dictionary service
        #: (the `global_dictionaries` session property; default on)
        self.global_dicts = True
        if properties is not None:
            try:
                self._session = parse_layout_property(
                    properties.get("table_layouts")
                )
            except KeyError:  # older property sets
                self._session = {}
            try:
                self.global_dicts = bool(properties.get("global_dictionaries"))
            except KeyError:  # older property sets
                pass

    def __call__(self, handle) -> Optional[TableLayout]:
        key = (handle.catalog, handle.schema, handle.table)
        hit = self._session.get(key) or GLOBAL_LAYOUTS.get(key)
        if hit is not None:
            return hit
        if self.catalogs is not None:
            try:
                conn = self.catalogs.get(handle.catalog)
            except KeyError:
                return None
            return conn.table_layout(handle)
        return None


def hashable_layout_type(t) -> bool:
    """Types whose host hash provably mirrors the device exchange hash:
    plain integer-kind columns (bigint/int/date/short decimal).  Strings
    ride as producer-local dictionary codes and long decimals as limb
    planes — both excluded."""
    if T.is_string_kind(t):
        return False
    if isinstance(t, T.DecimalType) and t.is_long:
        return False
    return np.issubdtype(t.np_dtype, np.integer)


def scan_partitioning(node, resolver, n_workers: int):
    """The ONE eligibility rule for layout-aligned scans, shared by the
    planner's property derivation, the fragmenter's handle printing, and
    the runner's bucketized scan (so plan- and run-time claims can never
    diverge).  Returns (layout, partition symbol names, key channels) or
    None when `node` (a TableScanNode) has no usable layout."""
    if resolver is None:
        return None
    layout = resolver(node.handle)
    if layout is None:
        return None
    if n_workers <= 0 or layout.bucket_count % n_workers != 0:
        return None
    by_col = {c: (i, s) for i, (s, c) in enumerate(node.assignments)}
    names = []
    channels = []
    for col in layout.bucket_columns:
        hit = by_col.get(col)
        if hit is None:
            return None  # bucket column not scanned: cannot place by it
        ch, sym = hit
        if not hashable_layout_type(sym.type):
            if not _globally_coded_column(node.handle, col, sym.type, resolver):
                return None
        names.append(sym.name)
        channels.append(ch)
    return layout, tuple(names), tuple(channels)


def _globally_coded_column(handle, column, t, resolver) -> bool:
    """A string bucket column is layout-usable iff its codes are one
    versioned mesh-global assignment (runtime/dictionary_service): the
    host/device hash then runs over codes that mean the same thing on
    every worker, so `(h % B) % W == h % W` places by VALUE exactly like
    an integer key.  Producer-local dictionaries stay excluded."""
    if not T.is_string_kind(t):
        return False
    if not getattr(resolver, "global_dicts", True):
        return False
    from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE

    return (
        DICTIONARY_SERVICE.coding(
            handle, column, getattr(resolver, "catalogs", None)
        )
        is not None
    )


def host_bucket_hash(columns, valids, cap: int) -> np.ndarray:
    """Numpy mirror of `parallel/exchange._hash_rows` over integer-kind key
    columns: identical FNV init, splitmix-style word mixing, and the NULL
    sentinel, so `host_bucket_hash(...) % W` equals the device exchange's
    destination for every row."""
    from trino_tpu_torch.parallel.exchange import _MIX, _NULL_HASH, HASH_INIT

    h = np.full(cap, HASH_INIT, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for data, valid in zip(columns, valids):
            bits = np.asarray(data).astype(np.int64).astype(np.uint64)
            if valid is not None:
                bits = np.where(np.asarray(valid), bits, np.uint64(_NULL_HASH))
            x = (bits ^ (bits >> np.uint64(33))) * _MIX
            x = x ^ (x >> np.uint64(29))
            h = (h ^ x) * _MIX
    return h


def bucket_rows(batch, key_channels, n_workers: int) -> np.ndarray:
    """Worker destination of every live row of a HOST batch under the
    layout hash; dead rows get destination `n_workers`."""
    cols = [np.asarray(batch.columns[ch].data) for ch in key_channels]
    valids = [
        None if batch.columns[ch].valid is None else np.asarray(batch.columns[ch].valid)
        for ch in key_channels
    ]
    cap = cols[0].shape[0] if cols else len(np.asarray(batch.mask()))
    h = host_bucket_hash(cols, valids, cap)
    dest = (h % np.uint64(n_workers)).astype(np.int64)
    return np.where(np.asarray(batch.mask()), dest, n_workers)

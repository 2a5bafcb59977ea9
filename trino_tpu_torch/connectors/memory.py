"""In-RAM connector (reference: plugin/trino-memory — MemoryPagesStore).

Port of trino_tpu/connectors/memory.py.  The test workhorse: CREATE TABLE /
INSERT land host-side numpy columns; scans serve them back as pages, which
the scan operator stages onto the device like any other connector's.
Supports the engine's write path (page_sink) so CTAS and INSERT tests run
against it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from trino_tpu_torch.types import Type
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.connectors.api import (
    ColumnData,
    ColumnMeta,
    Connector,
    ConnectorMetadata,
    PageSource,
    Split,
    TableHandle,
    TableMetadata,
    TableStatistics,
)


def stored_nested_error(t) -> NotImplementedError:
    """The error a read of an array or map column stored in a memory table
    raises: the store keeps the [rows, K] element block but not the
    per-row lengths (neither package stores them), so the values cannot be
    read back; the column's type still answers (typeof)."""
    return NotImplementedError(
        f"reading the values of a {t.name} column stored in a memory table "
        "(the store keeps no element lengths): not ported"
    )


@dataclass
class _Stored:
    meta: TableMetadata
    columns: list  # list[ColumnData], concatenated
    #: declared hash-bucketing (CREATE TABLE ... WITH (bucketed_by, ...))
    layout: object = None

    @property
    def rows(self) -> int:
        return len(self.columns[0].values) if self.columns else 0


class MemoryMetadata(ConnectorMetadata):
    def __init__(self, store):
        self.store = store

    def list_schemas(self):
        return sorted({s for s, _ in self.store})

    def list_tables(self, schema: str):
        return sorted(t for s, t in self.store if s == schema)

    def table_metadata(self, schema: str, table: str) -> TableMetadata:
        key = (schema, table)
        if key not in self.store:
            raise KeyError(f"memory table not found: {schema}.{table}")
        return self.store[key].meta

    def table_statistics(self, schema: str, table: str) -> TableStatistics:
        """Exact column stats computed from the stored data (reference:
        MemoryMetadata.getTableStatistics + the ANALYZE flow — here stats are
        always fresh because the data is resident)."""
        from trino_tpu_torch.connectors.api import ColumnStatistics

        key = (schema, table)
        if key not in self.store:
            return TableStatistics()
        stored = self.store[key]
        cols = {}
        for meta, cd in zip(stored.meta.columns, stored.columns):
            v = np.asarray(cd.values)
            mask = (
                np.asarray(cd.valid, dtype=bool)
                if cd.valid is not None
                else np.ones(len(v), dtype=bool)
            )
            live = v[mask]
            nullf = 1.0 - (len(live) / len(v)) if len(v) else 0.0
            if len(live) == 0:
                cols[meta.name] = ColumnStatistics(0.0, nullf)
                continue
            ndv = float(len(np.unique(live)))
            lo = hi = None
            if live.dtype.kind in "iuf" and cd.dictionary is None:
                lo, hi = float(live.min()), float(live.max())
            cols[meta.name] = ColumnStatistics(ndv, nullf, lo, hi)
        return TableStatistics(row_count=stored.rows, columns=cols)


class _MemoryPageSource(PageSource):
    def __init__(self, stored: _Stored, split: Split, columns):
        self.stored = stored
        self.split = split
        self.columns = columns

    def row_count(self) -> int:
        return self.split.row_count

    def pages(self):
        a = self.split.row_start
        b = a + self.split.row_count
        ix = [self.stored.meta.column_index(c) for c in self.columns]
        if not self.stored.columns:  # created but never written: zero rows
            from trino_tpu_torch import types as T
            from trino_tpu_torch.columnar import StringDictionary

            out = []
            for i in ix:
                t = self.stored.meta.columns[i].type
                if T.is_string_kind(t):
                    # string columns always carry a dictionary, even empty
                    out.append(
                        ColumnData(
                            np.zeros(0, dtype=np.int32),
                            None,
                            StringDictionary.from_unsorted([""]),
                        )
                    )
                else:
                    out.append(ColumnData(np.zeros(0, dtype=t.np_dtype)))
            yield out
            return
        yield [
            ColumnData(
                self.stored.columns[i].values[a:b],
                None
                if self.stored.columns[i].valid is None
                else self.stored.columns[i].valid[a:b],
                self.stored.columns[i].dictionary,
            )
            for i in ix
        ]


class _MemorySink:
    def __init__(self, stored: _Stored, handle: TableHandle = None):
        self.stored = stored
        self.handle = handle

    def _extend_dictionary(self, column, old_d, new_d, nv):
        """Append-only dictionary merge (ROADMAP item 4a): the stored
        codes NEVER re-map — only the NEW page recodes against the
        extended value list.  The global dictionary service sees the same
        extension (`extend`: a version bump whose old codes keep their
        meaning, remap=False; NO bump at all when the page introduces no
        new values), so placement claims keyed on the assignment survive
        appends that a sorted-union remap used to invalidate."""
        from trino_tpu_torch.columnar.dictionary import UnorderedDictionary

        old_vals = tuple(old_d.values)
        seen = set(old_vals)
        appended = [v for v in new_d.values if v not in seen]
        merged = (
            old_d
            if not appended
            else UnorderedDictionary(old_vals + tuple(appended))
        )
        index = {v: i for i, v in enumerate(merged.values)}
        rb = np.asarray(
            [index[v] for v in new_d.values], dtype=np.int64
        )
        nv = rb[nv.astype(np.int64)]
        if self.handle is not None:
            from trino_tpu_torch.runtime.dictionary_service import (
                DICTIONARY_SERVICE,
            )

            key = (
                self.handle.catalog, self.handle.schema,
                self.handle.table, column,
            )
            try:
                ent = DICTIONARY_SERVICE.extend(key, list(new_d.values))
                if tuple(ent.dictionary.values) == tuple(merged.values):
                    # the service's epoch IS the merge: store its object
                    # so ref_of resolves the stored dictionary by identity
                    merged = ent.dictionary
            except KeyError:
                pass  # never registered: lazy lookup adopts `merged`
        return merged, nv

    def append(self, columns: Sequence[ColumnData]) -> int:
        st = self.stored
        if not st.columns:
            st.columns = list(columns)
        else:
            merged = []
            for meta, old, new in zip(st.meta.columns, st.columns, columns):
                dictionary = old.dictionary
                ov, nv = old.values, new.values
                if (old.dictionary is None) != (new.dictionary is None):
                    raise TypeError(
                        "cannot append a dictionary-encoded page to a plain "
                        "column (or vice versa)"
                    )
                if old.dictionary is not None:
                    if len(new.dictionary) == 0:
                        # an all-NULL page carries an empty dictionary; its
                        # code payload is masked, nothing to recode
                        nv = np.zeros_like(nv)
                    elif len(old.dictionary) == 0:
                        dictionary = new.dictionary
                        ov = np.zeros_like(ov)
                    else:
                        dictionary, nv = self._extend_dictionary(
                            meta.name, old.dictionary, new.dictionary, nv
                        )
                valid = None
                if old.valid is not None or new.valid is not None:
                    valid = np.concatenate(
                        [
                            old.valid
                            if old.valid is not None
                            else np.ones(len(ov), bool),
                            new.valid
                            if new.valid is not None
                            else np.ones(len(nv), bool),
                        ]
                    )
                merged.append(
                    ColumnData(np.concatenate([ov, nv]), valid, dictionary)
                )
            st.columns = merged
        return len(columns[0].values) if columns else 0


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self):
        self.store: dict[tuple, _Stored] = {}
        self._metadata = MemoryMetadata(self.store)

    def metadata(self):
        return self._metadata

    def supports_writes(self) -> bool:
        return True

    def create_table(self, schema: str, table: str, columns: Sequence[ColumnMeta],
                     layout=None):
        self.store[(schema, table)] = _Stored(
            TableMetadata(schema, table, tuple(columns)), [], layout
        )

    def table_layout(self, handle: TableHandle):
        st = self.store.get((handle.schema, handle.table))
        return st.layout if st is not None else None

    def global_dictionary(self, handle: TableHandle, column: str):
        """The stored dictionary IS the global assignment — every split
        reads the same arrays.  INSERT appends extend it append-only
        (`_MemorySink._extend_dictionary` routes through
        DICTIONARY_SERVICE.extend): existing codes never re-map, a page
        of already-known values bumps NOTHING, and new values take the
        next free codes under a remap=False version bump.  No `unique`
        claim: inserted data carries no structural bijection proof."""
        st = self.store.get((handle.schema, handle.table))
        if st is None:
            return None
        for meta, cd in zip(st.meta.columns, st.columns):
            if meta.name == column:
                if cd.dictionary is None:
                    return None
                return cd.dictionary, False
        return None

    def drop_table(self, handle: TableHandle):
        self.store.pop((handle.schema, handle.table), None)

    def page_sink(self, handle: TableHandle, column_names, column_types):
        key = (handle.schema, handle.table)
        if key not in self.store:
            self.create_table(
                handle.schema,
                handle.table,
                [ColumnMeta(n, t) for n, t in zip(column_names, column_types)],
            )
        return _MemorySink(self.store[key], handle)

    def splits(self, handle: TableHandle, target_splits: int, predicate=None):
        st = self.store[(handle.schema, handle.table)]
        n = st.rows
        nsplits = max(1, min(target_splits, math.ceil(n / 4096))) if n else 1
        per = math.ceil(n / nsplits) if n else 0
        out = []
        for i in range(nsplits):
            a = i * per
            b = min(n, a + per)
            out.append(Split(handle, i, row_start=a, row_count=max(0, b - a)))
            if b >= n:
                break
        return out

    def page_source(self, split: Split, columns, max_rows_per_page: int = 1 << 20):
        st = self.store[(split.table.schema, split.table.table)]
        return _MemoryPageSource(st, split, list(columns))

    # -- transaction snapshots (InMemoryTransactionManager role) -------------

    def snapshot(self):
        """Shallow store snapshot: _MemorySink.append replaces column lists
        (never mutates arrays in place), so copying the table map and each
        table's column list captures a consistent point-in-time view."""
        return {
            key: _Stored(st.meta, list(st.columns), st.layout)
            for key, st in self.store.items()
        }

    def restore(self, snap) -> None:
        self.store.clear()
        self.store.update(snap)

    def snapshot_table(self, schema: str, table: str):
        """Table-granular snapshot (lazy transaction isolation: rollback
        touches only written tables)."""
        from trino_tpu_torch.runtime.transactions import MISSING

        st = self.store.get((schema, table))
        if st is None:
            return MISSING
        return _Stored(st.meta, list(st.columns), st.layout)

    def restore_table(self, schema: str, table: str, snap) -> None:
        from trino_tpu_torch.runtime.transactions import MISSING

        if snap is MISSING:
            self.store.pop((schema, table), None)
        else:
            self.store[(schema, table)] = snap

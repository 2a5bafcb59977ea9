"""Iceberg-analog table format: snapshot-versioned parquet tables.

Reference roles: plugin/trino-iceberg — IcebergPageSourceProvider.java:192
(data files resolved through a snapshot's manifest, read by the parquet
page source), TableStatisticsReader, the `$files`/`$history`/`$snapshots`
metadata tables, and snapshot time travel (`t@<snapshot_id>` addressing).

Layout (the metastore-less analog of Iceberg's metadata tree):

    root/<schema>/<table>/
        metadata/v<N>.json    # snapshot log; highest N is current
        data/<uuid>.parquet   # immutable data files

Every write produces a NEW metadata version whose snapshot lists the FULL
file manifest (Iceberg's manifest-list flattened — simpler, same semantics):
appends extend the parent manifest, CREATE/overwrite starts an empty one.
Old snapshots stay readable: `SELECT * FROM "t@<snapshot_id>"` reads the
manifest as of that snapshot, and DML rewrites (runner-level DELETE/UPDATE
lower to overwrite+append) preserve history instead of destroying data.

Port of trino_tpu/connectors/iceberg.py: the same layout, snapshot log and
metadata tables; data files are written and read by the port's own parquet
writer and reader (`formats/parquet`), so a warehouse that either package
writes, the other reads.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional, Sequence

from trino_tpu_torch import types as T
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
from trino_tpu_torch.formats.parquet.reader import ParquetFile
from trino_tpu_torch.formats.parquet.writer import write_columns

#: metadata-table suffixes (reference: iceberg's $files/$history/$snapshots)
_META_TABLES = ("$files", "$history", "$snapshots")


def _split_name(table: str) -> tuple[str, Optional[int], Optional[str]]:
    """'t@123' -> ('t', 123, None); 't$files' -> ('t', None, '$files')."""
    meta = None
    for suf in _META_TABLES:
        if table.endswith(suf):
            table, meta = table[: -len(suf)], suf
            break
    snap = None
    if "@" in table:
        base, _, tail = table.rpartition("@")
        try:
            snap = int(tail)
            table = base
        except ValueError:
            pass
    return table, snap, meta


class _IcebergMetadata(ConnectorMetadata):
    def __init__(self, conn: "IcebergConnector"):
        self.conn = conn

    def list_schemas(self) -> Sequence[str]:
        root = self.conn.root
        if not os.path.isdir(root):
            return []
        return sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )

    def list_tables(self, schema: str) -> Sequence[str]:
        base = os.path.join(self.conn.root, schema)
        if not os.path.isdir(base):
            return []
        out = []
        for d in sorted(os.listdir(base)):
            if os.path.isdir(os.path.join(base, d, "metadata")):
                out.append(d)
        return out

    def table_metadata(self, schema: str, table: str) -> TableMetadata:
        base, _snap, meta_suffix = _split_name(table)
        if meta_suffix == "$files":
            return TableMetadata(
                schema, table,
                (
                    ColumnMeta("file_path", T.VARCHAR),
                    ColumnMeta("record_count", T.BIGINT),
                    ColumnMeta("snapshot_id", T.BIGINT),
                ),
            )
        if meta_suffix == "$history":
            return TableMetadata(
                schema, table,
                (
                    ColumnMeta("snapshot_id", T.BIGINT),
                    ColumnMeta("parent_id", T.BIGINT),
                    ColumnMeta("made_current_at", T.BIGINT),
                    ColumnMeta("operation", T.VARCHAR),
                ),
            )
        if meta_suffix == "$snapshots":
            return TableMetadata(
                schema, table,
                (
                    ColumnMeta("snapshot_id", T.BIGINT),
                    ColumnMeta("committed_at", T.BIGINT),
                    ColumnMeta("operation", T.VARCHAR),
                    ColumnMeta("file_count", T.BIGINT),
                    ColumnMeta("total_records", T.BIGINT),
                ),
            )
        md = self.conn._load(schema, base)
        cols = tuple(
            ColumnMeta(c["name"], T.parse_type(c["type"]))
            for c in md["columns"]
        )
        return TableMetadata(schema, table, cols)

    def table_statistics(self, schema: str, table: str) -> TableStatistics:
        base, snap, meta_suffix = _split_name(table)
        if meta_suffix:
            return TableStatistics(row_count=None)
        md = self.conn._load(schema, base)
        s = self.conn._snapshot(md, snap)
        return TableStatistics(
            row_count=sum(f["rows"] for f in s["manifest"])
        )


class _RowsPageSource(PageSource):
    """Materialized metadata-table rows."""

    def __init__(self, columns_data: list):
        self._cols = columns_data

    def row_count(self) -> int:
        return len(self._cols[0].values) if self._cols else 0

    def pages(self):
        yield self._cols


class IcebergConnector(Connector):
    name = "iceberg"

    def __init__(self, root: str):
        from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

        # the filesystem SPI resolves the warehouse location (rejects
        # remote schemes loudly); metadata versions, snapshot commits, and
        # data-file writes go through self.fs — schema/table LISTING still
        # uses local os walks (directory-shape discovery, the remaining
        # seam when an object-store implementation lands)
        self.fs = filesystem_for(root)
        self.root = strip_scheme(root)
        self._metadata = _IcebergMetadata(self)

    def metadata(self) -> _IcebergMetadata:
        return self._metadata

    def supports_writes(self) -> bool:
        return True

    # -- metadata tree --------------------------------------------------------

    def _dir(self, schema: str, table: str) -> str:
        return os.path.join(self.root, schema, table)

    def _meta_dir(self, schema: str, table: str) -> str:
        return os.path.join(self._dir(schema, table), "metadata")

    def _versions(self, schema: str, table: str) -> list[int]:
        d = self._meta_dir(schema, table)
        out = []
        for p in self.fs.list(d):
            f = os.path.basename(p)
            if f.startswith("v") and f.endswith(".json"):
                try:
                    out.append(int(f[1:-5]))
                except ValueError:
                    pass
        return sorted(out)

    def _load(self, schema: str, table: str) -> dict:
        vs = self._versions(schema, table)
        if not vs:
            raise KeyError(f"iceberg table {schema}.{table} does not exist")
        return json.loads(
            self.fs.read(
                os.path.join(self._meta_dir(schema, table), f"v{vs[-1]}.json")
            )
        )

    def _store(self, schema: str, table: str, md: dict) -> None:
        d = self._meta_dir(schema, table)
        self.fs.mkdirs(d)
        vs = self._versions(schema, table)
        v = (vs[-1] + 1) if vs else 1
        # fs.write publishes atomically (temp + rename), the commit contract
        self.fs.write(
            os.path.join(d, f"v{v}.json"), json.dumps(md, indent=1).encode()
        )

    @staticmethod
    def _snapshot(md: dict, snapshot_id: Optional[int]) -> dict:
        snaps = md["snapshots"]
        if snapshot_id is None:
            snapshot_id = md["current_snapshot_id"]
        for s in snaps:
            if s["snapshot_id"] == snapshot_id:
                return s
        raise KeyError(f"snapshot {snapshot_id} not found")

    def _new_snapshot_id(self, md: Optional[dict]) -> int:
        prev = 0
        if md is not None and md["snapshots"]:
            prev = max(s["snapshot_id"] for s in md["snapshots"])
        return prev + 1

    # -- DDL/DML --------------------------------------------------------------

    def create_table(self, schema: str, table: str, columns: Sequence[ColumnMeta]):
        """Fresh table, or (existing table, same shape) an OVERWRITE
        snapshot with an empty manifest — history preserved, so the
        runner's rewrite-style DELETE/UPDATE becomes snapshot-based."""
        try:
            md = self._load(schema, table)
        except KeyError:
            md = None
        sid = self._new_snapshot_id(md)
        snap = {
            "snapshot_id": sid,
            "parent_id": md["current_snapshot_id"] if md else None,
            "timestamp_ms": int(time.time() * 1000),
            "operation": "overwrite" if md else "create",
            "manifest": [],
        }
        new_md = {
            "schema_name": schema,
            "table": table,
            "columns": [
                {"name": c.name, "type": c.type.name} for c in columns
            ],
            "snapshots": (md["snapshots"] if md else []) + [snap],
            "current_snapshot_id": sid,
        }
        self._store(schema, table, new_md)

    def drop_table(self, handle: TableHandle) -> None:
        import shutil

        shutil.rmtree(self._dir(handle.schema, handle.table), ignore_errors=True)

    def page_sink(self, handle: TableHandle, column_names, column_types):
        return _IcebergSink(self, handle, list(column_names), list(column_types))

    def commit_append(self, schema: str, table: str, path: str, rows: int) -> None:
        md = self._load(schema, table)
        cur = self._snapshot(md, None)
        sid = self._new_snapshot_id(md)
        snap = {
            "snapshot_id": sid,
            "parent_id": cur["snapshot_id"],
            "timestamp_ms": int(time.time() * 1000),
            "operation": "append",
            "manifest": list(cur["manifest"]) + [{"path": path, "rows": rows}],
        }
        md["snapshots"].append(snap)
        md["current_snapshot_id"] = sid
        self._store(schema, table, md)

    # -- transaction snapshots ------------------------------------------------

    def snapshot_table(self, schema: str, table: str):
        """Transactions capture the whole metadata document; ROLLBACK
        re-commits it as a new version (data files are immutable, so this
        is exact — the Iceberg `rollback_to_snapshot` procedure's shape)."""
        from trino_tpu_torch.runtime.transactions import MISSING

        try:
            return json.dumps(self._load(schema, table))
        except KeyError:
            return MISSING

    def restore_table(self, schema: str, table: str, snap) -> None:
        from trino_tpu_torch.runtime.transactions import MISSING

        if snap is MISSING:
            self.drop_table(TableHandle(self.name, schema, table))
            return
        self._store(schema, table, json.loads(snap))

    # -- reads ----------------------------------------------------------------

    def scan_version(self, handle: TableHandle):
        base, snap, meta_suffix = _split_name(handle.table)
        if meta_suffix:
            return None
        try:
            md = self._load(handle.schema, base)
        except KeyError:
            return None
        s = self._snapshot(md, snap)
        return (s["snapshot_id"], tuple(f["path"] for f in s["manifest"]))

    def splits(self, handle: TableHandle, target_splits: int, predicate=None):
        base, snap, meta_suffix = _split_name(handle.table)
        if meta_suffix:
            return [Split(handle, 0)]
        md = self._load(handle.schema, base)
        s = self._snapshot(md, snap)
        out = []
        seq = 0
        row_start = 0
        for f in s["manifest"]:
            path = os.path.join(self._dir(handle.schema, base), f["path"])
            pf = ParquetFile(path)
            for rg in range(pf.num_row_groups):
                nrows = pf.row_group_rows(rg)
                out.append(
                    Split(
                        handle, seq,
                        row_start=row_start, row_count=nrows,
                        info=(path, rg),
                    )
                )
                seq += 1
                row_start += nrows
        if not out:
            out.append(Split(handle, 0, row_start=0, row_count=0, info=None))
        return out

    def page_source(
        self, split: Split, columns: Sequence[str], max_rows_per_page: int = 1 << 20
    ) -> PageSource:
        from trino_tpu_torch.connectors.parquet import _ParquetPageSource

        base, snap, meta_suffix = _split_name(split.table.table)
        if meta_suffix:
            return self._meta_table_source(
                split.table.schema, base, snap, meta_suffix, columns
            )
        if split.info is None:  # empty table
            import numpy as np

            from trino_tpu_torch.columnar import StringDictionary

            meta = self._metadata.table_metadata(split.table.schema, base)
            tmap = {c.name: c.type for c in meta.columns}
            return _RowsPageSource(
                [
                    ColumnData(
                        np.zeros(0, dtype=tmap[c].np_dtype),
                        None,
                        # varchar columns keep the engine's dictionary
                        # invariant even with no rows
                        StringDictionary([])
                        if T.is_string_kind(tmap[c])
                        else None,
                    )
                    for c in columns
                ]
            )
        meta = self._metadata.table_metadata(split.table.schema, base)
        tmap = {c.name: c.type for c in meta.columns}
        types = [tmap[c] for c in columns]
        return _ParquetPageSource(split, columns, types, max_rows_per_page)

    def _meta_table_source(self, schema, base, snap, suffix, columns):
        import numpy as np

        from trino_tpu_torch.columnar import StringDictionary

        md = self._load(schema, base)

        def strcol(vals):
            d = StringDictionary.from_unsorted(vals or [""])
            return ColumnData(d.encode(list(vals)), None, d)

        def intcol(vals, valid=None):
            return ColumnData(
                np.asarray(list(vals), dtype=np.int64),
                None if valid is None else np.asarray(valid, bool),
                None,
            )

        rows: dict = {}
        if suffix == "$files":
            s = self._snapshot(md, snap)
            rows = {
                "file_path": strcol([f["path"] for f in s["manifest"]]),
                "record_count": intcol([f["rows"] for f in s["manifest"]]),
                "snapshot_id": intcol(
                    [s["snapshot_id"]] * len(s["manifest"])
                ),
            }
        elif suffix == "$history":
            snaps = md["snapshots"]
            rows = {
                "snapshot_id": intcol([s["snapshot_id"] for s in snaps]),
                "parent_id": intcol(
                    [s["parent_id"] or 0 for s in snaps],
                    valid=[s["parent_id"] is not None for s in snaps],
                ),
                "made_current_at": intcol(
                    [s["timestamp_ms"] for s in snaps]
                ),
                "operation": strcol([s["operation"] for s in snaps]),
            }
        elif suffix == "$snapshots":
            snaps = md["snapshots"]
            rows = {
                "snapshot_id": intcol([s["snapshot_id"] for s in snaps]),
                "committed_at": intcol([s["timestamp_ms"] for s in snaps]),
                "operation": strcol([s["operation"] for s in snaps]),
                "file_count": intcol([len(s["manifest"]) for s in snaps]),
                "total_records": intcol(
                    [sum(f["rows"] for f in s["manifest"]) for s in snaps]
                ),
            }
        return _RowsPageSource([rows[c] for c in columns])


class _IcebergSink:
    """Each append writes one immutable data file and commits an append
    snapshot (the Iceberg commit protocol collapsed to a single manifest
    rewrite; reference: IcebergPageSink + SnapshotProducer.commit)."""

    def __init__(self, conn: IcebergConnector, handle: TableHandle, names, types):
        self.conn = conn
        self.handle = handle
        self.names = names
        self.types = types

    def append(self, columns: Sequence[ColumnData]) -> int:
        base, _, _ = _split_name(self.handle.table)
        rows = len(columns[0].values) if columns else 0
        if rows == 0:
            return 0
        ddir = os.path.join(self.conn._dir(self.handle.schema, base), "data")
        self.conn.fs.mkdirs(ddir)
        fname = f"{uuid.uuid4().hex}.parquet"
        with self.conn.fs.open_output(os.path.join(ddir, fname)) as f:
            write_columns(f, self.names, self.types, columns)
        self.conn.commit_append(
            self.handle.schema, base, os.path.join("data", fname), rows
        )
        return rows

"""Parquet connector: columnar files -> device batches.

Reference roles: lib/trino-parquet (ParquetReader) +
plugin/trino-hive/.../parquet/ParquetPageSourceFactory.java:106 + the
filesystem SPI (lib/trino-filesystem).  The host-side decode is the port's
own reader (`formats/parquet`, numpy and the standard library); pages are
row-group slices projected to the requested columns in the engine's
columnar form (numerics as numpy, strings dictionary-encoded, short
decimals as scaled int64, dates as day numbers) — which then ride the same
buffer-pool/prefetch feed as generated tables.

Layout: root_dir/<schema>/<table>.parquet or root_dir/<schema>/<table>/
(directory of part files).  Files are immutable while registered: the scan
version is the (path, mtime, size) set, so the device buffer pool may cache
row groups.

Port of trino_tpu/connectors/parquet.py: the same classes, names and split
unit (one split per row group); pyarrow's reader and writer are replaced by
`formats/parquet`.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from trino_tpu_torch.connectors.api import (
    ColumnData,
    Connector,
    ConnectorMetadata,
    PageSource,
    Split,
    TableHandle,
    TableMetadata,
    TableStatistics,
)
from trino_tpu_torch.formats.parquet.reader import ParquetFile
from trino_tpu_torch.formats.parquet.writer import concat_columns, write_columns


def slice_column(cd: ColumnData, start: int, stop: int) -> ColumnData:
    """Rows [start, stop) of a column; the mask drops when no row in the
    slice is NULL (as an Arrow slice's null count does)."""
    valid = None
    if cd.valid is not None:
        valid = cd.valid[start:stop]
        if valid.all():
            valid = None
    return ColumnData(cd.values[start:stop], valid, cd.dictionary)


def row_group_pages(path: str, row_group: int, columns, types, page_rows: int):
    """Decode one row group's projected columns and yield them in pages of
    at most `page_rows` rows (one empty page for an empty row group)."""
    cols = ParquetFile(path).read_row_group(row_group, columns, types)
    n = len(cols[0].values) if cols else 0
    for start in range(0, max(n, 1), page_rows):
        stop = min(start + page_rows, n)
        if stop <= start and start > 0:
            break
        yield [slice_column(c, start, stop) for c in cols]


class _ParquetMetadata(ConnectorMetadata):
    def __init__(self, conn: "ParquetConnector"):
        self.conn = conn

    def list_schemas(self) -> Sequence[str]:
        root = self.conn.root
        return sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )

    def list_tables(self, schema: str) -> Sequence[str]:
        out = []
        base = os.path.join(self.conn.root, schema)
        if not os.path.isdir(base):
            return []
        for name in os.listdir(base):
            p = os.path.join(base, name)
            if name.endswith(".parquet") and os.path.isfile(p):
                out.append(name[: -len(".parquet")])
            elif os.path.isdir(p):
                out.append(name)
        return sorted(out)

    def table_metadata(self, schema: str, table: str) -> TableMetadata:
        files = self.conn._files(schema, table)
        if not files:
            raise KeyError(f"parquet table not found: {schema}.{table}")
        return TableMetadata(schema, table, tuple(ParquetFile(files[0]).columns()))

    def table_statistics(self, schema: str, table: str) -> TableStatistics:
        rows = 0
        for f in self.conn._files(schema, table):
            rows += ParquetFile(f).num_rows
        return TableStatistics(row_count=rows)


class _ParquetPageSource(PageSource):
    def __init__(self, split: Split, columns, types, page_rows: int):
        self.split = split
        self.columns = list(columns)
        self.types = list(types)
        self.page_rows = page_rows

    def row_count(self) -> int:
        return self.split.row_count

    def pages(self):
        path, row_group = self.split.info
        yield from row_group_pages(
            path, row_group, self.columns, self.types, self.page_rows
        )


class ParquetConnector(Connector):
    """reference roles: plugin/trino-hive's parquet read path, minus the
    metastore — tables are files under a root directory."""

    name = "parquet"

    def __init__(self, root: str):
        self.root = root
        self._metadata = _ParquetMetadata(self)

    def metadata(self) -> _ParquetMetadata:
        return self._metadata

    def _files(self, schema: str, table: str) -> list:
        base = os.path.join(self.root, schema)
        single = os.path.join(base, table + ".parquet")
        if os.path.isfile(single):
            return [single]
        d = os.path.join(base, table)
        if os.path.isdir(d):
            return sorted(
                os.path.join(d, f)
                for f in os.listdir(d)
                if f.endswith(".parquet")
            )
        return []

    def scan_version(self, handle: TableHandle):
        files = self._files(handle.schema, handle.table)
        try:
            return tuple(
                (f, int(os.path.getmtime(f)), os.path.getsize(f))
                for f in files
            )
        except OSError:
            return None

    def splits(self, handle: TableHandle, target_splits: int, predicate=None):
        """One split per row group (the reference's parquet split unit)."""
        out = []
        seq = 0
        row_start = 0
        for path in self._files(handle.schema, handle.table):
            pf = ParquetFile(path)
            for rg in range(pf.num_row_groups):
                nrows = pf.row_group_rows(rg)
                out.append(
                    Split(
                        handle,
                        seq,
                        row_start=row_start,
                        row_count=nrows,
                        info=(path, rg),
                    )
                )
                seq += 1
                row_start += nrows
        return out

    def page_source(
        self, split: Split, columns: Sequence[str], max_rows_per_page: int = 1 << 20
    ) -> PageSource:
        meta = self._metadata.table_metadata(
            split.table.schema, split.table.table
        )
        tmap = {c.name: c.type for c in meta.columns}
        types = [tmap[c] for c in columns]
        return _ParquetPageSource(split, columns, types, max_rows_per_page)


def read_table_columns(connector: Connector, schema: str, table: str,
                       page_rows: int = 1 << 20):
    """All rows of a connector table: (names, types, [ColumnData]) with each
    column's pages concatenated."""
    meta = connector.metadata().table_metadata(schema, table)
    handle = TableHandle("src", schema, table)
    names = [c.name for c in meta.columns]
    types = [c.type for c in meta.columns]
    parts: list = [[] for _ in names]
    for split in connector.splits(handle, target_splits=1):
        src = connector.page_source(split, names, max_rows_per_page=page_rows)
        for page in src.pages():
            for i, cd in enumerate(page):
                parts[i].append(cd)
    cols = []
    for t, ps in zip(types, parts):
        if not ps:
            ps = [ColumnData(np.zeros(0, t.np_dtype), None, None)]
        cols.append(concat_columns(ps, t))
    return names, types, cols


def write_table_to_parquet(
    connector: Connector,
    schema: str,
    table: str,
    out_dir: str,
    row_group_rows: int = 1 << 20,
    codec: str = "GZIP",
) -> str:
    """Export any connector table to a parquet file (test/bench fixture
    helper; reference role: the writers in lib/trino-parquet)."""
    names, types, cols = read_table_columns(connector, schema, table, row_group_rows)
    os.makedirs(os.path.join(out_dir, schema), exist_ok=True)
    path = os.path.join(out_dir, schema, table + ".parquet")
    write_columns(path, names, types, cols, row_group_rows=row_group_rows, codec=codec)
    return path

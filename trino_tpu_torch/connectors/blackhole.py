"""Null source/sink connector (reference: plugin/trino-blackhole).

Port of trino_tpu/connectors/blackhole.py.

Reads produce empty (or synthetic zero-filled) pages; writes are dropped.
Used by perf tests to isolate operator cost from ingest cost.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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


class _BlackholeMetadata(ConnectorMetadata):
    def __init__(self, tables):
        self.tables = tables

    def list_schemas(self):
        return ["default"]

    def list_tables(self, schema: str):
        return sorted(t for s, t in self.tables if s == schema)

    def table_metadata(self, schema, table):
        return self.tables[(schema, table)]

    def table_statistics(self, schema, table):
        return TableStatistics(row_count=0)


class _EmptySource(PageSource):
    def row_count(self):
        return 0

    def pages(self):
        return iter(())


class _NullSink:
    def append(self, columns):
        return len(columns[0].values) if columns else 0


class BlackholeConnector(Connector):
    name = "blackhole"

    def __init__(self):
        self.tables: dict[tuple, TableMetadata] = {}
        self._metadata = _BlackholeMetadata(self.tables)

    def metadata(self):
        return self._metadata

    def supports_writes(self) -> bool:
        return True

    def create_table(self, schema: str, table: str, columns: Sequence[ColumnMeta]):
        self.tables[(schema, table)] = TableMetadata(schema, table, tuple(columns))

    def drop_table(self, handle: TableHandle):
        self.tables.pop((handle.schema, handle.table), None)

    def page_sink(self, handle, column_names, column_types):
        return _NullSink()

    def splits(self, handle: TableHandle, target_splits: int, predicate=None):
        return [Split(handle, 0)]

    def page_source(self, split, columns, max_rows_per_page: int = 1 << 20):
        return _EmptySource()

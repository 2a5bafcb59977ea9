"""Connector plugins (reference: plugin/* — 53 modules on spi.Plugin).

Round-1 set mirrors the reference's baseline-critical connectors:
  tpch       -> plugin/trino-tpch (on-the-fly TPC-H generation at any SF)
  tpcds      -> plugin/trino-tpcds
  memory     -> plugin/trino-memory (in-RAM pages store, test workhorse)
  blackhole  -> plugin/trino-blackhole (null source/sink for perf tests)
  parquet    -> lib/trino-parquet read path (the port's own reader, formats/parquet)
  hive       -> plugin/trino-hive over parquet and ORC (formats/parquet, formats/orc)
  iceberg    -> plugin/trino-iceberg (snapshot-versioned parquet tables)
"""

from trino_tpu_torch.connectors.api import (
    Connector,
    ConnectorMetadata,
    ColumnMeta,
    TableMetadata,
    TableHandle,
    Split,
    PageSource,
    TableStatistics,
    CatalogManager,
)

__all__ = [
    "Connector",
    "ConnectorMetadata",
    "ColumnMeta",
    "TableMetadata",
    "TableHandle",
    "Split",
    "PageSource",
    "TableStatistics",
    "CatalogManager",
]

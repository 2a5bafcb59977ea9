"""Parquet without pyarrow: the reader and writer the parquet, hive and
iceberg connectors use (reference: lib/trino-parquet's ParquetReader,
ParquetWriter and its parquet-format Thrift structs)."""

from trino_tpu_torch.formats.parquet.reader import (
    ParquetFile,
    decode_stats,
    reset_decode_stats,
)
from trino_tpu_torch.formats.parquet.writer import write_columns

__all__ = ["ParquetFile", "decode_stats", "reset_decode_stats", "write_columns"]

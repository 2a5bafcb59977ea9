"""ORC without pyarrow: the reader and writer the hive connector uses
(reference: lib/trino-orc's OrcReader and OrcWriter, and the `orc_proto`
messages they read and write)."""

from trino_tpu_torch.formats.orc.reader import OrcFile, decode_stats, reset_decode_stats
from trino_tpu_torch.formats.orc.writer import write_columns

__all__ = ["OrcFile", "decode_stats", "reset_decode_stats", "write_columns"]

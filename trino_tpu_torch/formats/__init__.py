"""File formats the port reads and writes itself (reference: lib/trino-parquet).

`formats/parquet/` is a Parquet reader and writer in numpy and the standard
library: the Thrift compact protocol of the footer and page headers
(`thrift`), the value encodings (`encodings`), the page codecs
(`compression`), the decode into engine columns (`reader`) and the encode
from them (`writer`).  The connectors under `connectors/` (parquet, hive,
iceberg) read and write through it.
"""

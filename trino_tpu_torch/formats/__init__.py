"""File formats the port reads and writes itself (reference: lib/trino-parquet
and lib/trino-orc).

`formats/parquet/` is a Parquet reader and writer in numpy and the standard
library: the Thrift compact protocol of the footer and page headers
(`thrift`), the value encodings (`encodings`), the page codecs
(`compression`), the decode into engine columns (`reader`) and the encode
from them (`writer`).  The connectors under `connectors/` (parquet, hive,
iceberg) read and write through it.

`formats/orc/` is an ORC reader and writer of the same make: the protobuf
wire format (`protobuf`), the `orc_proto` messages and the file tail
(`metadata`), the chunk framing and codecs (`compression`), the run-length
encodings (`rle`), the decode into engine columns (`reader`) and the encode
from them (`writer`).  The hive connector reads and writes through it.
"""

"""The messages of ORC's `orc_proto.proto`, by field number, and the file
tail (reference: lib/trino-orc's OrcReader reading the PostScript, Footer and
Metadata, and its StripeReader reading each stripe footer).

An ORC file is the magic "ORC", the stripes, the metadata section (stripe
statistics), the footer, the PostScript and one byte giving the
PostScript's length.  The PostScript is never compressed; it names the codec
and block size under which the footer and the metadata are framed.
"""

from __future__ import annotations

import os

from trino_tpu_torch.formats.orc import compression as cz
from trino_tpu_torch.formats.orc.protobuf import read_message

MAGIC = b"ORC"

# Type.Kind
BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, BINARY, TIMESTAMP = range(10)
LIST, MAP, STRUCT, UNION, DECIMAL, DATE, VARCHAR, CHAR, TIMESTAMP_INSTANT = range(10, 19)
KINDS = ("BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE", "STRING",
         "BINARY", "TIMESTAMP", "LIST", "MAP", "STRUCT", "UNION", "DECIMAL",
         "DATE", "VARCHAR", "CHAR", "TIMESTAMP_INSTANT")

# Stream.Kind
PRESENT, DATA, LENGTH, DICTIONARY_DATA, DICTIONARY_COUNT, SECONDARY = range(6)
ROW_INDEX, BLOOM_FILTER, BLOOM_FILTER_UTF8, ENCRYPTED_INDEX, ENCRYPTED_DATA = range(6, 11)
#: streams a reader of values never needs
INDEX_STREAMS = frozenset((ROW_INDEX, BLOOM_FILTER, BLOOM_FILTER_UTF8, ENCRYPTED_INDEX))

# ColumnEncoding.Kind
DIRECT, DICTIONARY, DIRECT_V2, DICTIONARY_V2 = range(4)

POSTSCRIPT = {
    1: ("footerLength", "uint"),
    2: ("compression", "uint"),
    3: ("compressionBlockSize", "uint"),
    4: ("version", "uint", "repeated"),
    5: ("metadataLength", "uint"),
    6: ("writerVersion", "uint"),
    7: ("stripeStatisticsLength", "uint"),
    8000: ("magic", "string"),
}

STRIPE_INFORMATION = {
    1: ("offset", "uint"),
    2: ("indexLength", "uint"),
    3: ("dataLength", "uint"),
    4: ("footerLength", "uint"),
    5: ("numberOfRows", "uint"),
    6: ("encryptStripeId", "uint"),
    7: ("encryptedLocalKeys", "bytes", "repeated"),
}

TYPE = {
    1: ("kind", "uint"),
    2: ("subtypes", "uint", "repeated"),
    3: ("fieldNames", "string", "repeated"),
    4: ("maximumLength", "uint"),
    5: ("precision", "uint"),
    6: ("scale", "uint"),
}

INTEGER_STATISTICS = {1: ("minimum", "sint"), 2: ("maximum", "sint"), 3: ("sum", "sint")}
DOUBLE_STATISTICS = {1: ("minimum", "double"), 2: ("maximum", "double"), 3: ("sum", "double")}
STRING_STATISTICS = {1: ("minimum", "string"), 2: ("maximum", "string"), 3: ("sum", "sint"),
                     4: ("lowerBound", "string"), 5: ("upperBound", "string")}
BUCKET_STATISTICS = {1: ("count", "uint", "repeated")}
DECIMAL_STATISTICS = {1: ("minimum", "string"), 2: ("maximum", "string"), 3: ("sum", "string")}
DATE_STATISTICS = {1: ("minimum", "sint"), 2: ("maximum", "sint")}
BINARY_STATISTICS = {1: ("sum", "sint")}
TIMESTAMP_STATISTICS = {1: ("minimum", "sint"), 2: ("maximum", "sint"),
                        3: ("minimumUtc", "sint"), 4: ("maximumUtc", "sint"),
                        5: ("minimumNanos", "uint"), 6: ("maximumNanos", "uint")}

COLUMN_STATISTICS = {
    1: ("numberOfValues", "uint"),
    2: ("intStatistics", INTEGER_STATISTICS),
    3: ("doubleStatistics", DOUBLE_STATISTICS),
    4: ("stringStatistics", STRING_STATISTICS),
    5: ("bucketStatistics", BUCKET_STATISTICS),
    6: ("decimalStatistics", DECIMAL_STATISTICS),
    7: ("dateStatistics", DATE_STATISTICS),
    8: ("binaryStatistics", BINARY_STATISTICS),
    9: ("timestampStatistics", TIMESTAMP_STATISTICS),
    10: ("hasNull", "bool"),
    11: ("bytesOnDisk", "uint"),
}

USER_METADATA_ITEM = {1: ("name", "string"), 2: ("value", "bytes")}

FOOTER = {
    1: ("headerLength", "uint"),
    2: ("contentLength", "uint"),
    3: ("stripes", STRIPE_INFORMATION, "repeated"),
    4: ("types", TYPE, "repeated"),
    5: ("metadata", USER_METADATA_ITEM, "repeated"),
    6: ("numberOfRows", "uint"),
    7: ("statistics", COLUMN_STATISTICS, "repeated"),
    8: ("rowIndexStride", "uint"),
    9: ("writer", "uint"),
    12: ("softwareVersion", "string"),
}

STRIPE_STATISTICS = {1: ("colStats", COLUMN_STATISTICS, "repeated")}
METADATA = {1: ("stripeStats", STRIPE_STATISTICS, "repeated")}

STREAM = {1: ("kind", "uint"), 2: ("column", "uint"), 3: ("length", "uint")}
COLUMN_ENCODING = {1: ("kind", "uint"), 2: ("dictionarySize", "uint")}
STRIPE_FOOTER = {
    1: ("streams", STREAM, "repeated"),
    2: ("columns", COLUMN_ENCODING, "repeated"),
    3: ("writerTimezone", "string"),
}

#: the longest tail read at once before the footer's length is known
_TAIL_GUESS = 16 * 1024


class Tail:
    """A file's PostScript, Footer and the codec they name."""

    __slots__ = ("postscript", "footer", "codec")

    def __init__(self, postscript: dict, footer: dict):
        self.postscript = postscript
        self.footer = footer
        self.codec = postscript.get("compression", cz.NONE)


def read_tail(fh, path: str = "") -> Tail:
    """Read the PostScript and the (decompressed) Footer of an open file."""
    fh.seek(0, os.SEEK_END)
    size = fh.tell()
    if size < len(MAGIC) + 1:
        raise ValueError(f"{path}: too small to be an orc file")
    take = min(size, _TAIL_GUESS)
    fh.seek(size - take)
    buf = fh.read(take)
    ps_len = buf[-1]
    if ps_len + 1 > size:
        raise ValueError(f"{path}: not an orc file (PostScript length {ps_len})")
    ps = read_message(buf, POSTSCRIPT, take - 1 - ps_len, take - 1)
    if ps.get("magic", "ORC") != "ORC":
        raise ValueError(f"{path}: not an orc file (PostScript magic {ps.get('magic')!r})")
    footer_len = ps.get("footerLength", 0)
    need = 1 + ps_len + footer_len
    if need > size:
        raise ValueError(f"{path}: the orc footer overruns the file")
    if need > take:
        fh.seek(size - need)
        buf = fh.read(need)
        take = need
    start = take - 1 - ps_len - footer_len
    codec = ps.get("compression", cz.NONE)
    raw = cz.decompress(codec, buf[start:take - 1 - ps_len])
    footer = read_message(raw, FOOTER)
    return Tail(ps, footer)


def read_stripe_footer(fh, stripe: dict, codec: int) -> dict:
    """The decompressed stripe footer of one StripeInformation."""
    start = stripe.get("offset", 0) + stripe.get("indexLength", 0) + stripe.get("dataLength", 0)
    fh.seek(start)
    raw = fh.read(stripe.get("footerLength", 0))
    return read_message(cz.decompress(codec, raw), STRIPE_FOOTER)

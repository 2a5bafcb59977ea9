"""Page codecs (reference: lib/trino-parquet ParquetCompressionUtils).

UNCOMPRESSED and GZIP (zlib, which runs at C speed in the standard library)
read and write.  SNAPPY reads through the pure-Python decoder below: it is
pyarrow's default codec, so the files other writers make use it, but the
port's writer never does (GZIP level 1 is its default).  ZSTD, LZ4, BROTLI
and LZO raise NotImplementedError naming the codec.
"""

from __future__ import annotations

import zlib

from trino_tpu_torch.formats.parquet.thrift import CODECS, GZIP, SNAPPY, UNCOMPRESSED


def decompress(codec: int, data, uncompressed_size: int) -> bytes:
    if codec == UNCOMPRESSED:
        return data
    if codec == SNAPPY:
        return snappy_decompress(data)
    if codec == GZIP:
        # 32 + 15: accept a gzip or a zlib header
        return zlib.decompress(data, 47)
    raise NotImplementedError(
        f"parquet codec {CODECS.get(codec, codec)}: not supported by the "
        "port's reader (UNCOMPRESSED, SNAPPY and GZIP are)"
    )


def compress(codec: int, data: bytes, level: int = 1) -> bytes:
    if codec == UNCOMPRESSED:
        return data
    if codec == GZIP:
        c = zlib.compressobj(level, zlib.DEFLATED, 31)  # gzip framing
        return c.compress(data) + c.flush()
    raise NotImplementedError(
        f"parquet codec {CODECS.get(codec, codec)}: not supported by the "
        "port's writer (GZIP and UNCOMPRESSED are)"
    )


class SnappyError(ValueError):
    """Malformed snappy input."""


def snappy_decompress(data) -> bytes:
    """Decode one raw snappy block (the framing-free format parquet uses):
    a varint of the decoded length, then literal and copy elements."""
    src = bytes(data)
    n = len(src)
    pos = 0
    length = 0
    shift = 0
    while True:
        if pos >= n:
            raise SnappyError("truncated snappy length")
        b = src[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise SnappyError("truncated snappy literal")
            out += src[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = src[pos] | (src[pos + 1] << 8)
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        start = len(out) - off
        if off == 0 or start < 0:
            raise SnappyError("snappy copy offset out of range")
        if off >= ln:
            out += out[start:start + ln]
        else:  # overlapping copy: the last `off` bytes repeat
            pattern = bytes(out[start:])
            reps = -(-ln // off)
            out += (pattern * reps)[:ln]
    if len(out) != length:
        raise SnappyError(
            f"snappy block decoded to {len(out)} bytes, header says {length}"
        )
    return bytes(out)

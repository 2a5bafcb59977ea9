"""ORC's compression framing (reference: lib/trino-orc's OrcChunkLoader and
OrcOutputBuffer).

Under a codec other than NONE every stream, the footer and the metadata
section are cut into chunks, each behind a 3-byte little-endian header:
bit 0 says the chunk is stored as it was (`isOriginal`), the rest is the
chunk's length.  A chunk inflates to at most the file's compression block
size.  Each stream is framed on its own; the PostScript never is.

NONE, ZLIB (raw deflate) and SNAPPY (one raw block a chunk) read.  ZSTD, LZ4
and LZO raise NotImplementedError naming the codec.  The writer frames with
NONE or ZLIB (level 1 by default, as Hive's `orc.compress` default is read
at Trino's `hive.compression-codec=GZIP`), keeping a chunk original when
deflate does not shrink it.
"""

from __future__ import annotations

import zlib

from trino_tpu_torch.formats.parquet.compression import snappy_decompress

NONE = 0
ZLIB = 1
SNAPPY = 2
LZO = 3
LZ4 = 4
ZSTD = 5
CODECS = {NONE: "NONE", ZLIB: "ZLIB", SNAPPY: "SNAPPY", LZO: "LZO", LZ4: "LZ4", ZSTD: "ZSTD"}
CODEC_IDS = {v: k for k, v in CODECS.items()}
#: the writer's chunk size (ORC's default `orc.compress.size`)
BLOCK_SIZE = 256 * 1024


def unsupported_codec(codec: int, side: str = "reader") -> NotImplementedError:
    ok = "NONE, ZLIB and SNAPPY" if side == "reader" else "NONE and ZLIB"
    return NotImplementedError(
        f"orc codec {CODECS.get(codec, codec)}: not supported by the port's "
        f"{side} ({ok} are)"
    )


def decompress(codec: int, data) -> bytes:
    """The bytes one framed stream (or footer, or metadata) holds."""
    if codec == NONE:
        return bytes(data)
    if codec not in (ZLIB, SNAPPY):
        raise unsupported_codec(codec)
    src = memoryview(data)
    n = len(src)
    pos = 0
    parts = []
    while pos < n:
        if pos + 3 > n:
            raise ValueError("orc: truncated compression chunk header")
        h = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16)
        pos += 3
        length = h >> 1
        if pos + length > n:
            raise ValueError("orc: compression chunk overruns its stream")
        chunk = src[pos:pos + length]
        pos += length
        if h & 1:
            parts.append(bytes(chunk))
        elif codec == ZLIB:
            parts.append(zlib.decompress(chunk, -15))
        else:
            parts.append(snappy_decompress(chunk))
    return b"".join(parts)


def compress(codec: int, data: bytes) -> bytes:
    """Frame `data` under `codec` (NONE or ZLIB at level 1), in chunks of
    `BLOCK_SIZE`."""
    if codec == NONE:
        return bytes(data)
    if codec != ZLIB:
        raise unsupported_codec(codec, "writer")
    view = memoryview(data)
    out = bytearray()
    for start in range(0, len(view), BLOCK_SIZE):
        chunk = view[start:start + BLOCK_SIZE]
        c = zlib.compressobj(1, zlib.DEFLATED, -15)
        packed = c.compress(chunk) + c.flush()
        if len(packed) < len(chunk):
            h = len(packed) << 1
            body = packed
        else:
            h = (len(chunk) << 1) | 1
            body = chunk
        out += bytes((h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF))
        out += body
    return bytes(out)

"""Parquet value and level encodings, vectorised with numpy where the format
allows (reference: lib/trino-parquet's ValuesReader family and
RunLengthBitPackingHybridDecoder).

Supported: PLAIN for every flat physical type but INT96, the RLE /
bit-packed hybrid (definition levels, dictionary indices, RLE booleans),
and PLAIN_DICTIONARY / RLE_DICTIONARY.  Any other encoding raises
NotImplementedError naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from trino_tpu_torch.formats.parquet.thrift import (
    BOOLEAN,
    BYTE_ARRAY,
    DOUBLE_T,
    ENCODINGS,
    FIXED_LEN_BYTE_ARRAY,
    FLOAT,
    INT32,
    INT64,
    PHYSICAL_TYPES,
)

_FIXED_DTYPES = {
    INT32: np.dtype("<i4"),
    INT64: np.dtype("<i8"),
    FLOAT: np.dtype("<f4"),
    DOUBLE_T: np.dtype("<f8"),
}
_I32 = struct.Struct("<i")


def unsupported_encoding(encoding: int, what: str):
    name = ENCODINGS.get(encoding, f"encoding {encoding}")
    return NotImplementedError(
        f"parquet encoding {name} ({what}): not supported by the port's reader"
    )


def bit_width(max_value: int) -> int:
    return int(max_value).bit_length()


# -- the RLE / bit-packed hybrid ----------------------------------------------


def _varint(buf, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def unpack_bits(raw: np.ndarray, width: int, count: int) -> np.ndarray:
    """`count` little-endian bit-packed values of `width` bits -> int64."""
    if width > 32:
        raise ValueError(f"parquet bit width {width} exceeds 32")
    if width == 0:
        return np.zeros(count, np.int64)
    if width == 8:
        return raw[:count].astype(np.int64)
    if width == 16:
        return raw[: 2 * count].view("<u2").astype(np.int64)
    if width == 32:
        return raw[: 4 * count].view("<u4").astype(np.int64)
    bits = np.unpackbits(raw, bitorder="little")[: count * width]
    if width == 1:
        return bits.astype(np.int64)
    padded = np.zeros((count, 32), np.uint8)
    padded[:, :width] = bits.reshape(count, width)
    packed = np.packbits(padded, axis=1, bitorder="little")
    return packed.view("<u4").reshape(count).astype(np.int64)


def decode_hybrid(buf, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """Decode `count` values of the RLE / bit-packed hybrid in buf[pos:end]."""
    out = np.empty(count, np.int64)
    filled = 0
    vbytes = (width + 7) // 8
    while filled < count:
        if pos >= end:
            raise ValueError(
                f"RLE/bit-packed run ended after {filled} of {count} values"
            )
        header, pos = _varint(buf, pos)
        if header & 1:  # bit-packed: header >> 1 groups of 8 values
            nvals = (header >> 1) * 8
            nbytes = min((header >> 1) * width, end - pos)
            take = min(nvals, count - filled)
            raw = np.frombuffer(buf, np.uint8, nbytes, pos)
            have = nbytes * 8 // width if width else take
            take = min(take, have)
            out[filled:filled + take] = unpack_bits(raw, width, take)
            pos += nbytes
        else:  # one value repeated header >> 1 times
            run = header >> 1
            v = int.from_bytes(buf[pos:pos + vbytes], "little")
            pos += vbytes
            take = min(run, count - filled)
            out[filled:filled + take] = v
        filled += take
    return out


def _pack_bits(values: np.ndarray, width: int) -> bytes:
    v = np.ascontiguousarray(values, dtype="<u8")
    bits = np.unpackbits(v.view(np.uint8).reshape(-1, 8), axis=1, bitorder="little")
    return np.packbits(bits[:, :width].ravel(), bitorder="little").tobytes()


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def encode_hybrid(values: np.ndarray, width: int) -> bytes:
    """Encode non-negative ints as the hybrid: RLE runs where the values
    repeat in few runs (definition levels of a column with few NULLs, a
    sorted dictionary column), else one bit-packed run."""
    values = np.asarray(values, np.int64)
    n = len(values)
    if n == 0:
        return b""
    vbytes = (width + 7) // 8
    starts = np.flatnonzero(np.diff(values)) + 1
    starts = np.concatenate(([0], starts))
    runs = len(starts)
    if runs * (vbytes + 4) < (n * width) // 8 + 8 or width == 0:
        lengths = np.diff(np.append(starts, n))
        out = bytearray()
        for s, ln in zip(starts.tolist(), lengths.tolist()):
            out += _varint_bytes(ln << 1)
            out += int(values[s]).to_bytes(vbytes, "little")
        return bytes(out)
    groups = -(-n // 8)
    padded = np.zeros(groups * 8, np.int64)
    padded[:n] = values
    return _varint_bytes((groups << 1) | 1) + _pack_bits(padded, width)


# -- PLAIN --------------------------------------------------------------------


def decode_plain(buf, pos: int, end: int, physical: int, count: int,
                 type_length: int = 0, as_str: bool = False):
    """`count` PLAIN values -> ndarray (fixed widths; FIXED_LEN_BYTE_ARRAY as
    uint8 [count, type_length]) or a list (BYTE_ARRAY: str if `as_str`,
    else bytes)."""
    if physical in _FIXED_DTYPES:
        dt = _FIXED_DTYPES[physical]
        if end - pos < count * dt.itemsize:
            raise ValueError("PLAIN page shorter than its value count")
        return np.frombuffer(buf, dt, count, pos)
    if physical == BOOLEAN:
        raw = np.frombuffer(buf, np.uint8, (count + 7) // 8, pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(bool)
    if physical == FIXED_LEN_BYTE_ARRAY:
        raw = np.frombuffer(buf, np.uint8, count * type_length, pos)
        return raw.reshape(count, type_length)
    if physical == BYTE_ARRAY:
        return decode_byte_arrays(buf, pos, end, count, as_str)
    raise NotImplementedError(
        f"parquet physical type {PHYSICAL_TYPES[physical]}: not supported by "
        "the port's reader"
    )


def decode_byte_arrays(buf, pos: int, end: int, count: int, as_str: bool) -> list:
    """PLAIN BYTE_ARRAY: (4-byte length, bytes) repeated.  The format is
    sequential, so this is one pass over a memoryview; each value becomes
    one Python object (the engine's dictionaries hold str)."""
    mv = memoryview(buf)
    unpack = _I32.unpack_from
    out = [None] * count
    if as_str:
        for i in range(count):
            ln = unpack(mv, pos)[0]
            pos += 4
            out[i] = str(mv[pos:pos + ln], "utf-8")
            pos += ln
    else:
        for i in range(count):
            ln = unpack(mv, pos)[0]
            pos += 4
            out[i] = bytes(mv[pos:pos + ln])
            pos += ln
    if pos > end:
        raise ValueError("PLAIN BYTE_ARRAY page overran its end")
    return out


def encode_plain(values, physical: int) -> bytes:
    """PLAIN encoding of a whole page of values (non-null values only)."""
    if physical in _FIXED_DTYPES:
        return np.ascontiguousarray(values, _FIXED_DTYPES[physical]).tobytes()
    if physical == BOOLEAN:
        return np.packbits(np.asarray(values, bool), bitorder="little").tobytes()
    if physical == FIXED_LEN_BYTE_ARRAY:
        return np.ascontiguousarray(values, np.uint8).tobytes()
    if physical == BYTE_ARRAY:
        parts = []
        for v in values:
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            parts.append(_I32.pack(len(raw)))
            parts.append(raw)
        return b"".join(parts)
    raise NotImplementedError(
        f"parquet physical type {PHYSICAL_TYPES[physical]}: not written by the "
        "port's writer"
    )

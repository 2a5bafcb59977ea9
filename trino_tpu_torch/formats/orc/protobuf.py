"""The protobuf wire format, reading and writing (reference: lib/trino-orc
reads ORC's metadata through the generated `orc_proto` classes; this module
is the small part of protobuf those messages need).

A message schema is a dict `{field number: (name, kind)}` or `{field number:
(name, kind, "repeated")}`.  A kind is a scalar name (`uint`, `sint`,
`bool`, `string`, `bytes`, `double`, `float`, `fixed32`, `fixed64`) or a
nested schema dict.  A message decodes into a dict keyed by
field name; a repeated field is a list, whether its scalars came packed or
one by one.  A field number the schema does not name is skipped by its wire
type: writers add fields newer than any copy of `orc_proto.proto`, and a
reader must step over them.  The writer packs repeated scalars, as the ORC
schema declares them (`[packed = true]`).
"""

from __future__ import annotations

import struct

# wire types
VARINT = 0
FIXED64 = 1
LENGTH = 2
START_GROUP = 3
END_GROUP = 4
FIXED32 = 5

_F64 = struct.Struct("<d")
_F32 = struct.Struct("<f")
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")

_WIRE = {"uint": VARINT, "sint": VARINT, "bool": VARINT,
         "double": FIXED64, "fixed64": FIXED64, "float": FIXED32,
         "fixed32": FIXED32, "string": LENGTH, "bytes": LENGTH}


class ProtobufError(ValueError):
    """Malformed protobuf input."""


def read_varint(buf, pos: int):
    """(value, next position) of the base-128 varint at `pos`."""
    out = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ProtobufError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 133:  # ORC's decimals are varints of up to 128 bits
            raise ProtobufError("varint too long")


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def zigzag_encode(v: int) -> int:
    return (v << 1) if v >= 0 else ((-v) << 1) - 1


def write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        raise ProtobufError(f"negative varint {v}")
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _scalar(kind: str, wire: int, buf, pos: int):
    """One scalar of `kind` sent with wire type `wire` -> (value, pos)."""
    if wire == VARINT:
        v, pos = read_varint(buf, pos)
        if kind == "sint":
            return zigzag_decode(v), pos
        if kind == "bool":
            return bool(v), pos
        return v, pos
    if wire == FIXED64:
        if pos + 8 > len(buf):
            raise ProtobufError("truncated fixed64")
        if kind == "double":
            return _F64.unpack_from(buf, pos)[0], pos + 8
        return _U64.unpack_from(buf, pos)[0], pos + 8
    if wire == FIXED32:
        if pos + 4 > len(buf):
            raise ProtobufError("truncated fixed32")
        if kind == "float":
            return _F32.unpack_from(buf, pos)[0], pos + 4
        return _U32.unpack_from(buf, pos)[0], pos + 4
    raise ProtobufError(f"wire type {wire} for a {kind} field")


def skip_field(buf, pos: int, wire: int, number: int = 0) -> int:
    """Position after a field's value of wire type `wire`."""
    if wire == VARINT:
        return read_varint(buf, pos)[1]
    if wire == FIXED64:
        return pos + 8
    if wire == FIXED32:
        return pos + 4
    if wire == LENGTH:
        n, pos = read_varint(buf, pos)
        if pos + n > len(buf):
            raise ProtobufError("truncated length-delimited field")
        return pos + n
    if wire == START_GROUP:  # deprecated groups: skip to the matching end
        while True:
            key, pos = read_varint(buf, pos)
            if key & 7 == END_GROUP:
                if key >> 3 != number:
                    raise ProtobufError("mismatched protobuf group end")
                return pos
            pos = skip_field(buf, pos, key & 7, key >> 3)
    raise ProtobufError(f"unknown wire type {wire}")


def read_message(buf, schema: dict, pos: int = 0, end: int = None) -> dict:
    """Decode the message in `buf[pos:end]` by `schema` into a dict."""
    end = len(buf) if end is None else end
    out: dict = {}
    while pos < end:
        key, pos = read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        spec = schema.get(number)
        if spec is None:
            pos = skip_field(buf, pos, wire, number)
            continue
        name, kind = spec[0], spec[1]
        repeated = len(spec) > 2
        if isinstance(kind, dict):
            if wire != LENGTH:
                raise ProtobufError(f"field {name}: a message with wire type {wire}")
            n, pos = read_varint(buf, pos)
            if pos + n > end:
                raise ProtobufError(f"field {name}: truncated message")
            value = read_message(buf, kind, pos, pos + n)
            pos += n
        elif kind in ("string", "bytes"):
            if wire != LENGTH:
                raise ProtobufError(f"field {name}: {kind} with wire type {wire}")
            n, pos = read_varint(buf, pos)
            if pos + n > end:
                raise ProtobufError(f"field {name}: truncated {kind}")
            raw = bytes(buf[pos:pos + n])
            value = raw.decode("utf-8", "replace") if kind == "string" else raw
            pos += n
        elif wire == LENGTH and repeated:  # packed scalars
            n, pos = read_varint(buf, pos)
            stop = pos + n
            items = out.setdefault(name, [])
            own = _WIRE[kind]
            while pos < stop:
                v, pos = _scalar(kind, own, buf, pos)
                items.append(v)
            if pos != stop:
                raise ProtobufError(f"field {name}: packed values overrun")
            continue
        else:
            value, pos = _scalar(kind, wire, buf, pos)
        if repeated:
            out.setdefault(name, []).append(value)
        else:
            out[name] = value
    if pos != end:
        raise ProtobufError("message overruns its length")
    return out


def _put_scalar(out: bytearray, kind: str, v) -> None:
    if kind == "uint":
        write_varint(out, int(v))
    elif kind == "sint":
        write_varint(out, zigzag_encode(int(v)))
    elif kind == "bool":
        out.append(1 if v else 0)
    elif kind == "double":
        out += _F64.pack(v)
    elif kind == "float":
        out += _F32.pack(v)
    elif kind == "fixed64":
        out += _U64.pack(v)
    elif kind == "fixed32":
        out += _U32.pack(v)
    else:
        raise ProtobufError(f"unknown scalar kind {kind}")


def write_message(schema: dict, values: dict) -> bytes:
    """Encode `values` (a dict keyed by field name) by `schema`, in field
    number order; a missing or None field is left out."""
    out = bytearray()
    for number in sorted(schema):
        spec = schema[number]
        name, kind = spec[0], spec[1]
        repeated = len(spec) > 2
        v = values.get(name)
        if v is None:
            continue
        items = list(v) if repeated else [v]
        if repeated and not isinstance(kind, dict) and kind not in ("string", "bytes"):
            if not items:
                continue
            body = bytearray()
            for item in items:
                _put_scalar(body, kind, item)
            write_varint(out, number << 3 | LENGTH)
            write_varint(out, len(body))
            out += body
            continue
        for item in items:
            if isinstance(kind, dict):
                body = write_message(kind, item)
            elif kind in ("string", "bytes"):
                body = item.encode("utf-8") if isinstance(item, str) else bytes(item)
            else:
                write_varint(out, number << 3 | _WIRE[kind])
                _put_scalar(out, kind, item)
                continue
            write_varint(out, number << 3 | LENGTH)
            write_varint(out, len(body))
            out += body
    return bytes(out)

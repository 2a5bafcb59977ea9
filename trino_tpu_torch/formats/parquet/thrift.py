"""The Thrift compact protocol, reading and writing, and the parquet-format
structs the reader and writer use (reference: lib/trino-parquet reads the
footer through parquet-format's generated `FileMetaData`, `PageHeader` and
friends; the field ids below are parquet.thrift's).

A struct decodes into a dict keyed by field name.  A field id that the spec
does not name is skipped by its wire type, whatever that type is: writers
add fields newer than any copy of the spec (pyarrow writes size statistics,
for one), and a reader must step over them.
"""

from __future__ import annotations

import struct

# compact-protocol wire types
STOP = 0
TRUE = 1
FALSE = 2
BYTE = 3
I16 = 4
I32 = 5
I64 = 6
DOUBLE = 7
BINARY = 8
LIST = 9
SET = 10
MAP = 11
STRUCT = 12

_DOUBLE = struct.Struct("<d")


class ThriftError(ValueError):
    """Malformed compact-protocol input."""


class Reader:
    """Decodes compact-protocol values from a bytes-like buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        try:
            b = self.buf[self.pos]
        except IndexError:
            raise ThriftError("truncated thrift input") from None
        self.pos += 1
        return b

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 70:
                raise ThriftError("varint too long")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def binary(self) -> bytes:
        n = self.varint()
        end = self.pos + n
        if end > len(self.buf):
            raise ThriftError("truncated thrift binary")
        out = bytes(self.buf[self.pos:end])
        self.pos = end
        return out

    def value(self, wire: int, kind):
        """One value of `wire` type; `kind` (the spec's entry) shapes
        structs, lists and strings."""
        if wire == TRUE:
            return True
        if wire == FALSE:
            return False
        if wire == BYTE:
            b = self.byte()
            return b - 256 if b > 127 else b
        if wire in (I16, I32, I64):
            return self.zigzag()
        if wire == DOUBLE:
            v = _DOUBLE.unpack_from(self.buf, self.pos)[0]
            self.pos += 8
            return v
        if wire == BINARY:
            raw = self.binary()
            return raw.decode("utf-8") if kind == "str" else raw
        if wire == STRUCT:
            return self.struct(kind if isinstance(kind, dict) else {})
        if wire in (LIST, SET):
            elem_kind = kind[1] if isinstance(kind, tuple) else None
            size, elem = self.list_header()
            if elem in (TRUE, FALSE):  # a bool inside a container is a byte
                return [self.byte() == TRUE for _ in range(size)]
            return [self.value(elem, elem_kind) for _ in range(size)]
        raise ThriftError(f"thrift wire type {wire} where the spec names a field")

    def list_header(self):
        h = self.byte()
        size = h >> 4
        if size == 15:
            size = self.varint()
        return size, h & 0x0F

    def struct(self, spec: dict) -> dict:
        """Decode one struct; fields the spec does not name are skipped."""
        out = {}
        last = 0
        while True:
            h = self.byte()
            wire = h & 0x0F
            if wire == STOP:
                return out
            delta = h >> 4
            fid = last + delta if delta else self.zigzag()
            last = fid
            field = spec.get(fid)
            if field is None:
                self.skip(wire)
                continue
            name, kind = field
            out[name] = self.value(wire, kind)

    def skip(self, wire: int) -> None:
        if wire in (TRUE, FALSE):
            return
        if wire == BYTE:
            self.pos += 1
        elif wire in (I16, I32, I64):
            self.varint()
        elif wire == DOUBLE:
            self.pos += 8
        elif wire == BINARY:
            n = self.varint()
            self.pos += n
        elif wire == STRUCT:
            while True:
                h = self.byte()
                w = h & 0x0F
                if w == STOP:
                    break
                if not h >> 4:
                    self.zigzag()
                self.skip(w)
        elif wire in (LIST, SET):
            size, elem = self.list_header()
            for _ in range(size):
                if elem in (TRUE, FALSE):
                    self.pos += 1
                else:
                    self.skip(elem)
        elif wire == MAP:
            size = self.varint()
            if size:
                kv = self.byte()
                for _ in range(size):
                    for w in (kv >> 4, kv & 0x0F):
                        if w in (TRUE, FALSE):
                            self.pos += 1
                        else:
                            self.skip(w)
        else:
            raise ThriftError(f"unknown thrift wire type {wire}")
        if self.pos > len(self.buf):
            raise ThriftError("truncated thrift input")


class Writer:
    """Encodes compact-protocol structs into a bytearray."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        out = self.out
        while v > 0x7F:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def struct(self, spec: dict, obj: dict) -> None:
        """Write the fields of `obj` (name -> value) that the spec names, in
        field-id order; a value of None is left out."""
        last = 0
        for fid in sorted(spec):
            name, kind = spec[fid]
            v = obj.get(name)
            if v is None:
                continue
            wire = (TRUE if v else FALSE) if kind == "bool" else _wire_of(kind)
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | wire)
            else:
                self.out.append(wire)
                self.zigzag(fid)
            last = fid
            if kind != "bool":
                self._value(kind, v)
        self.out.append(STOP)

    def _value(self, kind, v) -> None:
        if isinstance(kind, dict):
            self.struct(kind, v)
        elif isinstance(kind, tuple):  # ("list", elem kind)
            elem = kind[1]
            ew = TRUE if elem == "bool" else _wire_of(elem)
            n = len(v)
            if n < 15:
                self.out.append((n << 4) | ew)
            else:
                self.out.append(0xF0 | ew)
                self.varint(n)
            for x in v:
                if elem == "bool":
                    self.out.append(TRUE if x else FALSE)
                else:
                    self._value(elem, x)
        elif kind == "i8":
            self.out.append(v & 0xFF)
        elif kind in ("i16", "i32", "i64"):
            self.zigzag(int(v))
        elif kind == "double":
            self.out += _DOUBLE.pack(v)
        elif kind in ("str", "binary"):
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self.varint(len(raw))
            self.out += raw
        else:
            raise ThriftError(f"unknown spec kind {kind!r}")


_WIRE = {
    "i8": BYTE,
    "i16": I16,
    "i32": I32,
    "i64": I64,
    "double": DOUBLE,
    "str": BINARY,
    "binary": BINARY,
}


def _wire_of(kind) -> int:
    if isinstance(kind, dict):
        return STRUCT
    if isinstance(kind, tuple):
        return LIST
    return _WIRE[kind]


def read_struct(buf, spec: dict, pos: int = 0):
    """Decode one struct at `pos`; returns (dict, position after it)."""
    r = Reader(buf, pos)
    return r.struct(spec), r.pos


def write_struct(spec: dict, obj: dict) -> bytes:
    w = Writer()
    w.struct(spec, obj)
    return bytes(w.out)


# -- parquet.thrift ---------------------------------------------------------
# Each spec maps field id -> (name, kind); kind is "bool", "i8", "i16",
# "i32", "i64", "double", "str", "binary", a nested struct spec (unions are
# structs with one field set), or ("list", element kind).

EMPTY: dict = {}

TIME_UNIT = {1: ("MILLIS", EMPTY), 2: ("MICROS", EMPTY), 3: ("NANOS", EMPTY)}

DECIMAL_TYPE = {1: ("scale", "i32"), 2: ("precision", "i32")}
TIMESTAMP_TYPE = {1: ("isAdjustedToUTC", "bool"), 2: ("unit", TIME_UNIT)}
INT_TYPE = {1: ("bitWidth", "i8"), 2: ("isSigned", "bool")}

LOGICAL_TYPE = {
    1: ("STRING", EMPTY),
    2: ("MAP", EMPTY),
    3: ("LIST", EMPTY),
    4: ("ENUM", EMPTY),
    5: ("DECIMAL", DECIMAL_TYPE),
    6: ("DATE", EMPTY),
    7: ("TIME", TIMESTAMP_TYPE),
    8: ("TIMESTAMP", TIMESTAMP_TYPE),
    10: ("INTEGER", INT_TYPE),
    11: ("UNKNOWN", EMPTY),
    12: ("JSON", EMPTY),
    13: ("BSON", EMPTY),
    14: ("UUID", EMPTY),
    15: ("FLOAT16", EMPTY),
}

SCHEMA_ELEMENT = {
    1: ("type", "i32"),
    2: ("type_length", "i32"),
    3: ("repetition_type", "i32"),
    4: ("name", "str"),
    5: ("num_children", "i32"),
    6: ("converted_type", "i32"),
    7: ("scale", "i32"),
    8: ("precision", "i32"),
    9: ("field_id", "i32"),
    10: ("logicalType", LOGICAL_TYPE),
}

COLUMN_META_DATA = {
    1: ("type", "i32"),
    2: ("encodings", ("list", "i32")),
    3: ("path_in_schema", ("list", "str")),
    4: ("codec", "i32"),
    5: ("num_values", "i64"),
    6: ("total_uncompressed_size", "i64"),
    7: ("total_compressed_size", "i64"),
    9: ("data_page_offset", "i64"),
    11: ("dictionary_page_offset", "i64"),
}

COLUMN_CHUNK = {
    1: ("file_path", "str"),
    2: ("file_offset", "i64"),
    3: ("meta_data", COLUMN_META_DATA),
}

ROW_GROUP = {
    1: ("columns", ("list", COLUMN_CHUNK)),
    2: ("total_byte_size", "i64"),
    3: ("num_rows", "i64"),
    5: ("file_offset", "i64"),
    6: ("total_compressed_size", "i64"),
    7: ("ordinal", "i16"),
}

FILE_META_DATA = {
    1: ("version", "i32"),
    2: ("schema", ("list", SCHEMA_ELEMENT)),
    3: ("num_rows", "i64"),
    4: ("row_groups", ("list", ROW_GROUP)),
    6: ("created_by", "str"),
}

DATA_PAGE_HEADER = {
    1: ("num_values", "i32"),
    2: ("encoding", "i32"),
    3: ("definition_level_encoding", "i32"),
    4: ("repetition_level_encoding", "i32"),
}

DICTIONARY_PAGE_HEADER = {
    1: ("num_values", "i32"),
    2: ("encoding", "i32"),
    3: ("is_sorted", "bool"),
}

DATA_PAGE_HEADER_V2 = {
    1: ("num_values", "i32"),
    2: ("num_nulls", "i32"),
    3: ("num_rows", "i32"),
    4: ("encoding", "i32"),
    5: ("definition_levels_byte_length", "i32"),
    6: ("repetition_levels_byte_length", "i32"),
    7: ("is_compressed", "bool"),
}

PAGE_HEADER = {
    1: ("type", "i32"),
    2: ("uncompressed_page_size", "i32"),
    3: ("compressed_page_size", "i32"),
    5: ("data_page_header", DATA_PAGE_HEADER),
    7: ("dictionary_page_header", DICTIONARY_PAGE_HEADER),
    8: ("data_page_header_v2", DATA_PAGE_HEADER_V2),
}

# enums (parquet.thrift)
PHYSICAL_TYPES = (
    "BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
    "FIXED_LEN_BYTE_ARRAY",
)
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE_T, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)

REQUIRED, OPTIONAL, REPEATED = 0, 1, 2

CONVERTED_TYPES = (
    "UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL", "DATE",
    "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS", "TIMESTAMP_MICROS",
    "UINT_8", "UINT_16", "UINT_32", "UINT_64", "INT_8", "INT_16", "INT_32",
    "INT_64", "JSON", "BSON", "INTERVAL",
)
CT = {name: i for i, name in enumerate(CONVERTED_TYPES)}

ENCODINGS = {
    0: "PLAIN",
    1: "GROUP_VAR_INT",
    2: "PLAIN_DICTIONARY",
    3: "RLE",
    4: "BIT_PACKED",
    5: "DELTA_BINARY_PACKED",
    6: "DELTA_LENGTH_BYTE_ARRAY",
    7: "DELTA_BYTE_ARRAY",
    8: "RLE_DICTIONARY",
    9: "BYTE_STREAM_SPLIT",
}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8

CODECS = {
    0: "UNCOMPRESSED",
    1: "SNAPPY",
    2: "GZIP",
    3: "LZO",
    4: "BROTLI",
    5: "LZ4",
    6: "ZSTD",
    7: "LZ4_RAW",
}
UNCOMPRESSED, SNAPPY, GZIP = 0, 1, 2

DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 1, 2, 3

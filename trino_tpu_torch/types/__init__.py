"""SQL type system.

Role analog of the reference engine's ``spi/type/Type.java`` hierarchy
(reference: core/trino-spi/src/main/java/io/trino/spi/type/Type.java), but
designed around device representation: every SQL type maps to a fixed-width
numpy/JAX dtype so that whole columns are dense device arrays.  Variable-width
values (VARCHAR/CHAR/VARBINARY) are dictionary-encoded at ingest with
*order-preserving* codes (see columnar.dictionary), so comparisons and sorts on
the device operate on i32 codes directly.

DECIMAL(p, s) with p <= 18 is a scaled i64 ("short decimal"), exactly like the
reference's long-encoded short decimals (spi/type/DecimalType.java) — this keeps
TPC-H money arithmetic in fast integer ops instead of f64.

Port of trino_tpu/types/__init__.py, with one difference: the simple types
(`DATE`, `TIMESTAMP`, `BIGINT`, ...) and `UNKNOWN` unpickle to this
module's own instances.  Decoders and the analyzer test them by identity
(`t is DATE`), and plan fragments and page sets cross the multi-host tier
as pickles; a copy would decode a date as its day number.  (The JAX
package's types unpickle as copies, so its multi-host runner returns a
DATE column as integers.)
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Type",
    "BOOLEAN",
    "TINYINT",
    "SMALLINT",
    "INTEGER",
    "BIGINT",
    "REAL",
    "DOUBLE",
    "DATE",
    "TIMESTAMP",
    "TIMESTAMP_TZ",
    "INTERVAL_DAY",
    "parse_time_micros",
    "INTERVAL_YEAR_MONTH",
    "TIME",
    "pack_tz",
    "unpack_tz_millis",
    "unpack_tz_offset",
    "zone_offset_minutes",
    "UNKNOWN",
    "DecimalType",
    "VarcharType",
    "CharType",
    "VarbinaryType",
    "VARCHAR",
    "VARBINARY",
    "ArrayType",
    "MapType",
    "RowType",
    "parse_type",
    "common_super_type",
    "is_numeric",
    "is_integer_kind",
    "is_string_kind",
]


class Type:
    """Base SQL type. Immutable; equality by (name, params)."""

    #: SQL display name, e.g. 'bigint', 'decimal(12,2)'
    name: str = "unknown"
    #: numpy dtype of the device representation
    np_dtype: np.dtype = np.dtype(np.int64)
    #: whether ORDER BY / comparisons are defined
    orderable: bool = True
    comparable: bool = True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return self.name

    def __eq__(self, other) -> bool:
        return isinstance(other, Type) and self.name == other.name

    def __hash__(self) -> int:
        return hash(self.name)

    @property
    def is_dictionary_encoded(self) -> bool:
        return isinstance(self, (VarcharType, CharType, VarbinaryType))

    def null_device_value(self):
        """Fill value used in device arrays under a null mask."""
        if np.issubdtype(self.np_dtype, np.floating):
            return self.np_dtype.type(0.0)
        if self.np_dtype == np.dtype(bool):
            return False
        return self.np_dtype.type(0)


#: name -> the module's instance of each simple type (pickle identity)
_SIMPLES: dict = {}


def _simple_type(name: str) -> "Type":
    return _SIMPLES[name]


class _Simple(Type):
    def __init__(self, name: str, np_dtype, orderable: bool = True):
        self.name = name
        self.np_dtype = np.dtype(np_dtype)
        self.orderable = orderable
        self.comparable = True
        _SIMPLES.setdefault(name, self)

    def __reduce__(self):
        return (_simple_type, (self.name,))


BOOLEAN = _Simple("boolean", bool)
TINYINT = _Simple("tinyint", np.int8)
SMALLINT = _Simple("smallint", np.int16)
INTEGER = _Simple("integer", np.int32)
BIGINT = _Simple("bigint", np.int64)
REAL = _Simple("real", np.float32)
DOUBLE = _Simple("double", np.float64)
#: days since 1970-01-01, i32 (reference: spi/type/DateType.java)
DATE = _Simple("date", np.int32)
#: microseconds since epoch, i64 (reference: spi/type/TimestampType.java, p=6)
TIMESTAMP = _Simple("timestamp", np.int64)
#: packed UTC-millis + zone offset, i64 (reference: spi/type/
#: TimestampWithTimeZoneType.java + DateTimeEncoding.packDateTimeWithZone:
#: millis << 12 | zoneKey).  Our 12-bit zone key is the fixed UTC offset in
#: minutes biased by +2048 (zone rules are applied host-side when a value is
#: created, so each device value carries the offset that was in force at its
#: instant — rendering and extract are pure device arithmetic).
TIMESTAMP_TZ = _Simple("timestamp with time zone", np.int64)
#: bias/encoding constants for TIMESTAMP_TZ packing
TZ_OFFSET_BIAS = 2048
TZ_SHIFT = 4096  # 12 bits


def pack_tz(utc_millis: int, offset_minutes: int) -> int:
    return utc_millis * TZ_SHIFT + (offset_minutes + TZ_OFFSET_BIAS)


def unpack_tz_millis(packed):
    """UTC instant millis (device-safe: works on arrays)."""
    return packed // TZ_SHIFT


def unpack_tz_offset(packed):
    """Zone offset minutes (device-safe)."""
    return packed % TZ_SHIFT - TZ_OFFSET_BIAS
#: interval day-to-second, microseconds, i64
INTERVAL_DAY = _Simple("interval day to second", np.int64)
#: time of day, microseconds since midnight, i64
#: (reference: spi/type/TimeType.java, p=6 equivalent)
TIME = _Simple("time", np.int64)
#: interval year-to-month, whole months, i64
#: (reference: type/IntervalYearMonthType.java over int months)
INTERVAL_YEAR_MONTH = _Simple("interval year to month", np.int64)


class _Unknown(Type):
    """The type of a bare NULL literal (reference: spi UnknownType)."""

    def __init__(self):
        self.name = "unknown"
        self.np_dtype = np.dtype(np.int64)
        self.orderable = True
        self.comparable = True

    def __reduce__(self):
        return "UNKNOWN"


UNKNOWN = _Unknown()


class DecimalType(Type):
    """Decimal: scaled i64 for precision <= 18 (short), two-limb i128 planes
    stacked on the last axis ([..., 2] int64: hi, lo-bits) for 19-38 (long).

    Reference: spi/type/DecimalType.java — long-encoded short decimals and
    Int128-encoded long decimals (spi/type/Int128.java); the limb math lives
    in types/int128.py.
    """

    def __init__(self, precision: int = 38, scale: int = 0):
        if precision > 38:
            raise ValueError(f"decimal precision {precision} exceeds 38")
        self.precision = precision
        self.scale = scale
        self.name = f"decimal({precision},{scale})"
        self.np_dtype = np.dtype(np.int64)
        self.orderable = True
        self.comparable = True

    @property
    def is_long(self) -> bool:
        """True when the device representation is two i64 limbs."""
        return self.precision > 18

    @property
    def scale_factor(self) -> int:
        return 10 ** self.scale


class VarcharType(Type):
    """Dictionary-encoded string: device value is an i32 code.

    Codes are *order preserving* within a single dictionary (see
    columnar.dictionary.StringDictionary), so <, >, ORDER BY work on codes when
    both sides share a dictionary; general cross-dictionary comparison re-encodes.
    Reference: spi/type/VarcharType.java.
    """

    UNBOUNDED = 2**31 - 1

    def __init__(self, length: int | None = None):
        self.length = VarcharType.UNBOUNDED if length is None else length
        self.name = (
            "varchar"
            if self.length == VarcharType.UNBOUNDED
            else f"varchar({self.length})"
        )
        self.np_dtype = np.dtype(np.int32)
        self.orderable = True
        self.comparable = True


VARCHAR = VarcharType()


class CharType(Type):
    """CHAR(n); same device representation as varchar (reference: spi/type/CharType.java)."""

    def __init__(self, length: int):
        self.length = length
        self.name = f"char({length})"
        self.np_dtype = np.dtype(np.int32)
        self.orderable = True
        self.comparable = True


class VarbinaryType(Type):
    def __init__(self):
        self.name = "varbinary"
        self.np_dtype = np.dtype(np.int32)
        self.orderable = False
        self.comparable = True


VARBINARY = VarbinaryType()


class ArrayType(Type):
    """Fixed-capacity array-of-T (round-1: host-side only semantics)."""

    def __init__(self, element: Type):
        self.element = element
        self.name = f"array({element.name})"
        self.np_dtype = element.np_dtype
        self.orderable = False
        self.comparable = True


class MapType(Type):
    """map(K, V) in a packed rectangular device layout.

    Reference: spi/type/MapType.java + spi/block/MapBlock.java (keys block +
    values block + per-row offsets).  Device layout: `data` is
    [capacity, 2*K] with keys in slots [0:K] and values in slots [K:2K];
    `lengths` counts entries per row (<= K).  Static shapes keep XLA happy;
    K grows by pow2 buckets at construction.  If both sides are strings they
    share ONE merged dictionary (so a single Column.dictionary covers both
    planes); otherwise the dictionary belongs to whichever side is a string.
    """

    def __init__(self, key: Type, value: Type):
        self.key = key
        self.value = value
        self.name = f"map({key.name}, {value.name})"
        kd, vd = np.dtype(key.np_dtype), np.dtype(value.np_dtype)
        if kd.kind == "f" or vd.kind == "f":
            self.np_dtype = np.dtype(np.float64)
        else:
            self.np_dtype = np.dtype(np.int64)
        self.orderable = False
        self.comparable = True


class RowType(Type):
    def __init__(self, fields: list[tuple[str | None, Type]]):
        self.fields = tuple(fields)
        inner = ", ".join(
            (f"{n} {t.name}" if n else t.name) for n, t in self.fields
        )
        self.name = f"row({inner})"
        self.np_dtype = np.dtype(np.int64)
        self.orderable = False
        self.comparable = True


# ---------------------------------------------------------------------------
# type algebra helpers


def zone_offset_minutes(zone: str, utc_millis: int | None = None) -> int:
    """Resolve a zone name / '+HH:MM' offset to minutes east of UTC.

    Named zones use stdlib zoneinfo when tzdata is present; the offset is
    evaluated at `utc_millis` (DST-correct for that instant), defaulting to
    the current time.  Reference: spi/type/TimeZoneKey.java.
    """
    z = zone.strip()
    if z.upper() in ("UTC", "Z", "GMT"):
        return 0
    if z and z[0] in "+-":
        sign = -1 if z[0] == "-" else 1
        body = z[1:]
        if ":" in body:
            h, m = body.split(":")
        else:
            h, m = body, "0"
        return sign * (int(h) * 60 + int(m or 0))
    import datetime

    try:
        from zoneinfo import ZoneInfo

        tz = ZoneInfo(z)
    except Exception as e:  # no tzdata or unknown zone
        raise ValueError(f"unknown time zone: {zone!r}") from e
    if utc_millis is None:
        dt = datetime.datetime.now(tz)
    else:
        dt = datetime.datetime.fromtimestamp(utc_millis / 1000.0, tz)
    off = dt.utcoffset()
    return int(off.total_seconds() // 60) if off is not None else 0


_SIMPLE_BY_NAME = {
    t.name: t
    for t in (
        BOOLEAN,
        TINYINT,
        SMALLINT,
        INTEGER,
        BIGINT,
        REAL,
        DOUBLE,
        DATE,
        TIMESTAMP,
        TIMESTAMP_TZ,
        TIME,
        INTERVAL_DAY,
        INTERVAL_YEAR_MONTH,
        UNKNOWN,
    )
}
_SIMPLE_BY_NAME["timestamptz"] = TIMESTAMP_TZ
#: the JSON type rides the varchar representation (json path functions
#: parse per dictionary value; reference: spi JsonType over Slice)
_SIMPLE_BY_NAME["json"] = VARCHAR
_SIMPLE_BY_NAME["varchar"] = VARCHAR
_SIMPLE_BY_NAME["varbinary"] = VARBINARY
_SIMPLE_BY_NAME["string"] = VARCHAR  # convenience alias


def parse_time_micros(text: str) -> int:
    """'HH:MM:SS(.fff)?' -> microseconds since midnight, range-checked
    (reference: TimeType parsing rejects out-of-range components)."""
    parts = text.strip().split(":")
    h = int(parts[0]) if parts and parts[0] else 0
    mi = int(parts[1]) if len(parts) > 1 else 0
    sec = float(parts[2]) if len(parts) > 2 else 0.0
    if not (0 <= h < 24 and 0 <= mi < 60 and 0.0 <= sec < 60.0):
        raise ValueError(f"invalid TIME value: {text!r}")
    return (h * 3600 + mi * 60) * 1_000_000 + int(round(sec * 1_000_000))


def parse_type(text: str) -> Type:
    """Parse a SQL type name, e.g. 'decimal(12,2)', 'varchar(25)'."""
    s = text.strip().lower()
    if s.endswith(" without time zone"):
        s = s[: -len(" without time zone")].strip()
    if s in _SIMPLE_BY_NAME:
        return _SIMPLE_BY_NAME[s]
    if s.startswith("decimal"):
        if "(" in s:
            inner = s[s.index("(") + 1 : s.rindex(")")]
            parts = [p.strip() for p in inner.split(",")]
            p = int(parts[0])
            sc = int(parts[1]) if len(parts) > 1 else 0
            return DecimalType(p, sc)
        return DecimalType(38, 0)
    if s.startswith("varchar("):
        return VarcharType(int(s[8:-1]))
    if s.startswith("char("):
        return CharType(int(s[5:-1]))
    if s == "char":
        return CharType(1)
    if s.startswith("array(") or s.startswith("array<"):
        return ArrayType(parse_type(s[6:-1]))
    if s.startswith("map(") or s.startswith("map<"):
        inner = s[4:-1]
        depth = 0
        for i, ch in enumerate(inner):
            if ch in "(<":
                depth += 1
            elif ch in ")>":
                depth -= 1
            elif ch == "," and depth == 0:
                return MapType(parse_type(inner[:i]), parse_type(inner[i + 1:]))
        raise ValueError(f"bad map type: {text!r}")
    raise ValueError(f"unknown type: {text!r}")


_NUMERIC_ORDER = {
    "tinyint": 0,
    "smallint": 1,
    "integer": 2,
    "bigint": 3,
    "real": 5,
    "double": 6,
}


def is_integer_kind(t: Type) -> bool:
    return t.name in ("tinyint", "smallint", "integer", "bigint")


def is_numeric(t: Type) -> bool:
    return t.name in _NUMERIC_ORDER or isinstance(t, DecimalType)


def is_string_kind(t: Type) -> bool:
    return isinstance(t, (VarcharType, CharType))


#: max decimal digits of each integer type (reference: TypeCoercion's
#: bigint-as-decimal(19,0) etc.)
INT_DIGITS = {"tinyint": 3, "smallint": 5, "integer": 10, "bigint": 19}


def common_super_type(a: Type, b: Type) -> Type:
    """Least common type for binary operations / UNION / CASE branches.

    Mirrors the coercion lattice of the reference's TypeCoercion
    (core/trino-main/.../type/TypeCoercion.java), restricted to the types the
    engine implements.
    """
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    if is_string_kind(a) and is_string_kind(b):
        return VARCHAR
    da, db = isinstance(a, DecimalType), isinstance(b, DecimalType)
    if da or db:
        if da and db:
            scale = max(a.scale, b.scale)
            intd = max(a.precision - a.scale, b.precision - b.scale)
            return DecimalType(min(intd + scale, 38), scale)
        other = b if da else a
        dec = a if da else b
        if other.name in ("tinyint", "smallint", "integer", "bigint"):
            intd = max(dec.precision - dec.scale, INT_DIGITS[other.name])
            return DecimalType(min(max(intd + dec.scale, 18), 38), dec.scale)
        if other.name in ("real", "double"):
            return DOUBLE
        raise TypeError(f"no common type for {a} and {b}")
    if a.name in _NUMERIC_ORDER and b.name in _NUMERIC_ORDER:
        return a if _NUMERIC_ORDER[a.name] >= _NUMERIC_ORDER[b.name] else b
    if {a.name, b.name} == {"date", "timestamp"}:
        return TIMESTAMP
    if TIMESTAMP_TZ.name in (a.name, b.name) and {a.name, b.name} <= {
        "date",
        "timestamp",
        TIMESTAMP_TZ.name,
    }:
        return TIMESTAMP_TZ
    raise TypeError(f"no common type for {a} and {b}")

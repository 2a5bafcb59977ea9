"""The port's temporal types against the JAX package's.

IR level: each case builds the same expression in both packages' IR and
compiles it with each package's ExprCompiler over one batch of 64 rows made
from a numpy seed: TIMESTAMP micros from 1887 to 2052 with the edges
(just before the epoch, just before midnight, leap days, month ends, the
first instant of 1900), TIMESTAMP WITH TIME ZONE values packed at offsets
-12:00, -03:30, 0, +05:30 and +14:00, TIME values up to 23:59:59.999999,
DATE values, interval micros, doubles with NaN, infinities, 1e300 and -0.5
for from_unixtime, and varchar timestamps and times to parse, every column
with NULL rows and dead rows.  The cases: the civil-date functions over
timestamps and tz values, date_trunc, date_add and date_diff in every unit,
hour/minute/second/millisecond, the zone functions, from_unixtime and
to_unixtime, and every cast among date, time, timestamp, timestamptz and
varchar.  Where the JAX package raises, the port raises the same class.

Difference kept on purpose: from_unixtime over a decimal converts the
exact value (milliseconds truncated toward zero), held to a plain Python
oracle; the JAX package reads a short decimal's scaled integer as seconds
and fails on a long decimal's limb planes.

SQL: the 13 cases of tests/test_timestamptz.py and the 8 of
tests/test_date_functions.py through both LocalQueryRunners (the memory
table of the last timestamptz case becomes a VALUES relation with the same
rows; current_timestamp is held by the JAX test's own
check in each package), and chip_smoke.py's phase-5j statements T1-T3 at
tpch.tiny through the port's LocalQueryRunner and its 4-worker mesh, each
held to the JAX package's local rows (T1 with `pallas_agg` on as well,
where it takes the grouped-sums kernel's plain version).

Tolerances: integers, dates, timestamps, tz values (instant and offset),
booleans and strings exact, with the same validity; doubles relative 1e-9.
"""

import datetime
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar import StringDictionary as JDict
from trino_tpu.columnar.builders import column_from_values as jcolumn_from_values
from trino_tpu.expr import ExprCompiler as JCompiler
from trino_tpu.expr import ir as jir
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.columnar import StringDictionary as TDict
from trino_tpu_torch.columnar.builders import column_from_values as tcolumn_from_values
from trino_tpu_torch.expr import ExprCompiler as TCompiler
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.ops import grouped_sums as gs
from trino_tpu_torch.parallel import DistributedQueryRunner
from trino_tpu_torch.runtime.runner import LocalQueryRunner
from trino_tpu_torch.testing import assert_rows_match, result_order

import chip_smoke

N = 64
DAY = 86_400_000_000
OFFSETS = [-720, -210, 0, 330, 840]


class Harness:
    """One seeded batch in both packages: `cols` is [(name, type name, data,
    valid, dictionary words or None)]; dictionary columns carry codes
    outside their dictionary on NULL rows (the JAX package gathers with
    take(mode="clip"); the port clamps)."""

    def __init__(self, cols, mask):
        self.mask = mask
        self.ch = {name: k for k, (name, *_rest) in enumerate(cols)}
        self.types = {name: tname for name, tname, *_rest in cols}
        jcols, tcols = [], []
        for name, tname, data, valid, words in cols:
            if words is not None:
                order = {w: k for k, w in enumerate(sorted(set(words)))}
                data = np.array([order[words[c]] for c in data], dtype=np.int32)
                bad = np.flatnonzero(~valid)
                data[bad] = np.where(np.arange(bad.size) % 2 == 0, 999, -5)
            jd = JDict(sorted(set(words))) if words is not None else None
            td = TDict(sorted(set(words))) if words is not None else None
            jcols.append(JColumn(jnp.asarray(data), JT.parse_type(tname), jnp.asarray(valid), jd))
            tcols.append(TColumn(torch.from_numpy(np.ascontiguousarray(data)),
                                 TT.parse_type(tname), torch.from_numpy(valid), td))
        self.jb = JBatch(jcols, jnp.asarray(mask))
        self.tb = TBatch(tcols, torch.from_numpy(mask))

    def both(self, make_expr):
        return make_expr(Both(jir, JT, self)), make_expr(Both(tir, TT, self))

    def check(self, make_expr):
        """Compile in both packages and hold the port's column to the JAX
        package's on the live rows."""
        je, te = self.both(make_expr)
        jc = JCompiler(self.jb).column(je)
        tc = TCompiler(self.tb).column(te)
        assert tc.type.name == jc.type.name
        n = self.mask.shape[0]
        jv = np.ones(n, bool) if jc.valid is None else np.asarray(jc.valid)
        tv = np.ones(n, bool) if tc.valid is None else np.asarray(tc.valid)
        live = self.mask
        np.testing.assert_array_equal(tv[live], jv[live])
        assert str(tc.data.numpy().dtype) == str(np.asarray(jc.data).dtype)
        jvals, tvals = values_of(jc, jv), values_of(tc, tv)
        for k in np.flatnonzero(live & jv):
            a, e = tvals[k], jvals[k]
            if isinstance(e, float):
                assert (math.isnan(a) and math.isnan(e)) or a == e or math.isclose(
                    a, e, rel_tol=1e-9, abs_tol=0.0
                ), (k, a, e)
            else:
                assert a == e, (k, a, e)
        return jc, tc

    def raises(self, make_expr, exc=NotImplementedError):
        je, te = self.both(make_expr)
        with pytest.raises(exc):
            JCompiler(self.jb).column(je)
        with pytest.raises(exc):
            TCompiler(self.tb).column(te)


def values_of(col, valid):
    data = np.asarray(col.data)
    if col.dictionary is not None:
        return [col.dictionary.values[int(c)] if v else None for c, v in zip(data, valid)]
    return data.tolist()


class Both:
    """Builds one expression in one package's IR: ``x.col("ts")`` an input
    column, ``x.lit(v, "type")`` a literal, ``x.call(name, type, *args)`` a
    function call, ``x.cast(e, "type")`` a CAST, ``x.s(text)`` a varchar
    literal."""

    def __init__(self, ir, types, h):
        self.ir, self.T, self.h = ir, types, h

    def typ(self, t):
        return self.T.parse_type(t) if isinstance(t, str) else t

    def col(self, name):
        return self.ir.InputRef(self.h.ch[name], self.T.parse_type(self.h.types[name]))

    def lit(self, v, t):
        return self.ir.Literal(v, self.typ(t))

    def s(self, text):
        return self.lit(text, "varchar")

    def call(self, name, t, *args):
        return self.ir.Call(name, list(args), self.typ(t))

    def cast(self, e, t):
        return self.ir.SpecialForm(self.ir.Form.CAST, [e], self.typ(t))


def _pack(millis, off):
    return millis * 4096 + (off + 2048)


TS_WORDS = [
    "2024-01-02 03:04:05", "1969-12-31T23:59:59.5", "2000-02-29", "bad",
    "2001-02-29 00:00:00", "1887-03-01 00:00:00.000001", " 2052-12-31 23:59:59 ",
    "10:11:12", "25:00:00", "23:59:59.999999", "00:00:00", "7:5",
]


def _temporal_columns(seed: int = 29):
    rng = np.random.default_rng(seed)
    nulls = lambda: rng.random(N) >= 0.15  # noqa: E731
    days = rng.integers(-30000, 30000, N)
    ts = days * DAY + rng.integers(0, DAY, N)
    edges = [
        -1, 0, DAY - 1, 11016 * DAY + DAY - 1,  # 2000-02-29 23:59:59.999999
        11353 * DAY + 12 * 3_600_000_000,  # 2001-01-31 12:00
        -25567 * DAY, -25508 * DAY - 1,  # 1900-01-01, the day before 1900-03-01
        -30000 * DAY + 1, 10956 * DAY + 3_599_999_999,
    ]
    ts[: len(edges)] = edges
    ts2 = ts + rng.integers(-400, 400, N) * DAY + rng.integers(-DAY, DAY, N)
    ts2[:4] = [ts[0] + 1, ts[1] - 1, ts[2] + 30 * 60_000_000, ts[3] - 30 * 60_000_000]
    off = np.array(OFFSETS)[rng.integers(0, len(OFFSETS), N)]
    off[: len(OFFSETS)] = OFFSETS
    tz = _pack(np.floor_divide(ts, 1000), off)
    off2 = np.array(OFFSETS)[rng.integers(0, len(OFFSETS), N)]
    tz2 = _pack(np.floor_divide(ts2, 1000), off2)
    tm = rng.integers(0, DAY, N)
    tm[:3] = [0, DAY - 1, 12 * 3_600_000_000]
    dt = rng.integers(-30000, 30000, N).astype(np.int32)
    dt[:6] = [-1, 0, 11016, 11017, 11046, -25567]
    n = rng.integers(-40, 41, N).astype(np.int64)
    n[:4] = [1, -1, 0, 13]
    iv = rng.integers(-3 * DAY, 3 * DAY, N)
    secs = np.round(rng.normal(0, 2e9, N), 3)
    secs[:10] = [np.nan, np.inf, -np.inf, 1e300, -1e300, -0.5, -0.0015, 0.9995, 9.3e15, -1.0]
    k = rng.integers(-10**9, 10**10, N).astype(np.int64)
    words = rng.integers(0, len(TS_WORDS), N).astype(np.int32)
    cols = [
        ("ts", "timestamp", ts, nulls(), None),
        ("ts2", "timestamp", ts2, nulls(), None),
        ("tz", "timestamp with time zone", tz, nulls(), None),
        ("tz2", "timestamp with time zone", tz2, nulls(), None),
        ("tm", "time", tm, nulls(), None),
        ("dt", "date", dt, nulls(), None),
        ("n", "bigint", n, nulls(), None),
        ("iv", "interval day to second", iv, nulls(), None),
        ("secs", "double", secs, nulls(), None),
        ("k", "bigint", k, nulls(), None),
        ("u", "varchar", words, nulls(), TS_WORDS),
    ]
    return cols, rng.random(N) < 0.9


H = Harness(*_temporal_columns())

_FIELDS = ("year", "month", "day", "quarter", "day_of_week", "day_of_year")
_TIME_PARTS = ("hour", "minute", "second", "millisecond")
_UNITS = ("millisecond", "second", "minute", "hour", "day", "week", "month", "quarter", "year")
_TRUNC_UNITS = ("second", "minute", "hour", "day", "week", "month", "quarter", "year")
_ZONES = ("+05:30", "-03:30", "UTC", "+14:00", "-12:00", "Asia/Kolkata")

CASES = {}
for _f in _FIELDS:
    for _c in ("ts", "tz"):
        CASES[f"{_f}_{_c}"] = lambda x, f=_f, c=_c: x.call(f, "bigint", x.col(c))
for _f in ("date_trunc_month", "date_trunc_year"):
    for _c in ("ts", "tz"):
        CASES[f"{_f}_{_c}"] = lambda x, f=_f, c=_c: x.call(f, "date", x.col(c))
for _u in _TRUNC_UNITS:
    for _c, _t in (("ts", "timestamp"), ("tz", "timestamp with time zone"), ("dt", "date")):
        CASES[f"date_trunc_{_u}_{_c}"] = lambda x, u=_u, c=_c, t=_t: x.call(
            "date_trunc", t, x.s(u), x.col(c))
for _u in _UNITS:
    for _c, _t in (("ts", "timestamp"), ("tz", "timestamp with time zone")):
        CASES[f"date_add_{_u}_{_c}"] = lambda x, u=_u, c=_c, t=_t: x.call(
            "date_add", t, x.s(u), x.col("n"), x.col(c))
    CASES[f"date_diff_{_u}_ts"] = lambda x, u=_u: x.call(
        "date_diff", "bigint", x.s(u), x.col("ts"), x.col("ts2"))
    CASES[f"date_diff_{_u}_tz"] = lambda x, u=_u: x.call(
        "date_diff", "bigint", x.s(u), x.col("tz2"), x.col("tz"))
for _u in ("day", "week", "month", "quarter", "year"):
    CASES[f"date_add_{_u}_dt"] = lambda x, u=_u: x.call(
        "date_add", "date", x.s(u), x.col("n"), x.col("dt"))
    CASES[f"date_diff_{_u}_dt_ts"] = lambda x, u=_u: x.call(
        "date_diff", "bigint", x.s(u), x.col("dt"), x.col("ts"))
CASES["date_add_plural_units"] = lambda x: x.call(
    "date_add", "timestamp", x.s("HOURS"), x.col("n"), x.col("ts"))
for _c, _t in (("ts", "timestamp"), ("tz", "timestamp with time zone"), ("dt", "date")):
    CASES[f"date_add_months_{_c}"] = lambda x, c=_c, t=_t: x.call(
        "date_add_months", t, x.col(c), x.col("n"))
for _p in _TIME_PARTS:
    for _c in ("ts", "tz", "tm"):
        CASES[f"{_p}_{_c}"] = lambda x, p=_p, c=_c: x.call(p, "bigint", x.col(c))
CASES["tz_instant"] = lambda x: x.call("$tz_instant", "timestamp", x.col("tz"))
CASES["tz_add_micros"] = lambda x: x.call(
    "$tz_add_micros", "timestamp with time zone", x.col("tz"), x.col("iv"))
for _i, _z in enumerate(_ZONES):
    for _c in ("ts", "tz", "dt"):
        CASES[f"at_timezone_{_c}_{_i}"] = lambda x, c=_c, z=_z: x.call(
            "at_timezone", "timestamp with time zone", x.col(c), x.s(z))
    CASES[f"with_timezone_{_i}"] = lambda x, z=_z: x.call(
        "with_timezone", "timestamp with time zone", x.col("ts"), x.s(z))
    CASES[f"from_unixtime_zone_{_i}"] = lambda x, z=_z: x.call(
        "from_unixtime", "timestamp with time zone", x.col("k"), x.s(z))
CASES.update({
    "from_unixtime_double": lambda x: x.call("from_unixtime", "timestamp", x.col("secs")),
    "from_unixtime_double_tz": lambda x: x.call(
        "from_unixtime", "timestamp with time zone", x.col("secs"), x.s("-03:30")),
    "from_unixtime_bigint": lambda x: x.call("from_unixtime", "timestamp", x.col("k")),
    "from_unixtime_literal": lambda x: x.call("from_unixtime", "timestamp", x.lit(-0.5, "double")),
    "to_unixtime_ts": lambda x: x.call("to_unixtime", "double", x.col("ts")),
    "to_unixtime_tz": lambda x: x.call("to_unixtime", "double", x.col("tz")),
    "timezone_hour": lambda x: x.call("timezone_hour", "bigint", x.col("tz")),
    "timezone_minute": lambda x: x.call("timezone_minute", "bigint", x.col("tz")),
    "compare_ts": lambda x: x.call("$lt", "boolean", x.col("ts"), x.col("ts2")),
    "compare_tz_instants": lambda x: x.call(
        "$le", "boolean", x.call("$tz_instant", "timestamp", x.col("tz")),
        x.call("$tz_instant", "timestamp", x.col("tz2"))),
    # casts
    "cast_ts_date": lambda x: x.cast(x.col("ts"), "date"),
    "cast_ts_time": lambda x: x.cast(x.col("ts"), "time"),
    "cast_time_ts": lambda x: x.cast(x.col("tm"), "timestamp"),
    "cast_date_ts": lambda x: x.cast(x.col("dt"), "timestamp"),
    "cast_tz_ts": lambda x: x.cast(x.col("tz"), "timestamp"),
    "cast_tz_date": lambda x: x.cast(x.col("tz"), "date"),
    "cast_ts_tz": lambda x: x.cast(x.col("ts"), "timestamp with time zone"),
    "cast_date_tz": lambda x: x.cast(x.col("dt"), "timestamp with time zone"),
    "cast_varchar_ts": lambda x: x.cast(x.col("u"), "timestamp"),
    "cast_varchar_time": lambda x: x.cast(x.col("u"), "time"),
    "cast_varchar_tz": lambda x: x.cast(x.col("u"), "timestamp with time zone"),
    "cast_ts_bigint": lambda x: x.cast(x.col("ts"), "bigint"),
    "cast_ts_literal_varchar": lambda x: x.cast(x.lit(86_400_000_001, "timestamp"), "varchar"),
})

RAISES = {
    "date_trunc_millisecond": (lambda x: x.call(
        "date_trunc", "timestamp", x.s("millisecond"), x.col("ts")), NotImplementedError),
    "date_add_decade": (lambda x: x.call(
        "date_add", "timestamp", x.s("decade"), x.col("n"), x.col("ts")), NotImplementedError),
    "date_diff_decade": (lambda x: x.call(
        "date_diff", "bigint", x.s("decade"), x.col("ts"), x.col("ts2")), NotImplementedError),
    "date_add_hour_on_date": (lambda x: x.call(
        "date_add", "date", x.s("hour"), x.col("n"), x.col("dt")), TypeError),
    "at_timezone_on_time": (lambda x: x.call(
        "at_timezone", "timestamp with time zone", x.col("tm"), x.s("UTC")), TypeError),
    "zone_not_literal": (lambda x: x.call(
        "at_timezone", "timestamp with time zone", x.col("ts"), x.col("u")), NotImplementedError),
    "cast_ts_column_varchar": (lambda x: x.cast(x.col("ts"), "varchar"), NotImplementedError),
    "cast_time_date": (lambda x: x.cast(x.col("tm"), "date"), NotImplementedError),
}


@pytest.mark.parametrize("name", list(CASES))
def test_temporal_function_matches_jax(name):
    H.check(CASES[name])


@pytest.mark.parametrize("name", list(RAISES))
def test_port_raises_where_jax_raises(name):
    make_expr, exc = RAISES[name]
    H.raises(make_expr, exc)


def test_from_unixtime_edge_values():
    """NaN, the infinities, 1e300 and -0.5 s: XLA's conversion of NaN is 0
    and of out-of-range values saturates, truncation is toward zero; the
    port reproduces it without relying on an undefined cast."""
    jc, tc = H.check(CASES["from_unixtime_double"])
    i64 = np.iinfo(np.int64)
    millis = [0, i64.max, i64.min, i64.max, i64.min, -500, -1, 999, i64.max, -1000]
    with np.errstate(over="ignore"):
        expected = np.array(millis, dtype=np.int64) * np.int64(1000)
    np.testing.assert_array_equal(tc.data.numpy()[:10], expected)
    np.testing.assert_array_equal(np.asarray(jc.data)[:10], expected)


@pytest.mark.parametrize("tname", ["decimal(10,4)", "decimal(12,1)", "decimal(30,5)"])
def test_from_unixtime_decimal_against_python(tname):
    """Kept on purpose: a decimal's exact value, whole milliseconds
    truncated toward zero (int(Decimal * 1000))."""
    from decimal import Decimal

    rng = np.random.default_rng(5)
    scale = TT.parse_type(tname).scale
    vals = [Decimal(int(v)).scaleb(-scale) for v in rng.integers(-10**9, 10**9, 40)]
    vals += [Decimal("-0.0005"), Decimal("0.9995"), Decimal("-1.0015"), None]
    vals = [v if v is None else v.quantize(Decimal(1).scaleb(-scale)) for v in vals]
    col = tcolumn_from_values(vals, TT.parse_type(tname), torch.device("cpu"))
    batch = TBatch([col])
    e = tir.Call("from_unixtime", [tir.InputRef(0, col.type)], TT.TIMESTAMP)
    out = TCompiler(batch).column(e).to_pylist()
    epoch = datetime.datetime(1970, 1, 1)
    for v, got in zip(vals, out):
        if v is None:
            assert got is None
        else:
            assert got == epoch + datetime.timedelta(milliseconds=int(v * 1000)), (v, got)


def test_temporal_values_build_and_render():
    """TIME and TIMESTAMP WITH TIME ZONE values through the builders and
    back to Python, against the JAX package's (pre-epoch fractional
    milliseconds floor, zones keep their offsets)."""
    tzs = [datetime.timezone(datetime.timedelta(minutes=m)) for m in OFFSETS]
    stamps = [
        datetime.datetime(1969, 12, 31, 23, 59, 59, 999500, tzinfo=tzs[1]),
        datetime.datetime(1887, 3, 1, 0, 0, 0, 1000, tzinfo=tzs[0]),
        datetime.datetime(2052, 12, 31, 23, 59, 59, tzinfo=tzs[4]),
        None,
        datetime.datetime(2000, 2, 29, 12, tzinfo=tzs[3]),
        datetime.datetime(1970, 1, 1, tzinfo=tzs[2]),
    ]
    times = [datetime.time(0, 0), datetime.time(23, 59, 59, 999999), None, datetime.time(12, 30, 5, 5)]
    for vals, tname in ((stamps, "timestamp with time zone"), (times, "time")):
        jc = jcolumn_from_values(vals, JT.parse_type(tname))
        tc = tcolumn_from_values(vals, TT.parse_type(tname), torch.device("cpu"))
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        jrows, trows = jc.to_pylist(), tc.to_pylist()
        assert trows == jrows
        assert [getattr(v, "utcoffset", lambda: None)() for v in trows] == [
            getattr(v, "utcoffset", lambda: None)() for v in jrows
        ]
    for tname, data in (("interval year to month", [-14, 0, 25]),
                        ("interval day to second", [-90_061_001_000, 0, 3 * DAY + 5])):
        jc = JColumn(np.asarray(data, np.int64), JT.parse_type(tname))
        tc = TColumn(torch.tensor(data, dtype=torch.int64), TT.parse_type(tname))
        assert tc.to_pylist() == jc.to_pylist()


# -- SQL through both runners ----------------------------------------------------


#: the statements of tests/test_timestamptz.py (name -> SQL)
TIMESTAMPTZ = {
    "tz_literal_roundtrip": "select timestamp '2020-03-01 10:30:00 +05:30'",
    "tz_equality_is_by_instant": (
        "select timestamp '2020-01-01 00:00:00 +02:00' = timestamp '2019-12-31 22:00:00 +00:00'"
    ),
    "at_time_zone": "select timestamp '2020-03-01 10:30:00 +05:30' at time zone 'UTC'",
    "tz_casts": (
        "select cast(timestamp '2020-03-01 10:30:00 +05:30' as timestamp), "
        "cast(timestamp '2020-03-01 23:30:00 +05:30' as date), "
        "cast(date '2020-03-01' as timestamp with time zone)"
    ),
    "hour_minute_second": (
        "select hour(t), minute(t), second(t), extract(hour from t), extract(minute from t) "
        "from (select timestamp '2020-03-01 10:30:45' t)"
    ),
    "tz_hour_respects_zone": "select hour(timestamp '2020-03-01 22:30:00 +05:30')",
    "timezone_hour_minute": (
        "select extract(timezone_hour from timestamp '2020-01-01 00:00:00 -08:30'), "
        "extract(timezone_minute from timestamp '2020-01-01 00:00:00 -08:30')"
    ),
    "unixtime_round_trip": (
        "select to_unixtime(timestamp '1970-01-01 01:00:00 +00:00'), from_unixtime(3600, '+01:00')"
    ),
    "current_timestamp_is_tz": "select current_timestamp",
    "named_zone_literal": "select timestamp '2020-06-01 12:00:00 America/New_York'",
    "tz_order_by": (
        "select t from (values timestamp '2020-01-01 12:00:00 +05:00', "
        "timestamp '2020-01-01 10:00:00 +00:00', "
        "timestamp '2020-01-01 05:00:00 -03:00') as v(t) order by t"
    ),
    "tz_cast_to_timestamp_keeps_wall_clock": (
        "select cast(timestamp '2020-03-01 10:30:00 +05:30' as timestamp), "
        "cast(timestamp '2020-03-01 01:30:00 +05:30' as date), "
        "cast(cast(timestamp '2020-03-01 01:30:00 +05:30' as timestamp) as date)"
    ),
    # the JAX test's memory table, as a VALUES relation
    "tz_cast_wall_clock_non_constant": (
        "select cast(x as timestamp) from (values timestamp '2020-03-01 10:30:00 +05:30', "
        "timestamp '1969-12-31 23:59:59.999 -03:30') t(x)"
    ),
}

#: the statements of tests/test_date_functions.py
DATE_FUNCTIONS = {
    "date_trunc_units": (
        "select date_trunc('month', date '2020-07-15'), date_trunc('week', date '2020-07-15'), "
        "date_trunc('quarter', date '2020-08-09'), date_trunc('year', date '2020-07-15')"
    ),
    "date_trunc_timestamp_preserves_type": (
        "select date_trunc('hour', timestamp '2020-07-15 10:30:45'), "
        "date_trunc('day', timestamp '2020-07-15 10:30:45')"
    ),
    "date_add": (
        "select date_add('day', 20, date '2020-02-10'), date_add('month', 1, date '2020-01-31'), "
        "date_add('hour', 5, timestamp '2020-01-01 22:00:00'), "
        "date_add('week', -1, date '2020-01-08')"
    ),
    "date_diff_complete_periods": (
        "select date_diff('day', date '2020-01-01', date '2020-03-01'), "
        "date_diff('month', date '2020-01-15', date '2020-03-01'), "
        "date_diff('year', date '2018-06-01', date '2021-01-01'), "
        "date_diff('month', date '2020-03-15', date '2020-01-20'), "
        "date_diff('hour', timestamp '2020-01-01 00:00:00', timestamp '2020-01-02 06:00:00')"
    ),
    "date_functions_over_table": (
        "select count(distinct date_trunc('month', o_orderdate)) from orders"
    ),
    "time_type": (
        "select time '10:30:05.5', hour(time '10:30:05'), minute(time '10:30:05'), "
        "cast('23:59:59' as time), cast(timestamp '2020-03-01 10:30:00' as time), "
        "time '10:00:00' < time '11:00:00'"
    ),
    "interval_year_month_type": (
        "select interval '3' month, interval '2' year, date '2020-01-31' + interval '1' month, "
        "timestamp '2020-01-31 10:00:00' + interval '1' month, "
        "date '2020-03-31' - interval '1' month"
    ),
    "interval_values_in_expressions": (
        "select d + interval '1' year, interval '1' year + interval '2' month "
        "from (values date '2019-02-28') t(d)"
    ),
}


class Runners:
    """The JAX package's LocalQueryRunner (each result computed once), the
    port's LocalQueryRunner and the port's 4-worker mesh, at tpch.tiny."""

    def __init__(self):
        self.jax = JaxRunner(catalog="tpch", schema="tiny")
        self.local = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
        self.mesh = DistributedQueryRunner(catalog="tpch", schema="tiny", n_workers=4, device="cpu")
        self._expected = {}

    def expected(self, sql: str):
        if sql not in self._expected:
            self._expected[sql] = self.jax.execute(sql)
        return self._expected[sql]

    def check(self, sql: str, where: str = "local"):
        """The port's `where` run of `sql` held to the JAX local rows."""
        expected = self.expected(sql)
        actual = (self.local if where == "local" else self.mesh).execute(sql)
        assert actual.column_names == expected.column_names
        assert [t.name for t in actual.types] == [t.name for t in expected.types]
        assert expected.rows
        assert_rows_match(actual.rows, expected.rows, result_order(self.local.create_plan(sql)),
                          float_rtol=1e-9)
        return actual


@pytest.fixture(scope="module")
def runners():
    return Runners()


@pytest.mark.parametrize("name", list(TIMESTAMPTZ))
def test_timestamptz_statements(runners, name):
    sql = TIMESTAMPTZ[name]
    if name == "current_timestamp_is_tz":
        # the test's own check, in each package (the clock moves between them)
        for r in (runners.jax, runners.local):
            v = r.execute(sql).rows[0][0]
            assert v.tzinfo is not None
            assert abs((datetime.datetime.now(datetime.timezone.utc) - v).total_seconds()) < 3600
        return
    runners.check(sql)


@pytest.mark.parametrize("name", list(DATE_FUNCTIONS))
def test_date_function_statements(runners, name):
    runners.check(DATE_FUNCTIONS[name])


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", ["T1", "T2", "T3"])
def test_chip_smoke_temporal_statements(runners, name, where):
    """chip_smoke.py's phase-5j statements T1-T3 at tiny, held to the JAX
    package's local rows."""
    runners.check(chip_smoke.TEMPORAL_QUERIES[name], where)


def test_chip_smoke_t1_takes_the_grouped_sums_path(runners):
    """T1 with `pallas_agg` on reaches the grouped-sums kernel (its plain
    version on the CPU), as its local run on the card must; f32 sums, so
    doubles to relative 5e-5 (tests/test_torch_e2e.py gives the bound)."""
    sql = chip_smoke.TEMPORAL_QUERIES["T1"]
    r = LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu")
    r.execute("set session pallas_agg = true")
    before = gs.grouped_sums_reference.launches
    actual = r.execute(sql)
    assert gs.grouped_sums_reference.launches > before
    assert_rows_match(actual.rows, runners.expected(sql).rows,
                      result_order(r.create_plan(sql)), float_rtol=5e-5)

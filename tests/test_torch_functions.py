"""The port's scalar-function layer against the JAX package's.

Each case builds the same expression in both packages' IR and compiles it
with each package's ExprCompiler over the same batch: 64 rows made from a
numpy seed, with NULLs in every column, NULL rows of the dictionary columns
carrying codes outside their dictionary (the JAX package gathers with
``take(mode="clip")``; the port clamps before every gather), and dead rows.
The families: decimal and integer division and modulus (the double branch
and the int128 limb branch of long-decimal division, rounding half away
from zero, zero divisors, INT64_MIN), the numeric functions, the civil-date
functions (dates from 1887 to 2052, month ends, leap days), the dictionary
string functions (LIKE by prefix, by regex and with an escape, the regexp
family, substr at start 0, a negative start and non-positive lengths, the
case/trim/replace maps, concat of one and two columns and of a NULL
literal) and the casts (varchar that does not parse becomes NULL, varchar
to long decimals, double to long decimals, literals to varchar).  Then the
same families as SQL through both LocalQueryRunners, over VALUES rows made
from a numpy seed and over tpch.tiny columns.  Where the JAX package
raises, the port raises NotImplementedError too, the timestamp family's
unsupported units and its column-to-varchar cast by name (the timestamp
family itself is held to the JAX package in test_torch_temporal.py).

Tolerances: integers, decimals (both limbs), dates, booleans and strings
exact, with the same validity; doubles relative 1e-9 (transcendental
functions and f64 division may differ in the last bit).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar import StringDictionary as JDict
from trino_tpu.expr import ExprCompiler as JCompiler
from trino_tpu.expr import ir as jir
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn
from trino_tpu_torch.columnar import StringDictionary as TDict
from trino_tpu_torch.expr import ExprCompiler as TCompiler
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows

N = 64
INT64_MIN = np.iinfo(np.int64).min

WORDS = [
    "", "a", "abc", "abc%def", "_x_", "PROMO BRUSHED", "PROMO", "promo x",
    "  padded  ", "a$1b", "12", "-3.50", "x1", "1e3", " 42 ", "1969-12-31",
    "2000-02-29", "2001-02-29", "true", "T", "no", "99999999999999999999.99",
    "123456789012345678.5", "green apple", "dark green", "b-a-b", "aaa",
]
SMALL = ["p", "qq", "", "r-r"]


def _long_value(rng):
    """A scaled decimal(30, 4) value: small, past 2**63, negative."""
    kind = rng.integers(0, 3)
    if kind == 0:
        return int(rng.integers(-10**8, 10**8))
    mag = int(rng.integers(1, 10**9)) * 10**17 + int(rng.integers(0, 10**9))
    return -mag if kind == 2 else mag


def _make_columns(seed: int = 17):
    """([(name, type name, data, valid, dictionary words or None)], live
    mask)."""
    rng = np.random.default_rng(seed)
    nulls = lambda: rng.random(N) >= 0.15  # noqa: E731
    i = rng.integers(-1000, 1000, N).astype(np.int64)
    i[:4] = [INT64_MIN, 7, -7, 0]
    j = rng.integers(-7, 8, N).astype(np.int64)
    j[:4] = [3, 2, -2, 5]  # INT64_MIN meets 3: no INT64_MIN / -1
    d = rng.integers(-10**6, 10**6, N).astype(np.int64)
    d[4:10] = [250, -250, 150, -150, 5, -5]  # halves at scales 2 -> 0 and 1
    e = rng.integers(-2000, 2000, N).astype(np.int64)
    e[4:8] = [0, 1000, -1000, 3000]
    longs = [_long_value(rng) for _ in range(N)]
    ld = np.array(
        [[(v >> 64), (v & (2**64 - 1)) - (2**64 if v & (1 << 63) else 0)] for v in longs],
        dtype=np.int64,
    )
    f = np.round(rng.normal(0, 100, N), 3)
    f[:8] = [2.5, -2.5, 0.5, -0.5, 1.005, 0.0, 1e6 + 0.5, -7.25]
    dt = rng.integers(-30000, 30000, N).astype(np.int32)
    dt[:6] = [-1, 0, 11016, 11017, 11046, -25567]  # 1969-12-31, 2000-02-29, ..
    dt2 = rng.integers(-3000, 3000, N).astype(np.int32) + dt
    s_codes = rng.integers(0, len(WORDS), N).astype(np.int32)
    t_codes = rng.integers(0, len(SMALL), N).astype(np.int32)
    b = rng.random(N) < 0.5
    cols = [
        ("i", "bigint", i, nulls(), None),
        ("j", "bigint", j, nulls(), None),
        ("d", "decimal(12,2)", d, nulls(), None),
        ("e", "decimal(6,3)", e, nulls(), None),
        ("ld", "decimal(30,4)", ld, nulls(), None),
        ("f", "double", f, nulls(), None),
        ("dt", "date", dt, nulls(), None),
        ("dt2", "date", dt2, nulls(), None),
        ("s", "varchar", s_codes, nulls(), WORDS),
        ("t", "varchar", t_codes, nulls(), SMALL),
        ("b", "boolean", b, nulls(), None),
    ]
    out = []
    for name, tname, data, valid, words in cols:
        if words is not None:
            # codes in the sorted dictionary; NULL rows carry codes outside it
            order = {w: k for k, w in enumerate(sorted(set(words)))}
            data = np.array([order[words[c]] for c in data], dtype=np.int32)
            bad = np.flatnonzero(~valid)
            data[bad] = np.where(np.arange(bad.size) % 2 == 0, 999, -5)
        out.append((name, tname, data, valid, words))
    mask = rng.random(N) < 0.9
    return out, mask


COLUMNS, MASK = _make_columns()
CH = {name: k for k, (name, *_rest) in enumerate(COLUMNS)}


def _batches():
    jcols, tcols = [], []
    for name, tname, data, valid, words in COLUMNS:
        jt, tt = JT.parse_type(tname), TT.parse_type(tname)
        jd = JDict(sorted(set(words))) if words is not None else None
        td = TDict(sorted(set(words))) if words is not None else None
        jcols.append(JColumn(jnp.asarray(data), jt, jnp.asarray(valid), jd))
        tcols.append(TColumn(torch.from_numpy(np.ascontiguousarray(data)), tt,
                             torch.from_numpy(valid), td))
    return JBatch(jcols, jnp.asarray(MASK)), TBatch(tcols, torch.from_numpy(MASK))


JB, TB = _batches()


class _Both:
    """Builds one expression in both packages' IR: ``x.col("s")`` is an
    input column, ``x.lit(v, "type")`` a literal, ``x.call(name, type,
    *args)`` a function call, ``x.cast(e, "type")`` a CAST."""

    def __init__(self, ir, types):
        self.ir, self.T = ir, types

    def typ(self, t):
        return self.T.parse_type(t) if isinstance(t, str) else t

    def col(self, name):
        return self.ir.InputRef(CH[name], self.T.parse_type(COLUMNS[CH[name]][1]))

    def lit(self, v, t):
        return self.ir.Literal(v, self.typ(t))

    def call(self, name, t, *args):
        return self.ir.Call(name, list(args), self.typ(t))

    def cast(self, e, t):
        return self.ir.SpecialForm(self.ir.Form.CAST, [e], self.typ(t))


#: name -> builder(x) of one expression
CASES = {
    # -- division and modulus ------------------------------------------------
    "div_bigint": lambda x: x.call("$div", "bigint", x.col("i"), x.col("j")),
    "div_short_decimal": lambda x: x.call("$div", "decimal(18,4)", x.col("d"), x.col("e")),
    "div_double": lambda x: x.call("$div", "double", x.col("f"), x.col("d")),
    "div_long_by_short": lambda x: x.call("$div", "decimal(38,6)", x.col("ld"), x.col("e")),
    "div_long_by_bigint": lambda x: x.call("$div", "decimal(38,4)", x.col("ld"), x.col("j")),
    "div_long_short_result": lambda x: x.call("$div", "decimal(18,1)", x.col("ld"), x.col("e")),
    "div_short_long_result": lambda x: x.call("$div", "decimal(38,3)", x.cast(x.col("d"), "decimal(30,2)"), x.lit(3, "bigint")),
    "div_long_double_result": lambda x: x.call("$div", "double", x.col("ld"), x.col("e")),
    "div_long_by_double": lambda x: x.call("$div", "double", x.col("ld"), x.col("f")),
    "mod_bigint": lambda x: x.call("$mod", "bigint", x.col("i"), x.col("j")),
    "mod_short_decimal": lambda x: x.call("$mod", "decimal(12,3)", x.col("d"), x.col("e")),
    "mod_double": lambda x: x.call("$mod", "double", x.col("f"), x.lit(7.5, "double")),
    "mod_long": lambda x: x.call("$mod", "decimal(30,4)", x.col("ld"), x.col("e")),
    "mod_long_short_result": lambda x: x.call("$mod", "decimal(10,4)", x.col("ld"), x.col("e")),
    "mod_function": lambda x: x.call("mod", "bigint", x.col("i"), x.lit(-7, "bigint")),
    # -- numeric functions ----------------------------------------------------
    "abs_bigint": lambda x: x.call("abs", "bigint", x.col("i")),
    "abs_decimal": lambda x: x.call("abs", "decimal(12,2)", x.col("d")),
    "abs_long": lambda x: x.call("abs", "decimal(30,4)", x.col("ld")),
    "abs_double": lambda x: x.call("abs", "double", x.col("f")),
    "sign": lambda x: x.call("sign", "bigint", x.col("j")),
    "power": lambda x: x.call("power", "double", x.col("f"), x.lit(2, "bigint")),
    "pow_fraction": lambda x: x.call("pow", "double", x.call("abs", "double", x.col("f")), x.lit(0.5, "double")),
    "sqrt": lambda x: x.call("sqrt", "double", x.call("abs", "double", x.col("f"))),
    "cbrt": lambda x: x.call("cbrt", "double", x.col("f")),
    "exp_ln": lambda x: x.call("ln", "double", x.call("exp", "double", x.call("$div", "double", x.col("f"), x.lit(100.0, "double")))),
    "log10": lambda x: x.call("log10", "double", x.call("abs", "double", x.col("d"))),
    "floor_decimal": lambda x: x.call("floor", "decimal(11,0)", x.col("d")),
    "ceil_decimal": lambda x: x.call("ceil", "decimal(11,0)", x.col("d")),
    "floor_long": lambda x: x.call("floor", "decimal(27,0)", x.col("ld")),
    "ceiling_long": lambda x: x.call("ceiling", "decimal(27,0)", x.col("ld")),
    "floor_double": lambda x: x.call("floor", "double", x.col("f")),
    "ceil_double": lambda x: x.call("ceil", "double", x.col("f")),
    "floor_bigint": lambda x: x.call("floor", "bigint", x.col("i")),
    "round_decimal": lambda x: x.call("round", "decimal(11,0)", x.col("d")),
    "round_decimal_digits": lambda x: x.call("round", "decimal(12,2)", x.col("d"), x.lit(1, "integer")),
    "round_long_digits": lambda x: x.call("round", "decimal(30,4)", x.col("ld"), x.lit(2, "integer")),
    "round_long": lambda x: x.call("round", "decimal(27,0)", x.col("ld")),
    "round_double": lambda x: x.call("round", "double", x.col("f")),
    "round_double_digits": lambda x: x.call("round", "double", x.col("f"), x.lit(2, "integer")),
    "round_double_to_bigint": lambda x: x.call("round", "bigint", x.col("f")),
    "greatest_bigint": lambda x: x.call("greatest", "bigint", x.col("i"), x.col("j"), x.lit(5, "bigint")),
    "least_decimal": lambda x: x.call("least", "decimal(12,2)", x.col("d"), x.lit(0, "decimal(12,2)")),
    "greatest_long": lambda x: x.call("greatest", "decimal(30,4)", x.col("ld"), x.cast(x.col("d"), "decimal(30,4)")),
    "least_varchar": lambda x: x.call("least", "varchar", x.col("s"), x.col("t")),
    "greatest_varchar_literal": lambda x: x.call("greatest", "varchar", x.col("s"), x.lit("m", "varchar")),
    # -- dates -----------------------------------------------------------------
    "year": lambda x: x.call("year", "bigint", x.col("dt")),
    "month": lambda x: x.call("month", "bigint", x.col("dt")),
    "day": lambda x: x.call("day", "bigint", x.col("dt")),
    "day_of_month": lambda x: x.call("day_of_month", "bigint", x.col("dt")),
    "quarter": lambda x: x.call("quarter", "bigint", x.col("dt")),
    "day_of_week": lambda x: x.call("day_of_week", "bigint", x.col("dt")),
    "dow": lambda x: x.call("dow", "bigint", x.col("dt")),
    "day_of_year": lambda x: x.call("day_of_year", "bigint", x.col("dt")),
    "doy": lambda x: x.call("doy", "bigint", x.col("dt")),
    "date_add_days": lambda x: x.call("date_add_days", "date", x.col("dt"), x.col("j")),
    "date_add_months": lambda x: x.call("date_add_months", "date", x.col("dt"), x.col("j")),
    "date_trunc_month": lambda x: x.call("date_trunc_month", "date", x.col("dt")),
    "date_trunc_year": lambda x: x.call("date_trunc_year", "date", x.col("dt")),
    "date_trunc_week": lambda x: x.call("date_trunc", "date", x.lit("week", "varchar"), x.col("dt")),
    "date_trunc_quarter": lambda x: x.call("date_trunc", "date", x.lit("quarter", "varchar"), x.col("dt")),
    "date_add_quarter": lambda x: x.call("date_add", "date", x.lit("quarter", "varchar"), x.col("j"), x.col("dt")),
    "date_add_week": lambda x: x.call("date_add", "date", x.lit("week", "varchar"), x.col("j"), x.col("dt")),
    "date_diff_day": lambda x: x.call("date_diff", "bigint", x.lit("day", "varchar"), x.col("dt"), x.col("dt2")),
    "date_diff_month": lambda x: x.call("date_diff", "bigint", x.lit("month", "varchar"), x.col("dt"), x.col("dt2")),
    "date_diff_year": lambda x: x.call("date_diff", "bigint", x.lit("year", "varchar"), x.col("dt2"), x.col("dt")),
    "date_diff_hour": lambda x: x.call("date_diff", "bigint", x.lit("hour", "varchar"), x.col("dt"), x.col("dt2")),
    # -- strings ---------------------------------------------------------------
    "like_prefix": lambda x: x.call("like", "boolean", x.col("s"), x.lit("PROMO%", "varchar")),
    "like_regex": lambda x: x.call("like", "boolean", x.col("s"), x.lit("%a_c%", "varchar")),
    "like_infix": lambda x: x.call("like", "boolean", x.col("s"), x.lit("%green%", "varchar")),
    "like_escape": lambda x: x.call("like", "boolean", x.col("s"), x.lit("abc\\%%", "varchar"), x.lit("\\", "varchar")),
    "like_escape_underscore": lambda x: x.call("like", "boolean", x.col("s"), x.lit("#_x#_", "varchar"), x.lit("#", "varchar")),
    "regexp_like": lambda x: x.call("regexp_like", "boolean", x.col("s"), x.lit("[0-9]+", "varchar")),
    "regexp_extract": lambda x: x.call("regexp_extract", "varchar", x.col("s"), x.lit("[0-9]+", "varchar")),
    "regexp_extract_group": lambda x: x.call("regexp_extract", "varchar", x.col("s"), x.lit("(a)(b)?", "varchar"), x.lit(2, "bigint")),
    "regexp_replace": lambda x: x.call("regexp_replace", "varchar", x.col("s"), x.lit("(a)", "varchar"), x.lit("<$1$1>", "varchar")),
    "regexp_replace_delete": lambda x: x.call("regexp_replace", "varchar", x.col("s"), x.lit("[ae]", "varchar")),
    "substr_from": lambda x: x.call("substr", "varchar", x.col("s"), x.lit(2, "bigint")),
    "substr_start_zero": lambda x: x.call("substr", "varchar", x.col("s"), x.lit(0, "bigint"), x.lit(3, "bigint")),
    "substr_negative_start": lambda x: x.call("substr", "varchar", x.col("s"), x.lit(-3, "bigint")),
    "substr_before_start": lambda x: x.call("substring", "varchar", x.col("s"), x.lit(-30, "bigint"), x.lit(2, "bigint")),
    "substr_zero_length": lambda x: x.call("substr", "varchar", x.col("s"), x.lit(2, "bigint"), x.lit(0, "bigint")),
    "substr_negative_length": lambda x: x.call("substr", "varchar", x.col("s"), x.lit(1, "bigint"), x.lit(-1, "bigint")),
    "substr_long_length": lambda x: x.call("substring", "varchar", x.col("s"), x.lit(1, "bigint"), x.lit(100, "bigint")),
    "upper": lambda x: x.call("upper", "varchar", x.col("s")),
    "lower": lambda x: x.call("lower", "varchar", x.col("s")),
    "trim": lambda x: x.call("trim", "varchar", x.col("s")),
    "ltrim_chars": lambda x: x.call("ltrim", "varchar", x.col("s"), x.lit(" a", "varchar")),
    "rtrim": lambda x: x.call("rtrim", "varchar", x.col("s")),
    "reverse": lambda x: x.call("reverse", "varchar", x.col("s")),
    "replace": lambda x: x.call("replace", "varchar", x.col("s"), x.lit("a", "varchar"), x.lit("xy", "varchar")),
    "replace_delete": lambda x: x.call("replace", "varchar", x.col("s"), x.lit("b", "varchar")),
    "length": lambda x: x.call("length", "bigint", x.col("s")),
    "strpos": lambda x: x.call("strpos", "bigint", x.col("s"), x.lit("b", "varchar")),
    "position": lambda x: x.call("position", "bigint", x.col("s"), x.lit("green", "varchar")),
    "starts_with": lambda x: x.call("starts_with", "boolean", x.col("s"), x.lit("a", "varchar")),
    "concat_one_column": lambda x: x.call("concat", "varchar", x.lit("<", "varchar"), x.col("s"), x.lit(">", "varchar")),
    "concat_two_columns": lambda x: x.call("$concat", "varchar", x.lit("[", "varchar"), x.col("s"), x.lit("|", "varchar"), x.col("t"), x.lit("]", "varchar")),
    "concat_null_literal": lambda x: x.call("concat", "varchar", x.col("s"), x.lit(None, "varchar")),
    "concat_literals": lambda x: x.call("concat", "varchar", x.lit("ab", "varchar"), x.lit("cd", "varchar")),
    # -- casts -----------------------------------------------------------------
    "cast_varchar_bigint": lambda x: x.cast(x.col("s"), "bigint"),
    "cast_varchar_integer": lambda x: x.cast(x.col("s"), "integer"),
    "cast_varchar_double": lambda x: x.cast(x.col("s"), "double"),
    "cast_varchar_decimal": lambda x: x.cast(x.col("s"), "decimal(10,2)"),
    "cast_varchar_long_decimal": lambda x: x.cast(x.col("s"), "decimal(30,4)"),
    "cast_varchar_date": lambda x: x.cast(x.col("s"), "date"),
    "cast_varchar_boolean": lambda x: x.cast(x.col("s"), "boolean"),
    "cast_double_long_decimal": lambda x: x.cast(x.col("f"), "decimal(30,4)"),
    "cast_double_short_decimal": lambda x: x.cast(x.col("f"), "decimal(8,1)"),
    "cast_long_decimal_double": lambda x: x.cast(x.col("ld"), "double"),
    "cast_long_decimal_bigint": lambda x: x.cast(x.col("ld"), "bigint"),
    "cast_long_decimal_short": lambda x: x.cast(x.col("ld"), "decimal(18,2)"),
    "cast_boolean_bigint": lambda x: x.cast(x.col("b"), "bigint"),
    "cast_bigint_boolean": lambda x: x.cast(x.col("j"), "boolean"),
    "cast_decimal_boolean": lambda x: x.cast(x.col("d"), "boolean"),
    "cast_bigint_literal_varchar": lambda x: x.cast(x.lit(-12, "bigint"), "varchar"),
    "cast_decimal_literal_varchar": lambda x: x.cast(x.lit("-1.05", "decimal(5,2)"), "varchar"),
    "cast_double_literal_varchar": lambda x: x.cast(x.lit(2.5, "double"), "varchar"),
    "cast_boolean_literal_varchar": lambda x: x.cast(x.lit(True, "boolean"), "varchar"),
    "cast_null_literal_varchar": lambda x: x.cast(x.lit(None, "bigint"), "varchar"),
}

#: name -> builder of an expression both packages refuse
RAISES = {
    "division_by_long_decimal": lambda x: x.call("$div", "decimal(38,4)", x.col("d"), x.col("ld")),
    "mod_by_long_decimal": lambda x: x.call("$mod", "decimal(30,4)", x.col("ld"), x.col("ld")),
    "mod_wide_divisor": lambda x: x.call("$mod", "decimal(30,4)", x.col("ld"), x.col("i")),
    "cast_column_to_varchar": lambda x: x.cast(x.col("i"), "varchar"),
    "cast_long_decimal_boolean": lambda x: x.cast(x.col("ld"), "boolean"),
    "like_column_pattern": lambda x: x.call("like", "boolean", x.col("s"), x.col("t")),
}


def _compile(name, builders):
    je = builders[name](_Both(jir, JT))
    te = builders[name](_Both(tir, TT))
    return je, te


def _valid(col, n):
    return np.ones(n, bool) if col.valid is None else np.asarray(col.valid)


def _values(col, valid):
    data = np.asarray(col.data)
    if col.dictionary is not None:
        codes = data.astype(np.int64)
        return [col.dictionary.values[c] if v else None for c, v in zip(codes, valid)]
    return [tuple(r) if data.ndim == 2 else r for r in data.tolist()]


@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax(name):
    je, te = _compile(name, CASES)
    jc = JCompiler(JB).column(je)
    tc = TCompiler(TB).column(te)
    assert tc.type.name == jc.type.name
    live = MASK
    jv, tv = _valid(jc, N), _valid(tc, N)
    np.testing.assert_array_equal(tv[live], jv[live])
    assert np.asarray(tc.data).shape == np.asarray(jc.data).shape
    assert str(tc.data.numpy().dtype) == str(np.asarray(jc.data).dtype)
    jvals, tvals = _values(jc, jv), _values(tc, tv)
    for k in np.flatnonzero(live & jv):
        a, e = tvals[k], jvals[k]
        if isinstance(e, float):
            assert math.isclose(a, e, rel_tol=1e-9, abs_tol=0.0) or (
                math.isnan(a) and math.isnan(e)
            ), (k, a, e)
        else:
            assert a == e, (k, a, e)


@pytest.mark.parametrize("name", list(RAISES))
def test_port_raises_where_jax_raises(name):
    je, te = _compile(name, RAISES)
    with pytest.raises(NotImplementedError):
        JCompiler(JB).column(je)
    with pytest.raises(NotImplementedError):
        TCompiler(TB).column(te)


def test_timestamp_family_raises_by_name():
    """What the JAX package refuses in the timestamp family, the port
    refuses by name: a date_trunc, date_add or date_diff unit it does not
    know, and a timestamp column cast to varchar."""
    ts = tir.Literal(0, TT.TIMESTAMP)
    for fn, args in (
        ("date_trunc", [tir.Literal("millisecond", TT.VARCHAR), ts]),
        ("date_add", [tir.Literal("decade", TT.VARCHAR), tir.Literal(1, TT.BIGINT), ts]),
        ("date_diff", [tir.Literal("century", TT.VARCHAR), ts, ts]),
    ):
        with pytest.raises(NotImplementedError, match=f"{fn} unit"):
            TCompiler(TB).column(tir.Call(fn, args, TT.TIMESTAMP))
    dates = tir.InputRef(CH["dt"], TT.DATE)
    with pytest.raises(NotImplementedError, match="timestamp -> varchar on columns"):
        TCompiler(TB).column(
            tir.SpecialForm(tir.Form.CAST, [tir.SpecialForm(tir.Form.CAST, [dates], TT.TIMESTAMP)],
                            TT.VARCHAR)
        )


# -- SQL through both runners --------------------------------------------------


def _values_table(seed: int = 23, n: int = 40) -> str:
    """A VALUES source made from a numpy seed: bigint, decimal(12,2),
    date and varchar columns with NULLs."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(n):
        i = "null" if rng.random() < 0.1 else str(int(rng.integers(-500, 500)))
        j = "null" if rng.random() < 0.1 else str(int(rng.integers(-4, 5)))
        dv = int(rng.integers(-10**6, 10**6))
        d = "null" if rng.random() < 0.1 else f"decimal '{dv / 100:.2f}'"
        days = int(rng.integers(-20000, 20000))
        dt = "null" if rng.random() < 0.1 else f"date '{np.datetime64(days, 'D')}'"
        w = WORDS[int(rng.integers(0, len(WORDS)))].replace("'", "''")
        s = "null" if rng.random() < 0.1 else f"'{w}'"
        rows.append(f"({i}, {j}, {d}, {dt}, {s})")
    return f"(values {', '.join(rows)}) t(i, j, d, dt, s)"


VALUES = _values_table()

SQL_CASES = {
    "arithmetic": f"select i / j, i % j, d / j, d % 7, round(d), round(d, 1), floor(d), "
                  f"ceil(d), abs(d), greatest(i, j), least(d, decimal '1.00') from {VALUES}",
    "dates": f"select year(dt), month(dt), day(dt), quarter(dt), day_of_week(dt), "
             f"day_of_year(dt), extract(year from dt), dt + interval '1' month, "
             f"date_trunc('month', dt), date_trunc('year', dt), date_add('day', j, dt), "
             f"date_diff('month', dt, date '2000-01-31') from {VALUES}",
    "strings": f"select s like 'a%', s not like '%b%', s like '%\\%%' escape '\\', "
               f"regexp_like(s, '^[0-9]'), substr(s, 2, 3), substr(s, -2), upper(s), "
               f"trim(s), length(s), strpos(s, 'a'), s || '!', concat(s, '-', s), "
               f"replace(s, 'a', 'A'), reverse(s), starts_with(s, 'P') from {VALUES}",
    "casts": f"select cast(s as bigint), cast(s as double), cast(s as decimal(10,2)), "
             f"cast(s as decimal(30,2)), cast(s as date), cast(d as double), "
             f"cast(d as decimal(30,4)), cast(i as decimal(5,1)) from {VALUES}",
    "tpch_strings": "select p_partkey, p_name like '%green%', p_type like 'PROMO%', "
                    "substr(p_type, 1, 5), upper(p_brand), length(p_name), "
                    "p_container || '/' || p_mfgr, regexp_extract(p_brand, '[0-9]+'), "
                    "cast(substring(p_brand, 7) as integer) "
                    "from part where p_partkey < 60",
    "tpch_dates_numbers": "select o_orderkey, year(o_orderdate), month(o_orderdate), "
                          "o_orderdate + interval '3' month, round(o_totalprice, -2), "
                          "floor(o_totalprice / 7), o_totalprice % 1000, "
                          "sqrt(o_totalprice), power(o_shippriority + 2, 3), "
                          "substr(o_clerk, -3) from orders where o_orderkey < 200",
    "tpch_group_by_functions": "select year(l_shipdate), substr(l_shipmode, 1, 2), "
                               "count(*), sum(l_quantity) from lineitem "
                               "where l_shipinstruct like '%RETURN%' group by 1, 2",
}


@pytest.fixture(scope="module")
def runners():
    return (
        JaxRunner(catalog="tpch", schema="tiny"),
        LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    )


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_sql_functions_match_jax(runners, name):
    jax_runner, port_runner = runners
    expected = jax_runner.execute(SQL_CASES[name])
    actual = port_runner.execute(SQL_CASES[name])
    assert [t.name for t in actual.types] == [t.name for t in expected.types]
    assert len(expected.rows) > 0
    assert_same_rows(actual.rows, expected.rows, ordered=False, float_rtol=1e-9)


SQL_RAISES = {
    "mod_by_long_decimal": "select o_custkey % cast(o_totalprice as decimal(30,2)) from orders",
    "cast_column_to_varchar": "select cast(o_custkey as varchar) from orders",
}


@pytest.mark.parametrize("name", list(SQL_RAISES))
def test_sql_port_raises_where_jax_raises(runners, name):
    jax_runner, port_runner = runners
    with pytest.raises(NotImplementedError):
        jax_runner.execute(SQL_RAISES[name])
    with pytest.raises(NotImplementedError):
        port_runner.execute(SQL_RAISES[name])

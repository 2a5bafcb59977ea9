"""The port's string, url, math and bitwise breadth, concat_ws and format
against the JAX package's.

IR level, over one batch of 64 rows made from a numpy seed (the harness of
test_torch_temporal.py): split_part (indexes 0, 1, 2 and past the end, an
empty delimiter), lpad/rpad (shorter and longer than the value, a
multi-character and an empty pad), translate (deletions, a repeated
source character), codepoint, chr of a literal, normalize (NFC, NFD, NFKC,
NFKD over accented and compatibility characters), levenshtein_distance (an
empty value and an empty target), url_encode/url_decode and the six
url_extract functions; asin/acos (inside and outside [-1, 1]), atan,
sinh/cosh/tanh (overflow to infinity), atan2 (signed zeros), log(b, x)
(b = 1, x <= 0), truncate (toward zero, NaN, infinities), e, pi, nan,
infinity, is_nan/is_finite/is_infinite, width_bucket (the value at each
bound, lo > hi, NaN, a bucket count of 0 and below, equal bounds);
bitwise_and/or/xor/not, the shifts by 0, 1, 63, 64, 100 and -1 of negative
and positive values, bit_count with 64, 63, 8 and no bit width; typeof and
version; concat_ws over three and more values with NULLs, a NULL separator
and non-string values; format.  hamming_distance raises
NotImplementedError in both packages.

SQL, through both LocalQueryRunners: the format cases of
tests/test_sql_surface.py, the typeof/version/concat_ws cases of
tests/test_lambdas.py, and chip_smoke.py's phase-5j statements T4-T6 at
tpch.tiny through the port's LocalQueryRunner and 4-worker mesh, held to
the JAX package's local rows (the JAX mesh raises for concat_ws and
format: its shard_map traces the projection; the port's mesh renders per
worker and merges the workers' dictionaries).

Tolerances: integers, booleans and strings exact, with the same validity;
doubles relative 1e-9 (the transcendental functions may differ in the last
bit between XLA and torch).
"""

import numpy as np
import pytest

from trino_tpu_torch.expr import functions as tfn

import chip_smoke
from test_torch_temporal import Harness, Runners

N = 64

WORDS = [
    "", "a", "a b c", "one two three four", "  x  ", "café", "café", "ﬁ ½",
    "AEIOU aeiou", "http://user@Example.com:8080/a/b?q=1&r=x y#frag",
    "https://trino.io/docs", "ftp://[::1]:21/", "not a url", "a+b%20c%2Bd",
    "Customer#000000001", "25-989-741-2988", "25-989-741-2989", "x" * 30, "ab|cd|",
]
URLS = [w for w in WORDS if "://" in w] + ["http://h:99999/", "mailto:x@y.z", "//host/p"]


def _breadth_columns(seed: int = 31):
    rng = np.random.default_rng(seed)
    nulls = lambda: rng.random(N) >= 0.15  # noqa: E731
    f = np.round(rng.normal(0, 3, N), 4)
    f[:12] = [1.0, -1.0, 0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5, 800.0, -800.0, 1e-300]
    g = np.round(rng.normal(0, 3, N), 4)
    g[:6] = [0.0, -0.0, 0.0, -0.0, 1.0, np.nan]
    d = rng.integers(-10**6, 10**6, N).astype(np.int64)
    d[:4] = [0, 100, -100, 250]
    i = rng.integers(-2**62, 2**62, N).astype(np.int64)
    i[:6] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1, -8]
    sh = np.array([0, 1, 63, 64, 100, -1] * 11, dtype=np.int64)[:N]
    j = rng.integers(-1000, 1000, N).astype(np.int64)
    cols = [
        ("s", "varchar", rng.integers(0, len(WORDS), N).astype(np.int32), nulls(), WORDS),
        ("url", "varchar", rng.integers(0, len(URLS), N).astype(np.int32), nulls(), URLS),
        ("f", "double", f, nulls(), None),
        ("g", "double", g, nulls(), None),
        ("d", "decimal(12,2)", d, nulls(), None),
        ("i", "bigint", i, nulls(), None),
        ("sh", "bigint", sh, nulls(), None),
        ("j", "bigint", j, nulls(), None),
    ]
    return cols, rng.random(N) < 0.9


H = Harness(*_breadth_columns())

CASES = {
    # -- strings ---------------------------------------------------------------
    "split_part_1": lambda x: x.call("split_part", "varchar", x.col("s"), x.s(" "), x.lit(1, "bigint")),
    "split_part_2": lambda x: x.call("split_part", "varchar", x.col("s"), x.s(" "), x.lit(2, "bigint")),
    "split_part_0": lambda x: x.call("split_part", "varchar", x.col("s"), x.s(" "), x.lit(0, "bigint")),
    "split_part_past_end": lambda x: x.call("split_part", "varchar", x.col("s"), x.s("|"), x.lit(3, "bigint")),
    "split_part_empty_delim": lambda x: x.call("split_part", "varchar", x.col("s"), x.s(""), x.lit(1, "bigint")),
    "lpad": lambda x: x.call("lpad", "varchar", x.col("s"), x.lit(12, "bigint"), x.s("*-")),
    "lpad_truncates": lambda x: x.call("lpad", "varchar", x.col("s"), x.lit(3, "bigint"), x.s("*")),
    "lpad_default_pad": lambda x: x.call("lpad", "varchar", x.col("s"), x.lit(8, "bigint")),
    "lpad_empty_pad": lambda x: x.call("lpad", "varchar", x.col("s"), x.lit(8, "bigint"), x.s("")),
    "rpad": lambda x: x.call("rpad", "varchar", x.col("s"), x.lit(12, "bigint"), x.s(".")),
    "rpad_zero": lambda x: x.call("rpad", "varchar", x.col("s"), x.lit(0, "bigint"), x.s(".")),
    "translate": lambda x: x.call("translate", "varchar", x.col("s"), x.s("AEIOU"), x.s("aeiou")),
    "translate_delete": lambda x: x.call("translate", "varchar", x.col("s"), x.s("aa b"), x.s("Xy")),
    "codepoint": lambda x: x.call("codepoint", "bigint", x.col("s")),
    "chr": lambda x: x.call("chr", "varchar", x.lit(233, "bigint")),
    "normalize_default": lambda x: x.call("normalize", "varchar", x.col("s")),
    "normalize_nfd": lambda x: x.call("normalize", "varchar", x.col("s"), x.s("NFD")),
    "normalize_nfkc": lambda x: x.call("normalize", "varchar", x.col("s"), x.s("NFKC")),
    "normalize_nfkd": lambda x: x.call("normalize", "varchar", x.col("s"), x.s("NFKD")),
    "levenshtein": lambda x: x.call("levenshtein_distance", "bigint", x.col("s"), x.s("25-989-741-2988")),
    "levenshtein_empty_target": lambda x: x.call("levenshtein_distance", "bigint", x.col("s"), x.s("")),
    "levenshtein_short_target": lambda x: x.call("levenshtein_distance", "bigint", x.col("s"), x.s("cafe")),
    "url_encode": lambda x: x.call("url_encode", "varchar", x.col("s")),
    "url_decode": lambda x: x.call("url_decode", "varchar", x.col("s")),
    "url_extract_host": lambda x: x.call("url_extract_host", "varchar", x.col("url")),
    "url_extract_protocol": lambda x: x.call("url_extract_protocol", "varchar", x.col("url")),
    "url_extract_path": lambda x: x.call("url_extract_path", "varchar", x.col("url")),
    "url_extract_query": lambda x: x.call("url_extract_query", "varchar", x.col("url")),
    "url_extract_fragment": lambda x: x.call("url_extract_fragment", "varchar", x.col("url")),
    "url_extract_port": lambda x: x.call("url_extract_port", "bigint", x.col("url")),
    # -- math ------------------------------------------------------------------
    "asin": lambda x: x.call("asin", "double", x.col("f")),
    "acos": lambda x: x.call("acos", "double", x.col("f")),
    "atan": lambda x: x.call("atan", "double", x.col("f")),
    "sinh": lambda x: x.call("sinh", "double", x.col("f")),
    "cosh": lambda x: x.call("cosh", "double", x.col("f")),
    "tanh": lambda x: x.call("tanh", "double", x.col("f")),
    "asin_decimal": lambda x: x.call("asin", "double", x.call("$div", "double", x.col("d"), x.lit(1e6, "double"))),
    "atan2": lambda x: x.call("atan2", "double", x.col("f"), x.col("g")),
    "atan2_decimal": lambda x: x.call("atan2", "double", x.col("d"), x.lit(100.0, "double")),
    "log": lambda x: x.call("log", "double", x.lit(2, "bigint"), x.col("f")),
    "log_base_column": lambda x: x.call("log", "double", x.col("g"), x.lit(8.0, "double")),
    "log_base_one": lambda x: x.call("log", "double", x.lit(1, "bigint"), x.col("f")),
    "log_decimal": lambda x: x.call("log", "double", x.lit(10, "bigint"), x.col("d")),
    "truncate": lambda x: x.call("truncate", "double", x.col("f")),
    "truncate_decimal": lambda x: x.call("truncate", "double", x.col("d")),
    "e": lambda x: x.call("e", "double"),
    "pi": lambda x: x.call("pi", "double"),
    "nan": lambda x: x.call("nan", "double"),
    "infinity": lambda x: x.call("infinity", "double"),
    "is_nan": lambda x: x.call("is_nan", "boolean", x.col("f")),
    "is_finite": lambda x: x.call("is_finite", "boolean", x.col("f")),
    "is_infinite": lambda x: x.call("is_infinite", "boolean", x.col("f")),
    "is_nan_decimal": lambda x: x.call("is_nan", "boolean", x.col("d")),
    "width_bucket": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.lit(-1.0, "double"),
                                     x.lit(1.0, "double"), x.lit(4, "bigint")),
    "width_bucket_decimal": lambda x: x.call("width_bucket", "bigint", x.col("d"), x.lit(-1000, "bigint"),
                                             x.lit(10000, "bigint"), x.lit(11, "bigint")),
    "width_bucket_reversed": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.lit(1.0, "double"),
                                              x.lit(-1.0, "double"), x.lit(4, "bigint")),
    "width_bucket_zero_buckets": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.lit(-1.0, "double"),
                                                  x.lit(1.0, "double"), x.lit(0, "bigint")),
    "width_bucket_negative_buckets": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.lit(-1.0, "double"),
                                                      x.lit(1.0, "double"), x.col("j")),
    "width_bucket_equal_bounds": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.lit(1.0, "double"),
                                                  x.lit(1.0, "double"), x.lit(3, "bigint")),
    "width_bucket_column_bounds": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.col("g"),
                                                   x.lit(2.0, "double"), x.lit(5, "bigint")),
    "width_bucket_huge_count": lambda x: x.call("width_bucket", "bigint", x.col("f"), x.lit(-1.0, "double"),
                                                x.lit(1.0, "double"), x.lit(2**62, "bigint")),
    # -- bitwise ---------------------------------------------------------------
    "bitwise_and": lambda x: x.call("bitwise_and", "bigint", x.col("i"), x.col("j")),
    "bitwise_or": lambda x: x.call("bitwise_or", "bigint", x.col("i"), x.col("j")),
    "bitwise_xor": lambda x: x.call("bitwise_xor", "bigint", x.col("i"), x.col("j")),
    "bitwise_not": lambda x: x.call("bitwise_not", "bigint", x.col("i")),
    "bitwise_left_shift": lambda x: x.call("bitwise_left_shift", "bigint", x.col("i"), x.col("sh")),
    "bitwise_left_shift_negative": lambda x: x.call("bitwise_left_shift", "bigint", x.col("j"), x.col("sh")),
    "bitwise_right_shift_arithmetic": lambda x: x.call(
        "bitwise_right_shift_arithmetic", "bigint", x.col("i"), x.col("sh")),
    "bitwise_right_shift_arithmetic_negative": lambda x: x.call(
        "bitwise_right_shift_arithmetic", "bigint", x.col("j"), x.col("sh")),
    "bit_count_64": lambda x: x.call("bit_count", "bigint", x.col("i"), x.lit(64, "bigint")),
    "bit_count_63": lambda x: x.call("bit_count", "bigint", x.col("i"), x.lit(63, "bigint")),
    "bit_count_8": lambda x: x.call("bit_count", "bigint", x.col("j"), x.lit(8, "bigint")),
    "bit_count_no_width": lambda x: x.call("bit_count", "bigint", x.col("i")),
    "typeof": lambda x: x.call("typeof", "varchar", x.col("d")),
    "version": lambda x: x.call("version", "varchar"),
    # -- host renders ----------------------------------------------------------
    "concat_ws": lambda x: x.call("concat_ws", "varchar", x.s("|"), x.col("s"), x.col("url"), x.col("s")),
    "concat_ws_null_separator": lambda x: x.call(
        "concat_ws", "varchar", x.lit(None, "varchar"), x.col("s"), x.col("url"), x.s("z")),
    "concat_ws_non_strings": lambda x: x.call(
        "concat_ws", "varchar", x.s(","), x.col("j"), x.col("f"), x.lit(None, "varchar"), x.col("s")),
    "format": lambda x: x.call("format", "varchar", x.s("%s|%05d|%.3f|%x|%-6s|%+,d|%e|100%%"),
                               x.col("s"), x.col("j"), x.col("f"), x.col("j"), x.col("url"),
                               x.col("i"), x.col("g")),
    "format_decimal_and_null": lambda x: x.call("format", "varchar", x.s("[%10s] %s %d"), x.col("d"),
                                                x.lit(None, "varchar"), x.col("j")),
}

RAISES = {
    "hamming_distance": lambda x: x.call("hamming_distance", "bigint", x.col("s"), x.s("abc")),
    "chr_column": lambda x: x.call("chr", "varchar", x.col("j")),
    "split_part_column_delim": lambda x: x.call("split_part", "varchar", x.col("s"), x.col("url"), x.lit(1, "bigint")),
    "format_argument_index": lambda x: x.call("format", "varchar", x.s("%1$s"), x.col("s")),
    "format_directive": lambda x: x.call("format", "varchar", x.s("%c"), x.col("j")),
    "format_arity": lambda x: x.call("format", "varchar", x.s("%s %s"), x.col("s")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_breadth_function_matches_jax(name):
    H.check(CASES[name])


@pytest.mark.parametrize("name", list(RAISES))
def test_port_raises_where_jax_raises(name):
    H.raises(RAISES[name])


def test_every_jax_function_is_registered():
    from trino_tpu.expr.functions import FUNCTIONS as jax_functions

    assert set(jax_functions) <= set(tfn.FUNCTIONS)


def test_host_tables_are_kept_across_batches():
    """A dictionary table is built once for equal dictionaries and logged
    once; a new argument builds a new one."""
    tfn.HOST_TABLE_LOG.clear()
    for _ in range(3):
        H.check(CASES["levenshtein"])
    built = [e for e in tfn.HOST_TABLE_LOG if e[0] == "levenshtein_distance"]
    assert len(built) <= 1  # none when an earlier test built it
    H.check(CASES["levenshtein_short_target"])
    H.check(CASES["lpad"])
    assert all(n == len(set(WORDS)) for _, n, _ in tfn.HOST_TABLE_LOG)


# -- SQL ----------------------------------------------------------------------------


#: the format cases of tests/test_sql_surface.py and the typeof/version/
#: concat_ws cases of tests/test_lambdas.py
SQL_CASES = {
    "format_nations": (
        "select format('%s has %d nations', r_name, 5) from region order by r_name limit 1"
    ),
    "format_directives": (
        "select format('%05d|%.2f|%s', n_nationkey, 1.5, n_name), format('%,d', 1234567), "
        "format('%s', date '2024-03-01'), format('100%%'), format('%s', cast(null as varchar)) "
        "from nation order by n_nationkey limit 1"
    ),
    "format_flags": (
        "select format('[%10s]', 'hi'), format('[%-6s]', 'hi'), format('%+d', 5), "
        "format('%#x', 255), format('%s', cast(1.10 as decimal(4,2))), "
        "format('%d', cast(null as bigint))"
    ),
    "typeof_version_concat_ws": (
        "select typeof(1), typeof(array[1]), concat_ws('-', 'a', 'b', 'c'), version()"
    ),
    "concat_ws_null_handling": (
        "select concat_ws(',', cast(null as varchar), 'b', 'c'), "
        "concat_ws(',', 'a', cast(null as varchar), 'c'), "
        "concat_ws(',', cast(null as varchar), cast(null as varchar)), "
        "concat_ws(',', '', 'b'), concat_ws(cast(null as varchar), 'a', 'b')"
    ),
    "format_over_columns": (
        "select format('%s:%s:%s', o_orderdate, cast(o_orderdate as timestamp), "
        "cast(o_orderdate as timestamp) at time zone '-03:30'), "
        "concat_ws('/', o_orderstatus, o_clerk, o_orderpriority, o_comment) "
        "from orders where o_orderkey < 40"
    ),
}


@pytest.fixture(scope="module")
def runners():
    return Runners()


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_sql_breadth_statements(runners, name):
    runners.check(SQL_CASES[name])


@pytest.mark.parametrize("where", ["local", "mesh"])
@pytest.mark.parametrize("name", ["T4", "T5", "T6"])
def test_chip_smoke_breadth_statements(runners, name, where):
    """chip_smoke.py's phase-5j statements T4-T6 at tiny, held to the JAX
    package's local rows."""
    runners.check(chip_smoke.TEMPORAL_QUERIES[name], where)

"""The port's conditional special forms (trino_tpu_torch/expr/compiler.py)
against the JAX package's compiler.

  * each form — OR, NOT, IS NULL, IF, searched CASE, COALESCE, NULLIF, IN
    and TRY — compiled by both packages over the same seeded numpy batch,
    bit for bit in values and validity: bigint columns with NULLs, long
    decimals (two int64 limb planes, [capacity, 2]) through CASE, COALESCE
    and NULLIF, and dictionary-coded varchar through CASE (merged branch
    dictionaries: the same strings behind the same codes) and IN (a literal
    absent from the dictionary matches nothing);
  * the same forms in SQL through the port's LocalQueryRunner(device="cpu")
    against the JAX LocalQueryRunner at tpch.tiny, with NULLs from an outer
    join and from NULLIF.
"""

from decimal import Decimal

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar.dictionary import StringDictionary as JDict
from trino_tpu.expr import ExprCompiler as JCompiler
from trino_tpu.expr import ir as jir
from trino_tpu.runtime.runner import LocalQueryRunner as JaxRunner
from trino_tpu_torch import types as TT
from trino_tpu_torch.columnar import Batch as TBatch, Column as TColumn, StringDictionary as TDict
from trino_tpu_torch.expr import ExprCompiler as TCompiler
from trino_tpu_torch.expr import ir as tir
from trino_tpu_torch.runtime.runner import LocalQueryRunner

from test_torch_e2e import assert_same_rows

N = 257
MODES = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"]
CITIES = ["LIMA", "MAIL", "OSLO", "ROME"]


def _batches():
    """(JAX Batch, port Batch) over the same seeded columns:
    0 a bigint (NULLs), 1 b bigint (NULLs), 2 d1 decimal(30,2) (NULLs),
    3 d2 decimal(30,2), 4 s1 varchar over MODES (NULLs), 5 s2 varchar over
    CITIES, 6 flag boolean (NULLs)."""
    rng = np.random.default_rng(11)

    def limbs():
        hi = rng.integers(-3, 3, N).astype(np.int64)
        lo = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, N, dtype=np.int64)
        return np.stack([hi, lo], axis=-1)

    cols = [
        ("bigint", rng.integers(-5, 6, N).astype(np.int64), rng.random(N) < 0.8, None),
        ("bigint", rng.integers(-5, 6, N).astype(np.int64), rng.random(N) < 0.8, None),
        ("dec30", limbs(), rng.random(N) < 0.8, None),
        ("dec30", limbs(), None, None),
        ("varchar", rng.integers(0, len(MODES), N).astype(np.int32), rng.random(N) < 0.85, MODES),
        ("varchar", rng.integers(0, len(CITIES), N).astype(np.int32), None, CITIES),
        ("boolean", rng.random(N) < 0.5, rng.random(N) < 0.8, None),
    ]
    types = {
        "bigint": (JT.BIGINT, TT.BIGINT),
        "dec30": (JT.DecimalType(30, 2), TT.DecimalType(30, 2)),
        "varchar": (JT.VARCHAR, TT.VARCHAR),
        "boolean": (JT.BOOLEAN, TT.BOOLEAN),
    }
    mask = rng.random(N) < 0.9
    jcols, tcols = [], []
    for tname, data, valid, values in cols:
        jt, tt = types[tname]
        jcols.append(JColumn(
            jnp.asarray(data), jt, None if valid is None else jnp.asarray(valid),
            None if values is None else JDict(values),
        ))
        tcols.append(TColumn(
            torch.from_numpy(np.ascontiguousarray(data)), tt,
            None if valid is None else torch.from_numpy(valid),
            None if values is None else TDict(values),
        ))
    return JBatch(jcols, jnp.asarray(mask)), TBatch(tcols, torch.from_numpy(mask))


def _exprs(ir, T) -> dict:
    """The same expressions built in one package's IR."""
    F, SF, R, L = ir.Form, ir.SpecialForm, ir.InputRef, ir.Literal
    cmp = ir.comparison
    dec = T.DecimalType(30, 2)
    a, b = R(0, T.BIGINT), R(1, T.BIGINT)
    d1, d2 = R(2, dec), R(3, dec)
    s1, s2 = R(4, T.VARCHAR), R(5, T.VARCHAR)
    flag = R(6, T.BOOLEAN)
    zero = L(0, T.BIGINT)
    a_pos, b_pos = cmp(">", a, zero), cmp(">", b, zero)
    return {
        "or": SF(F.OR, [a_pos, cmp("<", b, zero), flag]),
        "or_null_literal": SF(F.OR, [a_pos, L(None, T.BOOLEAN)]),
        "not": SF(F.NOT, [flag]),
        "not_comparison": SF(F.NOT, [a_pos]),
        "is_null": SF(F.IS_NULL, [a]),
        "is_null_long": SF(F.IS_NULL, [d1]),
        "is_null_varchar": SF(F.IS_NULL, [s1]),
        "if": SF(F.IF, [a_pos, b, a], T.BIGINT),
        "case": SF(F.CASE, [a_pos, b, b_pos, a, L(7, T.BIGINT)], T.BIGINT),
        "case_no_default": SF(F.CASE, [a_pos, b], T.BIGINT),
        "case_null_condition": SF(F.CASE, [flag, a, b], T.BIGINT),
        "case_long": SF(F.CASE, [a_pos, d1, b_pos, d2, L(Decimal("1.50"), dec)], dec),
        "case_long_no_default": SF(F.CASE, [flag, d1], dec),
        "if_long": SF(F.IF, [flag, d2, L(Decimal("-12345678901234567.89"), dec)], dec),
        "case_varchar": SF(F.CASE, [a_pos, s1, b_pos, s2, L("ZURICH", T.VARCHAR)], T.VARCHAR),
        "case_varchar_literals": SF(
            F.CASE, [a_pos, L("one", T.VARCHAR), b_pos, L("two", T.VARCHAR)], T.VARCHAR
        ),
        "coalesce": SF(F.COALESCE, [a, b, L(-1, T.BIGINT)], T.BIGINT),
        "coalesce_long": SF(F.COALESCE, [d1, d2], dec),
        "coalesce_long_literal": SF(F.COALESCE, [d1, L(Decimal("0.01"), dec)], dec),
        "coalesce_varchar": SF(F.COALESCE, [s1, s2], T.VARCHAR),
        "nullif": SF(F.NULLIF, [a, b], T.BIGINT),
        "nullif_long": SF(F.NULLIF, [d1, d2], dec),
        "nullif_long_self": SF(F.NULLIF, [d1, d1], dec),
        "in": SF(F.IN, [a, L(1, T.BIGINT), L(-3, T.BIGINT), b]),
        "in_varchar": SF(F.IN, [s1, L("AIR", T.VARCHAR), L("SHIP", T.VARCHAR)]),
        "in_varchar_absent": SF(F.IN, [s1, L("NOWHERE", T.VARCHAR), L("MAIL", T.VARCHAR)]),
        "in_varchar_all_absent": SF(F.IN, [s2, L("NOWHERE", T.VARCHAR)]),
        "try": SF(F.TRY, [ir.Call("$div", [a, b], T.BIGINT)], T.BIGINT),
    }


FORMS = list(_exprs(tir, TT))


@pytest.fixture(scope="module")
def compiled():
    jb, tb = _batches()
    return jb, tb, _exprs(jir, JT), _exprs(tir, TT)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert str(t.numpy().dtype) == str(np.asarray(j).dtype)


@pytest.mark.parametrize("name", FORMS)
def test_special_form_bit_exact(compiled, name):
    jb, tb, jexprs, texprs = compiled
    jcol = JCompiler(jb).column(jexprs[name])
    tcol = TCompiler(tb).column(texprs[name])
    assert tcol.type.name == jcol.type.name
    _eq(tcol.data, jcol.data)
    assert (tcol.valid is None) == (jcol.valid is None)
    if tcol.valid is not None:
        _eq(tcol.valid, jcol.valid)
    assert (tcol.dictionary is None) == (jcol.dictionary is None)
    if tcol.dictionary is not None:
        assert list(tcol.dictionary.values) == list(jcol.dictionary.values)
    if name.startswith("in_varchar_all_absent"):
        assert not bool(tcol.data.any())


# -- end to end through the local runner ---------------------------------------

SQL = {
    "case_or_nullif": (
        "select o_orderkey, case when o_orderpriority = '1-URGENT' or "
        "o_orderpriority = '2-HIGH' then 1 else 0 end, "
        "coalesce(nullif(o_shippriority, 0), -1), nullif(o_orderstatus, 'F') "
        "from orders where o_orderkey < 300 order by 1"
    ),
    "simple_case_if_varchar": (
        "select n_nationkey, case n_regionkey when 1 then 'one' when 2 then 'two' end, "
        "if(n_nationkey > 10, n_name, 'small') from nation order by 1"
    ),
    "outer_join_nulls": (
        "select c_custkey, coalesce(o_totalprice, 0), o_orderkey is null, "
        "not (c_acctbal > 0), coalesce(o_orderstatus, c_mktsegment) from customer "
        "left join orders on c_custkey = o_custkey where c_custkey < 40 "
        "order by 1, 2"
    ),
    "in_between_or": (
        "select l_shipmode, count(*) from lineitem where l_shipmode in "
        "('MAIL', 'SHIP', 'NOWHERE') or not (l_quantity between 2 and 49) "
        "group by l_shipmode order by 1"
    ),
    "long_decimal_case": (
        "select l_returnflag, sum(case when l_linestatus = 'O' then "
        "l_extendedprice * (1 - l_discount) else 0 end) from lineitem "
        "group by l_returnflag order by 1"
    ),
}


@pytest.fixture(scope="module")
def runners():
    return (
        JaxRunner(catalog="tpch", schema="tiny"),
        LocalQueryRunner(catalog="tpch", schema="tiny", device="cpu"),
    )


@pytest.mark.parametrize("name", list(SQL))
def test_forms_in_sql_match_jax(runners, name):
    jax_runner, port_runner = runners
    expected = jax_runner.execute(SQL[name])
    actual = port_runner.execute(SQL[name])
    assert actual.column_names == expected.column_names
    assert len(expected.rows) > 0
    assert_same_rows(actual.rows, expected.rows, ordered=True, float_rtol=1e-9)

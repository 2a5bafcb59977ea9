"""Scalar function library (reference: operator/scalar/* plus the per-type
operators in type/*Operators.java).

Port of trino_tpu/expr/functions.py up to its casts: short- and
long-decimal arithmetic (division and modulus over int128 limbs, rounded
half away from zero), comparisons (numeric, date and dictionary-coded
strings), the numeric functions, the civil-date functions over DATE
values, the dictionary string functions (LIKE, the regexp family, substr,
the case/trim/replace maps, length, strpos, concat) and the cast family.
String functions evaluate over the dictionary on the host and gather a
table by code on the device; every gather clamps its codes first, as the
JAX package's ``take(mode="clip")`` does, so a NULL row's code may be
anything.  Timestamp and time-zone values, the string/url/math/bitwise
breadth past the casts and ``concat_ws`` raise NotImplementedError by name.
The array, JSON and lambda functions live in expr/arrays.py and the map
functions in expr/maps.py; both register here when this module loads.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.columnar.column import take_table, torch_dtype
from trino_tpu_torch.expr.compiler import ExprCompiler, Val, _and_valid
from trino_tpu_torch.expr.ir import Call
from trino_tpu_torch.expr.strings import like_prefix, like_to_regex

FUNCTIONS: dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        FUNCTIONS[name] = fn
        return fn

    return deco


def dispatch(ctx: ExprCompiler, call: Call) -> Val:
    from trino_tpu_torch.expr.ir import Lambda

    fn = FUNCTIONS.get(call.name)
    if fn is None:
        raise NotImplementedError(f"scalar function not ported yet: {call.name}")
    # lambda arguments pass through unevaluated: the handler binds their
    # parameters over array elements and evaluates the body itself
    vals = [a if isinstance(a, Lambda) else ctx.value(a) for a in call.args]
    return fn(ctx, call, *vals)


# ---------------------------------------------------------------------------
# numeric coercion helpers


def _dec_scale(t: T.Type) -> int | None:
    return t.scale if isinstance(t, T.DecimalType) else None


def _is_long_dec(t: T.Type) -> bool:
    return isinstance(t, T.DecimalType) and t.is_long


def _is_float(t: T.Type) -> bool:
    return t.name in ("real", "double")


def _i64(d: torch.Tensor) -> torch.Tensor:
    return d.to(torch.int64)


def _to_planes(v: Val, to_scale: int):
    """Any integer/decimal Val -> (hi, lo) i128 planes rescaled to to_scale
    (types/int128.py limb convention)."""
    from trino_tpu_torch.types import int128 as i128

    t = v.type
    if _is_long_dec(t):
        d = _i64(v.data)
        if d.ndim == 0:  # null-fill scalar
            h = l = torch.zeros((), dtype=torch.int64, device=d.device)
        elif d.ndim == 1:
            # 1-D data under a long type: short-valued rows; literals always
            # carry [1, 2] planes
            h, l = i128.widen64(d)
        else:
            h, l = d[..., 0], d[..., 1]
        return i128.rescale128(h, l, t.scale, to_scale)
    s = t.scale if isinstance(t, T.DecimalType) else 0
    h, l = i128.widen64(_i64(v.data))
    return i128.rescale128(h, l, s, to_scale)


def _planes_val(h, l, rt: T.Type, valid) -> Val:
    """Stack (hi, lo) planes into a long-decimal Val ([..., 2]).  Scalar
    planes keep an explicit leading row axis ([1, 2]): a bare (2,) tensor
    would read as two SHORT-valued rows downstream."""
    h, l = torch.broadcast_tensors(_i64(h), _i64(l))
    if h.ndim == 0:
        h, l = h[None], l[None]
    return Val(torch.stack([h, l], dim=-1), valid, rt)


def _to_float(v: Val) -> torch.Tensor:
    """Numeric value as f64 data.  A decimal descales by multiplying by
    fl(1 / 10**scale): XLA folds the JAX package's division by the constant
    scale factor into that multiplication, so the doubles (and the checksum
    hashes of them) are the JAX package's bit for bit."""
    if _is_long_dec(v.type):
        from trino_tpu_torch.types import int128 as i128

        h, l = _to_planes(v, v.type.scale)
        return i128.to_float128(h, l) * (1.0 / v.type.scale_factor)
    d = v.data.to(torch.float64)
    if isinstance(v.type, T.DecimalType):
        return d * (1.0 / v.type.scale_factor)
    return d


def _align_numeric(a: Val, b: Val):
    """Coerce two numeric values to a common device representation:
    decimal operands rescaled to a shared scale (integer math), or both
    lifted to f64.  Returns (a_data, b_data, result_type_hint)."""
    ta, tb = a.type, b.type
    if T.is_string_kind(ta) or T.is_string_kind(tb):
        raise TypeError("string arithmetic")
    if _is_float(ta) or _is_float(tb):
        return _to_float(a), _to_float(b), T.DOUBLE
    da, db = isinstance(ta, T.DecimalType), isinstance(tb, T.DecimalType)
    if da or db:
        sa = ta.scale if da else 0
        sb = tb.scale if db else 0
        s = max(sa, sb)
        ad = _i64(a.data) * (10 ** (s - sa))
        bd = _i64(b.data) * (10 ** (s - sb))
        return ad, bd, T.DecimalType(18, s)
    # integer kinds (and date/timestamp, which are integers on device)
    dt = np.promote_types(ta.np_dtype, tb.np_dtype)
    tdt = torch_dtype(dt)
    return a.data.to(tdt), b.data.to(tdt), ta if ta.np_dtype == dt else tb


def _rescale_decimal(data, from_scale: int, to_scale: int):
    if from_scale == to_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    # round half away from zero on downscale, symmetric in sign
    f = 10 ** (from_scale - to_scale)
    return torch.sign(data) * ((data.abs() + f // 2) // f)


# ---------------------------------------------------------------------------
# arithmetic


def _arith(ctx, call, a, b, op):
    valid = _and_valid(a.valid, b.valid)
    rt = call.type
    if (
        (_is_long_dec(rt) or _is_long_dec(a.type) or _is_long_dec(b.type))
        and not (_is_float(rt) or _is_float(a.type) or _is_float(b.type))
        and op in (torch.add, torch.sub)
    ):
        # exact two-limb path (reference: Int128Math.add/subtract)
        from trino_tpu_torch.types import int128 as i128

        s = rt.scale if isinstance(rt, T.DecimalType) else 0
        ah, al = _to_planes(a, s)
        bh, bl = _to_planes(b, s)
        h, l = (i128.add128 if op is torch.add else i128.sub128)(ah, al, bh, bl)
        if isinstance(rt, T.DecimalType) and not rt.is_long:
            # short declared result from long operands: the low limb carries
            # the (asserted-to-fit) value exactly
            return Val(l, valid, rt)
        return _planes_val(h, l, rt, valid)
    ad, bd, hint = _align_numeric(a, b)
    if _is_float(rt) or hint is T.DOUBLE:
        out = op(ad.to(torch.float64), bd.to(torch.float64))
        return Val(out, valid, T.DOUBLE if rt.name != "real" else rt)
    out = op(ad, bd)
    if isinstance(rt, T.DecimalType) and isinstance(hint, T.DecimalType):
        out = _rescale_decimal(out, hint.scale, rt.scale)
    return Val(out, valid, rt)


@register("$add")
def _add(ctx, call, a, b):
    return _arith(ctx, call, a, b, torch.add)


@register("$sub")
def _sub(ctx, call, a, b):
    return _arith(ctx, call, a, b, torch.sub)


@register("$mul")
def _mul(ctx, call, a, b):
    rt = call.type
    valid = _and_valid(a.valid, b.valid)
    sa, sb = _dec_scale(a.type), _dec_scale(b.type)
    if _is_long_dec(a.type) or _is_long_dec(b.type) or _is_long_dec(rt):
        if _is_float(a.type) or _is_float(b.type):
            return Val(_to_float(a) * _to_float(b), valid, T.DOUBLE)
        from trino_tpu_torch.types import int128 as i128

        if _is_long_dec(a.type) and _is_long_dec(b.type):
            raise NotImplementedError("multiplication of two long decimals")
        ls = _dec_scale(a.type) or 0
        ss = _dec_scale(b.type) or 0
        if not _is_long_dec(a.type) and not _is_long_dec(b.type):
            # short x short with a long result: one exact 64x64->128
            h, l = i128.mul64x64(_i64(a.data), _i64(b.data))
        else:
            # one side rides as planes, the other as a plain i64 multiplier
            long_v, short_v = (a, b) if _is_long_dec(a.type) else (b, a)
            ls = _dec_scale(long_v.type) or 0
            ss = _dec_scale(short_v.type) or 0
            h, l = _to_planes(long_v, ls)
            h, l = i128.mul128_by_i64vec(h, l, _i64(short_v.data))
        prod_scale = ls + ss
        out_scale = rt.scale if isinstance(rt, T.DecimalType) else prod_scale
        h, l = i128.rescale128(h, l, prod_scale, out_scale)
        if isinstance(rt, T.DecimalType) and not rt.is_long:
            return Val(l, valid, rt)
        return _planes_val(h, l, rt, valid)
    if sa is not None or sb is not None:
        if _is_float(a.type) or _is_float(b.type):
            return Val(_to_float(a) * _to_float(b), valid, T.DOUBLE)
        out = _i64(a.data) * _i64(b.data)
        prod_scale = (sa or 0) + (sb or 0)
        if isinstance(rt, T.DecimalType):
            return Val(_rescale_decimal(out, prod_scale, rt.scale), valid, rt)
        return Val(out, valid, T.DecimalType(18, prod_scale))
    return _arith(ctx, call, a, b, torch.mul)


@register("$div")
def _div(ctx, call, a, b):
    # exact SQL semantics; division by zero yields NULL (TRY semantics)
    valid = _and_valid(a.valid, b.valid)
    rt = call.type
    sa, sb = _dec_scale(a.type), _dec_scale(b.type)
    if _is_long_dec(a.type) or _is_long_dec(b.type):
        if _is_float(rt) or _is_float(b.type):
            bz = _to_float(b) == 0.0
            valid = _and_valid(valid, torch.logical_not(bz))
            return Val(
                _to_float(a) / torch.where(bz, 1.0, _to_float(b)), valid, T.DOUBLE
            )
        if _is_long_dec(b.type):
            raise NotImplementedError("division by a long decimal")
        from trino_tpu_torch.types import int128 as i128

        out_scale = rt.scale if isinstance(rt, T.DecimalType) else 0
        # numerator scaled so the quotient lands at out_scale (reference:
        # Int128Math.divideRoundUp shift arithmetic)
        h, l = _to_planes(a, out_scale + (sb or 0))
        bd = _i64(b.data)
        bz = bd == 0
        valid = _and_valid(valid, torch.logical_not(bz))
        den = torch.where(bz, 1, bd)
        neg_d = den < 0
        den_abs = den.abs()
        qh, ql, r = i128.divmod128_by_vec(h, l, den_abs)
        # round half away from zero: the remainder carries the dividend's sign
        round_up = (2 * r.abs()) >= den_abs
        neg_q = (h < 0) ^ neg_d
        one = torch.ones_like(qh)
        bump = torch.where(round_up, torch.where(neg_q, -one, one), 0)
        nqh, nql = i128.neg128(qh, ql)
        qh = torch.where(neg_d, nqh, qh)
        ql = torch.where(neg_d, nql, ql)
        qh, ql = i128.add128(qh, ql, bump >> 63, bump)
        if isinstance(rt, T.DecimalType) and not rt.is_long:
            return Val(ql, valid, rt)
        return _planes_val(qh, ql, rt, valid)
    bzero = b.data == 0
    valid = _and_valid(valid, torch.logical_not(bzero))
    if _is_float(rt):
        return Val(_to_float(a) / torch.where(bzero, 1.0, _to_float(b)), valid, rt)
    if isinstance(rt, T.DecimalType):
        # short-decimal division: numerator rescaled by 10^(s_out - sa + sb);
        # truncating division + round half away from zero (SQL), not floor
        shift = rt.scale - (sa or 0) + (sb or 0)
        num = _i64(a.data) * (10 ** max(shift, 0))
        den = torch.where(bzero, 1, _i64(b.data)) * (10 ** max(-shift, 0))
        sign = torch.sign(num) * torch.sign(den)
        q = num.abs() // den.abs()
        r = num.abs() - q * den.abs()
        return Val(sign * (q + torch.where(2 * r >= den.abs(), 1, 0)), valid, rt)
    # integer division truncates toward zero: floor-div + mixed-sign
    # adjustment (abs() would wrap at INT64_MIN)
    ad = _i64(a.data)
    bd = torch.where(bzero, 1, _i64(b.data))
    qf = ad // bd
    rem = ad - qf * bd
    adjust = torch.logical_and(rem != 0, (ad < 0) ^ (bd < 0)).to(torch.int64)
    return Val((qf + adjust).to(torch_dtype(rt.np_dtype)), valid, rt)


@register("$mod")
def _mod(ctx, call, a, b):
    valid = _and_valid(a.valid, b.valid)
    if _is_long_dec(a.type) or _is_long_dec(b.type) or _is_long_dec(call.type):
        if _is_long_dec(b.type):
            raise NotImplementedError("mod by a long decimal")
        from trino_tpu_torch.types import int128 as i128

        s = max(_dec_scale(a.type) or 0, _dec_scale(b.type) or 0)
        h, l = _to_planes(a, s)
        sb = _dec_scale(b.type) or 0
        pb = b.type.precision if isinstance(b.type, T.DecimalType) else 19
        if pb + (s - sb) > 18:
            # the rescaled divisor could overflow i64 (static type bound)
            raise NotImplementedError(
                "mod with a divisor wider than 18 digits at the common scale"
            )
        bd = _i64(b.data) * (10 ** (s - sb))
        bz = bd == 0
        valid = _and_valid(valid, torch.logical_not(bz))
        den = torch.where(bz, 1, bd).abs()
        _, _, r = i128.divmod128_by_vec(h, l, den)  # sign follows the dividend
        rt = call.type
        out_s = rt.scale if isinstance(rt, T.DecimalType) else s
        rh, rl = i128.rescale128(*i128.widen64(r), s, out_s)
        if isinstance(rt, T.DecimalType) and rt.is_long:
            return _planes_val(rh, rl, rt, valid)
        return Val(rl, valid, rt)
    bzero = b.data == 0
    valid = _and_valid(valid, torch.logical_not(bzero))
    ad, bd, _ = _align_numeric(a, b)
    bd = torch.where(bzero, torch.ones_like(bd), bd)
    # SQL mod: the sign follows the dividend
    return Val(torch.sign(ad) * (ad.abs() % bd.abs()), valid, call.type)


@register("$neg")
def _neg(ctx, call, a):
    if _is_long_dec(a.type):
        from trino_tpu_torch.types import int128 as i128

        h, l = _to_planes(a, a.type.scale)
        return _planes_val(*i128.neg128(h, l), call.type, a.valid)
    return Val(torch.neg(a.data), a.valid, call.type)


# ---------------------------------------------------------------------------
# comparisons (dictionary-aware)


def _codes(ctx, v: Val) -> torch.Tensor:
    return v.data.to(torch.int32)


def _cmp_operands(ctx, a: Val, b: Val):
    """Align two values for comparison; returns (ad, bd) tensors."""
    if a.dictionary is not None or b.dictionary is not None:
        da, db = a.dictionary, b.dictionary
        if da is not None and db is not None:
            if da is db or da == db:
                return _codes(ctx, a), _codes(ctx, b)
            from trino_tpu_torch.columnar.dictionary import union_dictionaries

            _, ra, rb = union_dictionaries(da, db)
            ta = ctx.tensor(np.asarray(ra, dtype=np.int32), torch.int32)
            tb = ctx.tensor(np.asarray(rb, dtype=np.int32), torch.int32)
            ad = ta[_i64(a.data).clamp(0, len(ra) - 1)]
            bd = tb[_i64(b.data).clamp(0, len(rb) - 1)]
            return ad, bd
        raise TypeError("comparison between string and non-string")
    ad, bd, _ = _align_numeric(a, b)
    return ad, bd


def _string_literal_of(v: Val) -> str | None:
    """If v is a single-value-dictionary scalar (a string literal), return it."""
    if v.dictionary is not None and len(v.dictionary) == 1 and v.data.ndim == 0:
        return v.dictionary.values[0]
    return None


def _dict_range_cmp(ctx, op: str, col: Val, lit: str):
    """Order comparison of a dictionary column against a string literal
    through the order-preserving code assignment: a code-range test."""
    d = col.dictionary
    codes = _codes(ctx, col)
    if op == "$lt":
        return codes < d.lower_bound(lit)
    if op == "$le":
        return codes < d.upper_bound(lit)
    if op == "$gt":
        return codes >= d.upper_bound(lit)
    if op == "$ge":
        return codes >= d.lower_bound(lit)
    raise ValueError(op)


def _cmp_long(op: str, a: Val, b: Val, valid) -> Val:
    """Comparison over two-limb long decimals (either side may be short)."""
    from trino_tpu_torch.types import int128 as i128

    s = max(_dec_scale(a.type) or 0, _dec_scale(b.type) or 0)
    ah, al = _to_planes(a, s)
    bh, bl = _to_planes(b, s)
    eq = i128.eq128(ah, al, bh, bl)
    lt = i128.lt128(ah, al, bh, bl)
    out = {
        "$eq": eq,
        "$ne": ~eq,
        "$lt": lt,
        "$le": lt | eq,
        "$gt": ~(lt | eq),
        "$ge": ~lt,
    }[op]
    return Val(out, valid, T.BOOLEAN)


_FLIP = {"$lt": "$gt", "$le": "$ge", "$gt": "$lt", "$ge": "$le"}


def _comparison(op: str, top):
    def handler(ctx, call, a, b):
        if a.lengths is not None or b.lengths is not None:
            # the JAX package fails on the shape here too
            raise NotImplementedError(f"comparison of {a.type.name} values")
        valid = _and_valid(a.valid, b.valid)
        if _is_long_dec(a.type) or _is_long_dec(b.type):
            return _cmp_long(op, a, b, valid)
        # string-vs-literal fast paths
        la, lb = _string_literal_of(a), _string_literal_of(b)
        if b.dictionary is not None and la is not None and lb is None:
            a, b, la, lb = b, a, lb, la
            cmp = _FLIP.get(op, op)
        else:
            cmp = op
        if a.dictionary is not None and lb is not None and la is None:
            if cmp in ("$eq", "$ne"):
                r = _codes(ctx, a) == a.dictionary.code_of(lb)
                return Val(r if cmp == "$eq" else ~r, valid, T.BOOLEAN)
            return Val(_dict_range_cmp(ctx, cmp, a, lb), valid, T.BOOLEAN)
        ad, bd = _cmp_operands(ctx, a, b)
        return Val(top(ad, bd), valid, T.BOOLEAN)

    return handler


FUNCTIONS["$eq"] = _comparison("$eq", torch.eq)
FUNCTIONS["$ne"] = _comparison("$ne", torch.ne)
FUNCTIONS["$lt"] = _comparison("$lt", torch.lt)
FUNCTIONS["$le"] = _comparison("$le", torch.le)
FUNCTIONS["$gt"] = _comparison("$gt", torch.gt)
FUNCTIONS["$ge"] = _comparison("$ge", torch.ge)


# ---------------------------------------------------------------------------
# math


def _unary_float(fn):
    def handler(ctx, call, a):
        return Val(fn(_to_float(a)), a.valid, T.DOUBLE)

    return handler


FUNCTIONS["sqrt"] = _unary_float(torch.sqrt)
FUNCTIONS["cbrt"] = _unary_float(lambda x: torch.sign(x) * x.abs().pow(1.0 / 3.0))
FUNCTIONS["exp"] = _unary_float(torch.exp)
FUNCTIONS["ln"] = _unary_float(torch.log)
FUNCTIONS["log10"] = _unary_float(torch.log10)
FUNCTIONS["log2"] = _unary_float(torch.log2)
FUNCTIONS["sin"] = _unary_float(torch.sin)
FUNCTIONS["cos"] = _unary_float(torch.cos)
FUNCTIONS["tan"] = _unary_float(torch.tan)
FUNCTIONS["degrees"] = _unary_float(torch.rad2deg)
FUNCTIONS["radians"] = _unary_float(torch.deg2rad)
FUNCTIONS["sign"] = lambda ctx, call, a: Val(torch.sign(a.data), a.valid, call.type)


@register("abs")
def _abs(ctx, call, a):
    if _is_long_dec(a.type):
        from trino_tpu_torch.types import int128 as i128

        h, l = _to_planes(a, a.type.scale)
        nh, nl = i128.neg128(h, l)
        neg = h < 0
        return _planes_val(
            torch.where(neg, nh, h), torch.where(neg, nl, l), call.type, a.valid
        )
    return Val(a.data.abs(), a.valid, call.type)


@register("power")
@register("pow")
def _power(ctx, call, a, b):
    return Val(
        torch.pow(_to_float(a), _to_float(b)), _and_valid(a.valid, b.valid), T.DOUBLE
    )


@register("mod")
def _mod_fn(ctx, call, a, b):
    return _mod(ctx, call, a, b)


def _floor_ceil_long(a: Val, out_t: T.Type, is_ceil: bool) -> Val:
    """floor/ceil of a long decimal to scale 0 over limb planes."""
    from trino_tpu_torch.types import int128 as i128

    h, l = _to_planes(a, a.type.scale)
    qh, ql, any_r = i128.truncdiv_pow10(h, l, a.type.scale)
    if is_ceil:
        adj = torch.logical_and(any_r, h >= 0).to(torch.int64)
    else:
        adj = -torch.logical_and(any_r, h < 0).to(torch.int64)
    qh, ql = i128.add128(qh, ql, adj >> 63, adj)
    if isinstance(out_t, T.DecimalType) and out_t.is_long:
        return _planes_val(qh, ql, out_t, a.valid)
    return Val(ql, a.valid, out_t)


def _floor_ceil(ctx, call, a, is_ceil: bool):
    if _is_long_dec(a.type):
        out_t = (
            call.type
            if isinstance(call.type, T.DecimalType)
            else T.DecimalType(max(a.type.precision - a.type.scale, 19), 0)
        )
        return _floor_ceil_long(a, out_t, is_ceil)
    if isinstance(a.type, T.DecimalType):
        # integer // is floor division: exactly SQL floor to scale 0
        d = _i64(a.data)
        d = -((-d) // a.type.scale_factor) if is_ceil else d // a.type.scale_factor
        return Val(d, a.valid, T.DecimalType(18, 0))
    if _is_float(a.type):
        f = _to_float(a)
        return Val(torch.ceil(f) if is_ceil else torch.floor(f), a.valid, T.DOUBLE)
    return a


@register("floor")
def _floor(ctx, call, a):
    return _floor_ceil(ctx, call, a, is_ceil=False)


@register("ceil")
@register("ceiling")
def _ceil(ctx, call, a):
    return _floor_ceil(ctx, call, a, is_ceil=True)


@register("round")
def _round(ctx, call, a, nd=None):
    digits = 0 if nd is None else int(nd.data)  # literal digits only
    out_t = call.type
    if _is_long_dec(a.type):
        from trino_tpu_torch.types import int128 as i128

        s = a.type.scale
        h, l = _to_planes(a, s)
        h, l = i128.rescale128(h, l, s, min(s, digits))  # round half away
        out_s = out_t.scale if isinstance(out_t, T.DecimalType) else digits
        h, l = i128.rescale128(h, l, min(s, digits), out_s)
        if isinstance(out_t, T.DecimalType) and out_t.is_long:
            return _planes_val(h, l, out_t, a.valid)
        if not isinstance(out_t, T.DecimalType):
            return _planes_val(h, l, T.DecimalType(19, out_s), a.valid)
        return Val(l, a.valid, out_t)
    if isinstance(a.type, T.DecimalType):
        s = a.type.scale
        out_s = out_t.scale if isinstance(out_t, T.DecimalType) else digits
        d = _rescale_decimal(_i64(a.data), s, min(s, digits))
        d = _rescale_decimal(d, min(s, digits), out_s)
        if not isinstance(out_t, T.DecimalType):
            out_t = T.DecimalType(18, out_s)
        return Val(d, a.valid, out_t)
    f = _to_float(a)
    m = 10.0**digits
    # SQL rounds half away from zero (torch.round is half to even)
    out = torch.sign(f) * torch.floor(f.abs() * m + 0.5) / m
    if out_t.name in ("bigint", "integer") and digits == 0:
        return Val(out.to(torch_dtype(out_t.np_dtype)), a.valid, out_t)
    return Val(out, a.valid, T.DOUBLE)


def _minmax(want_max: bool):
    top = torch.maximum if want_max else torch.minimum

    def handler(ctx, call, *vals):
        valid = None
        for v in vals:
            valid = _and_valid(valid, v.valid)
        if any(_is_long_dec(v.type) for v in vals):
            from trino_tpu_torch.types import int128 as i128

            s = max((_dec_scale(v.type) or 0) for v in vals)
            ah, al = _to_planes(vals[0], s)
            for v in vals[1:]:
                bh, bl = _to_planes(v, s)
                lt = i128.lt128(ah, al, bh, bl)
                take_b = lt if want_max else ~lt
                ah = torch.where(take_b, bh, ah)
                al = torch.where(take_b, bl, al)
            rt = call.type
            if isinstance(rt, T.DecimalType) and not rt.is_long:
                return Val(al, valid, rt)
            return _planes_val(ah, al, rt, valid)
        dicts = [v.dictionary for v in vals if v.dictionary is not None]
        if dicts:
            # recode every value into one union dictionary up front, so the
            # codes stay comparable and the result's dictionary fits its codes
            out_dict = dicts[0]
            for d in dicts[1:]:
                if d is not out_dict and d != out_dict:
                    out_dict = StringDictionary.from_unsorted(out_dict.values + d.values)
            datas = [ctx._recode(v, out_dict) for v in vals]
        else:
            out_dict = None
            datas = [_align_numeric(v, vals[0])[0] for v in vals]
        # one dtype for all operands, as array promotion gives (a 0-dim
        # tensor would otherwise take the column's narrower dtype)
        dt = datas[0].dtype
        for d in datas[1:]:
            dt = torch.promote_types(dt, d.dtype)
        acc = datas[0].to(dt)
        for d in datas[1:]:
            acc = top(acc, d.to(dt))
        return Val(acc, valid, call.type, out_dict)

    return handler


FUNCTIONS["greatest"] = _minmax(True)
FUNCTIONS["least"] = _minmax(False)


# ---------------------------------------------------------------------------
# dates (civil calendar math on day numbers; Howard Hinnant's algorithms).
# DATE values only: over TIMESTAMP and TIMESTAMP WITH TIME ZONE these
# functions raise until the timestamp family is ported.


def _civil_from_days(days):
    z = _i64(days) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _as_days(v: Val, what: str) -> torch.Tensor:
    if v.type is T.TIMESTAMP or v.type is T.TIMESTAMP_TZ:
        raise NotImplementedError(f"{what} over {v.type.name}: not ported yet")
    return _i64(v.data)


def _const(ctx, x: int) -> torch.Tensor:
    return ctx.tensor(x, torch.int64)


@register("year")
def _year(ctx, call, a):
    y, _, _ = _civil_from_days(_as_days(a, "year"))
    return Val(y, a.valid, T.BIGINT)


@register("month")
def _month(ctx, call, a):
    _, m, _ = _civil_from_days(_as_days(a, "month"))
    return Val(m, a.valid, T.BIGINT)


@register("day")
@register("day_of_month")
def _day(ctx, call, a):
    _, _, d = _civil_from_days(_as_days(a, "day"))
    return Val(d, a.valid, T.BIGINT)


@register("quarter")
def _quarter(ctx, call, a):
    _, m, _ = _civil_from_days(_as_days(a, "quarter"))
    return Val((m - 1) // 3 + 1, a.valid, T.BIGINT)


@register("day_of_week")
@register("dow")
def _dow(ctx, call, a):
    d = _as_days(a, "day_of_week")
    return Val((d + 3) % 7 + 1, a.valid, T.BIGINT)  # 1 = Monday .. 7 = Sunday


@register("day_of_year")
@register("doy")
def _doy(ctx, call, a):
    d = _as_days(a, "day_of_year")
    y, _, _ = _civil_from_days(d)
    jan1 = _days_from_civil(y, _const(ctx, 1), _const(ctx, 1))
    return Val(d - jan1 + 1, a.valid, T.BIGINT)


@register("date_add_days")
def _date_add_days(ctx, call, a, n):
    return Val(
        (_i64(a.data) + _i64(n.data)).to(torch.int32),
        _and_valid(a.valid, n.valid),
        T.DATE,
    )


def _add_months_days(ctx, days, k):
    """Day number + k months, the day clamped to the target month's last
    day (shared by date_add_months, date_add and date_diff)."""
    y, m, d = _civil_from_days(days)
    months = y * 12 + (m - 1) + k
    ny, nm = months // 12, months % 12 + 1
    one = _const(ctx, 1)
    last = _days_from_civil(
        torch.where(nm == 12, ny + 1, ny), torch.where(nm == 12, 1, nm + 1), one
    ) - _days_from_civil(ny, nm, one)
    return _days_from_civil(ny, nm, torch.minimum(d, last))


@register("date_add_months")
def _date_add_months(ctx, call, a, n):
    days = _add_months_days(ctx, _as_days(a, "date_add_months"), _i64(n.data))
    return Val(days, _and_valid(a.valid, n.valid), call.type)


@register("date_trunc_month")
def _date_trunc_month(ctx, call, a):
    y, m, _ = _civil_from_days(_as_days(a, "date_trunc_month"))
    return Val(_days_from_civil(y, m, _const(ctx, 1)), a.valid, T.DATE)


@register("date_trunc_year")
def _date_trunc_year(ctx, call, a):
    y, _, _ = _civil_from_days(_as_days(a, "date_trunc_year"))
    one = _const(ctx, 1)
    return Val(_days_from_civil(y, one, one), a.valid, T.DATE)


@register("date_trunc")
def _date_trunc(ctx, call, unit, v):
    """date_trunc(unit, date) (reference: scalar/DateTimeFunctions truncate
    family); a time unit leaves a DATE as it is."""
    u = _literal_str(unit, "date_trunc").lower()
    days = _as_days(v, "date_trunc")
    if u in ("second", "minute", "hour"):
        return Val(v.data, v.valid, call.type, v.dictionary)
    one = _const(ctx, 1)
    if u == "day":
        out = days
    elif u == "week":
        # ISO weeks start on Monday; 1970-01-01 was a Thursday
        out = days - (days + 3) % 7
    elif u in ("month", "year", "quarter"):
        y, m, _ = _civil_from_days(days)
        if u == "month":
            out = _days_from_civil(y, m, one)
        elif u == "quarter":
            out = _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        else:
            out = _days_from_civil(y, one, one)
    else:
        raise NotImplementedError(f"date_trunc unit {u!r}")
    return Val(out, v.valid, call.type)


_DAY_US = 86_400_000_000
_TIME_UNIT_US = {
    "millisecond": 1000,
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": _DAY_US,
    "week": 7 * _DAY_US,
}
_MONTH_UNITS = {"month": 1, "quarter": 3, "year": 12}


@register("date_add")
def _date_add_general(ctx, call, unit, n, v):
    """date_add(unit, value, date) (reference: DateTimeFunctions.addFieldValue*)."""
    u = _literal_str(unit, "date_add").lower().rstrip("s")
    k = _i64(n.data)
    valid = _and_valid(v.valid, n.valid)
    days = _as_days(v, "date_add")
    if u in _MONTH_UNITS:
        return Val(_add_months_days(ctx, days, k * _MONTH_UNITS[u]), valid, call.type)
    step = _TIME_UNIT_US.get(u)
    if step is None:
        raise NotImplementedError(f"date_add unit {u!r}")
    if step < _DAY_US:
        raise TypeError(f"date_add({u!r}) on a DATE value")
    return Val(days + k * (step // _DAY_US), valid, call.type)


@register("date_diff")
def _date_diff_general(ctx, call, unit, a, b):
    """date_diff(unit, from, to): complete units between two dates,
    truncated toward zero (reference: DateTimeFunctions.diffDate)."""
    u = _literal_str(unit, "date_diff").lower().rstrip("s")
    da = _as_days(a, "date_diff")
    db = _as_days(b, "date_diff")
    valid = _and_valid(a.valid, b.valid)
    if u in _MONTH_UNITS:
        ya, ma, _ = _civil_from_days(da)
        yb, mb, _ = _civil_from_days(db)
        months = (yb * 12 + mb) - (ya * 12 + ma)
        # the candidate count stands only if from + months <= to (sign
        # symmetric), so date_add and date_diff agree under month-end
        # clamping
        shifted = _add_months_days(ctx, da, months)
        months = (
            months
            - torch.logical_and(months > 0, shifted > db).to(torch.int64)
            + torch.logical_and(months < 0, shifted < db).to(torch.int64)
        )
        div = _MONTH_UNITS[u]
        out = torch.sign(months) * (months.abs() // div) if div > 1 else months
        return Val(out, valid, call.type)
    step = _TIME_UNIT_US.get(u)
    if step is None:
        raise NotImplementedError(f"date_diff unit {u!r}")
    diff = (db - da) * _DAY_US
    return Val(torch.sign(diff) * (diff.abs() // step), valid, call.type)


# ---------------------------------------------------------------------------
# strings (dictionary tables)


def _require_dict(v: Val, what: str) -> StringDictionary:
    if v.dictionary is None:
        raise TypeError(f"{what} requires a string (dictionary) value")
    return v.dictionary


def _literal_str(v: Val, what: str) -> str:
    s = _string_literal_of(v)
    if s is None:
        raise NotImplementedError(f"{what}: pattern/argument must be a literal")
    return s


def _dict_table(outs: list) -> tuple:
    """(dictionary of `outs`, int32 table: input code -> output code)."""
    nd = StringDictionary.from_unsorted(outs)
    ix = nd.index
    return nd, np.fromiter((ix[o] for o in outs), dtype=np.int32, count=len(outs))


def _prefix_match(codes: torch.Tensor, d: StringDictionary, prefix: str):
    lo, hi = d.prefix_range(prefix)
    codes = codes.to(torch.int32)
    return torch.logical_and(codes >= lo, codes < hi)


@register("like")
def _like(ctx, call, value, pattern, escape=None):
    d = _require_dict(value, "LIKE")
    pat = _literal_str(pattern, "LIKE")
    esc = _literal_str(escape, "LIKE escape") if escape is not None else None
    pfx = like_prefix(pat, esc)
    if pfx is not None:
        # a pure prefix pattern: a code range of the sorted dictionary
        return Val(_prefix_match(value.data, d, pfx), value.valid, T.BOOLEAN)
    rx = like_to_regex(pat, esc)
    table = d.predicate_table(lambda s: rx.match(s) is not None)
    return Val(take_table(table, value.data), value.valid, T.BOOLEAN)


@register("regexp_like")
def _regexp_like(ctx, call, value, pattern):
    """reference: operator/scalar/JoniRegexpFunctions.java regexpLike,
    evaluated once per dictionary entry and gathered by code."""
    import re

    d = _require_dict(value, "regexp_like")
    rx = re.compile(_literal_str(pattern, "regexp_like"))
    table = d.predicate_table(lambda s: rx.search(s) is not None)
    return Val(take_table(table, value.data), value.valid, T.BOOLEAN)


@register("regexp_extract")
def _regexp_extract(ctx, call, value, pattern, group=None):
    """regexp_extract(s, p[, group]); NULL where the pattern does not match."""
    import re

    d = _require_dict(value, "regexp_extract")
    rx = re.compile(_literal_str(pattern, "regexp_extract"))
    g = int(group.data) if group is not None else 0
    outs, hits = [], []
    for s in d.values:
        m = rx.search(s)
        outs.append("" if m is None else (m.group(g) or ""))
        hits.append(m is not None)
    nd, table = _dict_table(outs)
    hit = take_table(np.asarray(hits, dtype=bool), value.data)
    return Val(
        take_table(table, value.data), _and_valid(value.valid, hit), call.type, nd
    )


@register("regexp_replace")
def _regexp_replace(ctx, call, value, pattern, repl=None):
    import re

    rx = re.compile(_literal_str(pattern, "regexp_replace"))
    r = _literal_str(repl, "regexp_replace") if repl is not None else ""
    # SQL backreferences are $1; Python's re uses \1
    r = re.sub(r"\$(\d+)", r"\\\1", r)
    return _string_map(ctx, call, value, lambda s: rx.sub(r, s), "regexp_replace")


def _string_map(ctx, call, value: Val, fn, what: str) -> Val:
    """Map a Python string function over the dictionary: a new dictionary
    and a code table."""
    d = _require_dict(value, what)
    nd, table = _dict_table([fn(s) for s in d.values])
    return Val(take_table(table, value.data), value.valid, call.type, nd)


@register("substr")
@register("substring")
def _substr(ctx, call, value, start, length=None):
    s0 = int(start.data)
    ln = int(length.data) if length is not None else None

    def fn(s: str) -> str:
        # SQL substr is 1-based; start 0, a non-positive length, or a
        # negative start before the beginning all give '' (reference:
        # StringFunctions.java:280,327)
        if s0 == 0 or (ln is not None and ln <= 0):
            return ""
        if s0 > 0:
            begin = s0 - 1
        else:
            begin = len(s) + s0
            if begin < 0:
                return ""
        return s[begin : begin + ln] if ln is not None else s[begin:]

    return _string_map(ctx, call, value, fn, "substr")


@register("upper")
def _upper(ctx, call, value):
    return _string_map(ctx, call, value, str.upper, "upper")


@register("lower")
def _lower(ctx, call, value):
    return _string_map(ctx, call, value, str.lower, "lower")


def _trim_fn(name: str, method):
    def handler(ctx, call, value, chars=None):
        cs = _literal_str(chars, name) if chars is not None else None
        return _string_map(ctx, call, value, lambda s: method(s, cs), name)

    return handler


FUNCTIONS["trim"] = _trim_fn("trim", str.strip)
FUNCTIONS["ltrim"] = _trim_fn("ltrim", str.lstrip)
FUNCTIONS["rtrim"] = _trim_fn("rtrim", str.rstrip)


@register("reverse")
def _reverse(ctx, call, value):
    return _string_map(ctx, call, value, lambda s: s[::-1], "reverse")


@register("replace")
def _replace(ctx, call, value, find, repl=None):
    f = _literal_str(find, "replace")
    r = _literal_str(repl, "replace") if repl is not None else ""
    return _string_map(ctx, call, value, lambda s: s.replace(f, r), "replace")


@register("length")
def _length(ctx, call, value):
    d = _require_dict(value, "length")
    table = np.fromiter((len(s) for s in d.values), np.int64, len(d))
    return Val(take_table(table, value.data), value.valid, T.BIGINT)


@register("strpos")
@register("position")
def _strpos(ctx, call, value, sub):
    d = _require_dict(value, "strpos")
    s = _literal_str(sub, "strpos")
    table = np.fromiter((v.find(s) + 1 for v in d.values), np.int64, len(d))
    return Val(take_table(table, value.data), value.valid, T.BIGINT)


@register("starts_with")
def _starts_with(ctx, call, value, prefix):
    d = _require_dict(value, "starts_with")
    p = _literal_str(prefix, "starts_with")
    return Val(_prefix_match(value.data, d, p), value.valid, T.BOOLEAN)


@register("concat")
@register("$concat")
def _concat(ctx, call, *vals):
    # SQL: concat with any NULL argument is NULL
    if any(v.valid is False for v in vals):
        return Val(ctx.tensor(0, torch.int32), False, call.type)
    # at most two non-literal dictionary columns ('lit' || col || 'lit'
    # chains, and the bounded cross product of two columns)
    col_ix = [
        i
        for i, v in enumerate(vals)
        if v.dictionary is not None and _string_literal_of(v) is None
    ]
    valid = None
    for v in vals:
        valid = _and_valid(valid, v.valid)
    if not col_ix:
        s = "".join(_literal_str(v, "concat") for v in vals)
        return Val(ctx.tensor(0, torch.int32), None, call.type, StringDictionary([s]))
    if len(col_ix) > 2:
        raise NotImplementedError("concat of 3+ string columns")
    pre = "".join(_literal_str(v, "concat") for v in vals[: col_ix[0]])
    post = "".join(_literal_str(v, "concat") for v in vals[col_ix[-1] + 1 :])
    if len(col_ix) == 1:
        out = _string_map(ctx, call, vals[col_ix[0]], lambda s: pre + s + post, "concat")
        return Val(out.data, valid, call.type, out.dictionary)
    # two dictionary columns: the |da| x |db| pair dictionary is built once
    # on the host, and each row is one gather (reference role:
    # ConcatFunction, amortized over the dictionaries, not the rows)
    i0, i1 = col_ix
    a, b = vals[i0], vals[i1]
    da, db = a.dictionary, b.dictionary
    if len(da) * len(db) > (1 << 20):
        raise NotImplementedError(
            "concat of two string columns with dictionary product "
            f"{len(da)}x{len(db)} exceeds the materialization bound"
        )
    mid = "".join(_literal_str(v, "concat") for v in vals[i0 + 1 : i1])
    pairs = [pre + va + mid + vb + post for va in da.values for vb in db.values]
    merged, table = _dict_table(pairs)
    nb = len(db)
    flat = _i64(a.data).clamp(0, len(da) - 1) * nb + _i64(b.data).clamp(0, nb - 1)
    return Val(take_table(table, flat), valid, call.type, merged)


# ---------------------------------------------------------------------------
# casts


def _int_range_valid(valid, d, np_dtype):
    info = np.iinfo(np_dtype)
    return _and_valid(valid, torch.logical_and(d >= int(info.min), d <= int(info.max)))


def compile_cast(ctx: ExprCompiler, v: Val, to: T.Type) -> Val:
    """CAST (reference: the per-type cast operators).  Out-of-range values
    and varchar that does not parse become NULL, never wrap."""
    frm = v.type
    if frm == to or frm.name == to.name:
        return Val(v.data, v.valid, to, v.dictionary)
    if to == T.UNKNOWN:
        return v
    if T.is_string_kind(to):
        if v.dictionary is not None:
            return Val(v.data, v.valid, to, v.dictionary)
        # numeric/date -> varchar happens on the host: literals only
        if v.data.ndim == 0:
            return Val(
                ctx.tensor(0, torch.int32), v.valid, to,
                StringDictionary([_render_scalar(v)]),
            )
        raise NotImplementedError(f"cast {frm.name} -> varchar on columns")
    if T.is_string_kind(frm):
        return _cast_from_varchar(ctx, v, to)
    if isinstance(to, T.DecimalType):
        if to.is_long:
            if _is_float(frm):
                from trino_tpu_torch.types import int128 as i128

                f = _to_float(v) * to.scale_factor
                r = torch.sign(f) * torch.floor(f.abs() + 0.5)
                # an f64 carries 53 bits: past 2**53 the cast is lossy, as
                # the reference's double -> decimal is
                two64 = float(i128.TWO64)
                h = torch.floor(r / two64)
                lf = r - h * two64
                # lf is the UNSIGNED low limb in [0, 2**64): shift the values
                # with the top bit set into the signed range first
                lf = torch.where(lf >= float(1 << 63), lf - two64, lf)
                return _planes_val(h.to(torch.int64), lf.to(torch.int64), to, v.valid)
            return _planes_val(*_to_planes(v, to.scale), to, v.valid)
        if _is_long_dec(frm):
            # long -> short decimal: rescale in limbs, then take the low limb
            h, l = _to_planes(v, to.scale)
            fits = torch.logical_or(
                torch.logical_and(h == 0, l >= 0), torch.logical_and(h == -1, l < 0)
            )
            return Val(l, _and_valid(v.valid, fits), to)
        if isinstance(frm, T.DecimalType):
            # short -> short rescale, NULL when the value can overflow the
            # declared precision (checked before the upscale multiply)
            d = _i64(v.data)
            valid = v.valid
            delta = to.scale - frm.scale
            if delta >= 0:
                lim = (10**to.precision - 1) // (10**delta)
                if 10**frm.precision - 1 > lim:
                    valid = _and_valid(valid, torch.logical_and(d >= -lim, d <= lim))
                out = d * (10**delta)
            else:
                out = _rescale_decimal(d, frm.scale, to.scale)
                f = 10 ** (-delta)
                lim = 10**to.precision - 1
                if (10**frm.precision - 1 + f // 2) // f > lim:
                    valid = _and_valid(
                        valid, torch.logical_and(out >= -lim, out <= lim)
                    )
            return Val(out, valid, to)
        if _is_float(frm):
            f = _to_float(v) * to.scale_factor
            r = torch.sign(f) * torch.floor(f.abs() + 0.5)
            bound = float(min(10**to.precision, (1 << 63) - 1))
            fits = torch.logical_and(torch.logical_not(torch.isnan(f)), r.abs() < bound)
            return Val(r.to(torch.int64), _and_valid(v.valid, fits), to)
        # integer -> short decimal, checked before the scale multiply
        d = _i64(v.data)
        valid = v.valid
        digits = T.INT_DIGITS.get(frm.name)
        lim = (10**to.precision - 1) // to.scale_factor
        if digits is None or 10**digits - 1 > lim:
            valid = _and_valid(valid, torch.logical_and(d >= -lim, d <= lim))
        return Val(d * to.scale_factor, valid, to)
    if _is_long_dec(frm) and not (_is_float(to) or to.name in T.INT_DIGITS):
        raise NotImplementedError(f"cast {frm.name} -> {to.name}")
    if _is_float(to):
        return Val(_to_float(v).to(torch_dtype(to.np_dtype)), v.valid, to)
    if to.name in ("bigint", "integer", "smallint", "tinyint"):
        tdt = torch_dtype(to.np_dtype)
        if _is_long_dec(frm):
            h, l = _to_planes(v, 0)
            fits = torch.logical_or(
                torch.logical_and(h == 0, l >= 0), torch.logical_and(h == -1, l < 0)
            )
            valid = _and_valid(v.valid, fits)
            if to.name != "bigint":
                valid = _int_range_valid(valid, l, to.np_dtype)
            return Val(l.to(tdt), valid, to)
        if isinstance(frm, T.DecimalType):
            r = _rescale_decimal(_i64(v.data), frm.scale, 0)
            valid = v.valid
            if to.name != "bigint":
                valid = _int_range_valid(valid, r, to.np_dtype)
            return Val(r.to(tdt), valid, to)
        if _is_float(frm):
            f = _to_float(v)
            r = torch.sign(f) * torch.floor(f.abs() + 0.5)
            info = np.iinfo(to.np_dtype)
            fits = torch.logical_and(
                torch.logical_not(torch.isnan(f)),
                torch.logical_and(r >= float(int(info.min)), r <= float(int(info.max))),
            )
            return Val(r.to(tdt), _and_valid(v.valid, fits), to)
        if (
            not v.data.is_floating_point()
            and v.data.dtype != torch.bool
            and np.iinfo(to.np_dtype).bits < torch.iinfo(v.data.dtype).bits
        ):
            # narrowing integer cast: NULL on overflow, never wrap
            d = _i64(v.data)
            return Val(d.to(tdt), _int_range_valid(v.valid, d, to.np_dtype), to)
        return Val(v.data.to(tdt), v.valid, to)
    if to is T.BOOLEAN:
        return Val(v.data != 0, v.valid, to)
    if frm is T.BOOLEAN:
        return Val(v.data.to(torch_dtype(to.np_dtype)), v.valid, to)
    raise NotImplementedError(f"cast {frm.name} -> {to.name}: not ported yet")


def _cast_from_varchar(ctx, v: Val, to: T.Type) -> Val:
    """varchar -> numeric/decimal/date/boolean through a parse table over
    the dictionary (NULL where an entry does not parse)."""
    if to is T.TIMESTAMP or to is T.TIMESTAMP_TZ or to is T.TIME:
        raise NotImplementedError(f"cast {v.type.name} -> {to.name}: not ported yet")
    d = _require_dict(v, "cast from varchar")
    ok = np.ones(len(d), dtype=bool)
    if isinstance(to, T.DecimalType) and to.is_long:
        # the scaled value needs up to 128 bits: two int64 limb planes per
        # entry (types/int128.split_py), so a value past 18 digits is not
        # lost to an int64 overflow
        from trino_tpu_torch.types.int128 import split_py

        table = np.zeros((len(d), 2), dtype=np.int64)
        bound = 10**to.precision
        for i, s in enumerate(d.values):
            try:
                x = _parse_scalar(s, to)
                if not -bound < x < bound:
                    raise ValueError("out of decimal range")
                table[i, 0], table[i, 1] = split_py(x)
            except (ValueError, ArithmeticError):
                ok[i] = False
    else:
        table = np.zeros(len(d), dtype=to.np_dtype)
        for i, s in enumerate(d.values):
            try:
                table[i] = _parse_scalar(s, to)
            except (ValueError, ArithmeticError):
                ok[i] = False
    return Val(
        take_table(table, v.data), _and_valid(v.valid, take_table(ok, v.data)), to
    )


def _render_scalar(v: Val) -> str:
    if isinstance(v.type, T.DecimalType):
        x = int(v.data)
        s = v.type.scale
        if s == 0:
            return str(x)
        sign = "-" if x < 0 else ""
        x = abs(x)
        return f"{sign}{x // 10**s}.{x % 10**s:0{s}d}"
    # numpy's text of the literal's value, as the JAX package renders it
    return str(v.data.cpu().numpy()[()])


def _parse_scalar(s: str, to: T.Type):
    s = s.strip()
    if to.name in ("bigint", "integer", "smallint", "tinyint"):
        return int(s)
    if to.name in ("double", "real"):
        return float(s)
    if isinstance(to, T.DecimalType):
        from decimal import Context, Decimal

        c = Context(prec=60)
        return int(Decimal(s).scaleb(to.scale, context=c).to_integral_value(context=c))
    if to is T.DATE:
        import datetime

        y, m, d = map(int, s.split("-"))
        return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    if to is T.BOOLEAN:
        return s.lower() in ("true", "t", "1")
    raise ValueError(f"cannot parse {s!r} as {to.name}")


# ---------------------------------------------------------------------------
# MATCH_RECOGNIZE navigation (ops/pattern.py rewrites PREV/NEXT into these)


def _nav_shift(ctx: ExprCompiler, call: Call, v: Val, n: Val, pid: Val, step: int) -> Val:
    """`v` at the row `step * n` positions away within the same partition
    (`pid`, the partition id of each sorted row; dead slots hold -1), NULL
    past the partition's or the batch's edge."""
    k = int(n.data) * step
    cap = ctx.capacity
    data = torch.broadcast_to(v.data, (cap,) + tuple(v.data.shape[1:]))
    idx = torch.arange(cap, dtype=torch.int64, device=ctx.device) + k
    src = idx.clamp(0, cap - 1)
    inside = torch.logical_and(idx >= 0, idx < cap)
    same = torch.logical_and(inside, pid.data[src] == pid.data)
    valid = v.valid
    if isinstance(valid, torch.Tensor):
        valid = torch.broadcast_to(valid, (cap,))[src]
    return Val(data[src], _and_valid(valid, same), call.type, v.dictionary)


@register("$nav_prev")
def _nav_prev(ctx, call, v, n, pid):
    return _nav_shift(ctx, call, v, n, pid, -1)


@register("$nav_next")
def _nav_next(ctx, call, v, n, pid):
    return _nav_shift(ctx, call, v, n, pid, 1)


# array, JSON and map functions register into FUNCTIONS on import
from trino_tpu_torch.expr import arrays as _arrays  # noqa: E402,F401
from trino_tpu_torch.expr import maps as _maps  # noqa: E402,F401

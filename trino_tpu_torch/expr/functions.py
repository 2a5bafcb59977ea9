"""Scalar function library (reference: operator/scalar/* plus the per-type
operators in type/*Operators.java).

Port of trino_tpu/expr/functions.py, the whole of it: short- and
long-decimal arithmetic (division and modulus over int128 limbs, rounded
half away from zero), comparisons (numeric, temporal and dictionary-coded
strings), the numeric and math functions, the bitwise family, the civil
calendar over DATE, TIMESTAMP and TIMESTAMP WITH TIME ZONE values, time of
day and time zones, the dictionary string functions (LIKE, the regexp
family, substr, the case/trim/replace/pad/translate maps, split_part, the
url family, length, strpos, levenshtein_distance, concat), concat_ws and
format, and the cast family.  String functions evaluate over the
dictionary on the host and gather a table by code on the device; every
gather clamps its codes first, as the JAX package's ``take(mode="clip")``
does, so a NULL row's code may be anything.  concat_ws and format render
each row on the host.  The array, JSON and lambda functions live in
expr/arrays.py and the map functions in expr/maps.py; both register here
when this module loads.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.columnar.column import take_table, torch_dtype
from trino_tpu_torch.expr.compiler import ExprCompiler, Val, _and_valid
from trino_tpu_torch.expr.ir import Call, InputRef
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
        raise NotImplementedError(f"scalar function not implemented: {call.name}")
    # lambda arguments pass through unevaluated: the handler binds their
    # parameters over array elements and evaluates the body itself
    if call.name == "typeof" and isinstance(call.args[0], InputRef):
        # the argument's type is static: its values are never read (an
        # array column stored without its lengths still answers)
        return fn(ctx, call, Val(None, None, call.args[0].type))
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
# dates and timestamps (civil calendar math on day numbers; Howard Hinnant's
# algorithms).  A DATE is int32 days, a TIMESTAMP int64 micros, a TIME int64
# micros since midnight and a TIMESTAMP WITH TIME ZONE the packed
# utc_millis * 4096 + (offset minutes + 2048).  Every division and remainder
# below floors (torch's // and % on integer tensors), so values before 1970
# land in the right day.


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


_DAY_US = 86_400_000_000


def _tz_local_micros(v: Val) -> torch.Tensor:
    """Wall-clock micros in the value's own zone (packed tz layout)."""
    p = _i64(v.data)
    return (T.unpack_tz_millis(p) + T.unpack_tz_offset(p) * 60_000) * 1000


def _as_days(v: Val) -> torch.Tensor:
    if v.type is T.TIMESTAMP:
        return _i64(v.data) // _DAY_US
    if v.type is T.TIMESTAMP_TZ:
        return _tz_local_micros(v) // _DAY_US
    return _i64(v.data)


def _day_micros(v: Val) -> torch.Tensor:
    """Micros since local midnight of a time, timestamp or timestamptz."""
    us = _tz_local_micros(v) if v.type is T.TIMESTAMP_TZ else _i64(v.data)
    return us % _DAY_US


def _const(ctx, x: int) -> torch.Tensor:
    return ctx.tensor(x, torch.int64)


@register("year")
def _year(ctx, call, a):
    y, _, _ = _civil_from_days(_as_days(a))
    return Val(y, a.valid, T.BIGINT)


@register("month")
def _month(ctx, call, a):
    _, m, _ = _civil_from_days(_as_days(a))
    return Val(m, a.valid, T.BIGINT)


@register("day")
@register("day_of_month")
def _day(ctx, call, a):
    _, _, d = _civil_from_days(_as_days(a))
    return Val(d, a.valid, T.BIGINT)


@register("quarter")
def _quarter(ctx, call, a):
    _, m, _ = _civil_from_days(_as_days(a))
    return Val((m - 1) // 3 + 1, a.valid, T.BIGINT)


@register("day_of_week")
@register("dow")
def _dow(ctx, call, a):
    d = _as_days(a)
    return Val((d + 3) % 7 + 1, a.valid, T.BIGINT)  # 1 = Monday .. 7 = Sunday


@register("day_of_year")
@register("doy")
def _doy(ctx, call, a):
    d = _as_days(a)
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


def _temporal_micros(v: Val):
    """(local micros, kind) of a date, timestamp or timestamptz value;
    kind is 'date', 'ts' or 'tz'."""
    if v.type is T.TIMESTAMP_TZ:
        return _tz_local_micros(v), "tz"
    if v.type is T.TIMESTAMP:
        return _i64(v.data), "ts"
    return _i64(v.data) * _DAY_US, "date"


def _temporal_pack(us, kind: str, v: Val):
    """Local micros back to the value's representation (a timestamptz
    keeps its zone offset)."""
    if kind == "tz":
        off = T.unpack_tz_offset(_i64(v.data))
        return T.pack_tz(us // 1000 - off * 60_000, off)
    if kind == "ts":
        return us
    return us // _DAY_US


def _add_months(ctx, v: Val, k, valid, rt) -> Val:
    """v + k months, keeping the time of day (month-end clamping)."""
    us, kind = _temporal_micros(v)
    days = _add_months_days(ctx, us // _DAY_US, k)
    return Val(_temporal_pack(days * _DAY_US + us % _DAY_US, kind, v), valid, rt)


@register("date_add_months")
def _date_add_months(ctx, call, a, n):
    return _add_months(ctx, a, _i64(n.data), _and_valid(a.valid, n.valid), call.type)


@register("date_trunc_month")
def _date_trunc_month(ctx, call, a):
    y, m, _ = _civil_from_days(_as_days(a))
    return Val(_days_from_civil(y, m, _const(ctx, 1)), a.valid, T.DATE)


@register("date_trunc_year")
def _date_trunc_year(ctx, call, a):
    y, _, _ = _civil_from_days(_as_days(a))
    one = _const(ctx, 1)
    return Val(_days_from_civil(y, one, one), a.valid, T.DATE)


_TIME_UNIT_US = {
    "millisecond": 1000,
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": _DAY_US,
    "week": 7 * _DAY_US,
}
_MONTH_UNITS = {"month": 1, "quarter": 3, "year": 12}


@register("date_trunc")
def _date_trunc(ctx, call, unit, v):
    """date_trunc(unit, date | timestamp | timestamptz), keeping the input
    type (reference: scalar/DateTimeFunctions truncate family); a time unit
    leaves a DATE as it is."""
    u = _literal_str(unit, "date_trunc").lower()
    us, kind = _temporal_micros(v)
    if u in ("second", "minute", "hour"):
        if kind == "date":
            return Val(v.data, v.valid, call.type, v.dictionary)
        step = _TIME_UNIT_US[u]
        return Val(_temporal_pack((us // step) * step, kind, v), v.valid, call.type)
    days = us // _DAY_US
    one = _const(ctx, 1)
    if u == "day":
        out = days
    elif u == "week":
        # ISO weeks start on Monday; 1970-01-01 was a Thursday
        out = days - (days + 3) % 7
    elif u in _MONTH_UNITS:
        y, m, _ = _civil_from_days(days)
        if u == "month":
            out = _days_from_civil(y, m, one)
        elif u == "quarter":
            out = _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        else:
            out = _days_from_civil(y, one, one)
    else:
        raise NotImplementedError(f"date_trunc unit {u!r}")
    return Val(_temporal_pack(out * _DAY_US, kind, v), v.valid, call.type)


@register("date_add")
def _date_add_general(ctx, call, unit, n, v):
    """date_add(unit, value, date | timestamp | timestamptz) (reference:
    DateTimeFunctions.addFieldValue*)."""
    u = _literal_str(unit, "date_add").lower().rstrip("s")
    k = _i64(n.data)
    valid = _and_valid(v.valid, n.valid)
    if u in _MONTH_UNITS:
        return _add_months(ctx, v, k * _MONTH_UNITS[u], valid, call.type)
    step = _TIME_UNIT_US.get(u)
    if step is None:
        raise NotImplementedError(f"date_add unit {u!r}")
    us, kind = _temporal_micros(v)
    if kind == "date" and step < _DAY_US:
        raise TypeError(f"date_add({u!r}) on a DATE value")
    return Val(_temporal_pack(us + k * step, kind, v), valid, call.type)


@register("date_diff")
def _date_diff_general(ctx, call, unit, a, b):
    """date_diff(unit, from, to): complete units between the two local
    times, truncated toward zero (reference: DateTimeFunctions.diffDate and
    diffTimestamp; a partial trailing unit does not count)."""
    u = _literal_str(unit, "date_diff").lower().rstrip("s")
    va, _ = _temporal_micros(a)
    vb, _ = _temporal_micros(b)
    valid = _and_valid(a.valid, b.valid)
    if u in _MONTH_UNITS:
        da, db = va // _DAY_US, vb // _DAY_US
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
    diff = vb - va
    # truncated toward zero: -30 minutes is 0 complete hours, not -1
    return Val(torch.sign(diff) * (diff.abs() // step), valid, call.type)


# ---------------------------------------------------------------------------
# time of day and timestamp with time zone (reference:
# operator/scalar/DateTimeFunctions.java and the SPI's DateTimeEncoding)


@register("hour")
def _hour(ctx, call, a):
    return Val(_day_micros(a) // 3_600_000_000, a.valid, T.BIGINT)


@register("minute")
def _minute(ctx, call, a):
    return Val(_day_micros(a) // 60_000_000 % 60, a.valid, T.BIGINT)


@register("second")
def _second(ctx, call, a):
    return Val(_day_micros(a) // 1_000_000 % 60, a.valid, T.BIGINT)


@register("millisecond")
def _millisecond(ctx, call, a):
    return Val(_day_micros(a) // 1000 % 1000, a.valid, T.BIGINT)


@register("$tz_instant")
def _tz_instant(ctx, call, a):
    """Packed tz -> the UTC instant's micros (a TIMESTAMP in the UTC session
    zone): comparisons and ORDER BY over timestamptz go through it."""
    return Val(T.unpack_tz_millis(_i64(a.data)) * 1000, a.valid, T.TIMESTAMP)


def _zone_offset_of(zone: Val, what: str) -> int:
    """Minutes east of UTC of a literal zone: a fixed offset exactly, a
    named zone at the offset in force now (types.zone_offset_minutes)."""
    return T.zone_offset_minutes(_literal_str(zone, what))


@register("at_timezone")
def _at_timezone(ctx, call, v, zone):
    """`v AT TIME ZONE z`: the same instant, shown in zone z (reference:
    scalar/AtTimeZone.java)."""
    off = _zone_offset_of(zone, "AT TIME ZONE")
    if v.type is T.TIMESTAMP_TZ:
        millis = T.unpack_tz_millis(_i64(v.data))
    elif v.type is T.TIMESTAMP:
        # the session zone is UTC: the local timestamp is the instant
        millis = _i64(v.data) // 1000
    elif v.type is T.DATE:
        millis = _i64(v.data) * 86_400_000
    else:
        raise TypeError(f"AT TIME ZONE on {v.type.name}")
    return Val(T.pack_tz(millis, off), v.valid, T.TIMESTAMP_TZ)


@register("with_timezone")
def _with_timezone(ctx, call, v, zone):
    """with_timezone(timestamp, zone): the wall time v read in zone z
    (reference: scalar/WithTimeZone.java)."""
    off = _zone_offset_of(zone, "with_timezone")
    utc = _i64(v.data) // 1000 - off * 60_000
    return Val(T.pack_tz(utc, off), v.valid, T.TIMESTAMP_TZ)


@register("$tz_add_micros")
def _tz_add_micros(ctx, call, v, delta):
    """timestamptz + a day-to-second interval: the UTC instant moves, the
    zone offset stays (reference: DateTimeOperators tz + interval)."""
    p = _i64(v.data)
    millis = T.unpack_tz_millis(p) + _i64(delta.data) // 1000
    return Val(
        millis * T.TZ_SHIFT + p % T.TZ_SHIFT,
        _and_valid(v.valid, delta.valid),
        T.TIMESTAMP_TZ,
    )


_TWO63 = 9223372036854775808.0  # 2**63, the first double past INT64_MAX


def _saturating_i64(f: torch.Tensor) -> torch.Tensor:
    """f64 -> int64 truncated toward zero, NaN to 0 and out-of-range values
    saturated: XLA's float-to-int conversion, which the JAX package's
    from_unixtime takes.  A CUDA or C++ cast of NaN or of an out-of-range
    value is undefined, so every such value is replaced before the cast."""
    ok = torch.logical_not(torch.isnan(f))
    # the largest double below 2**63 converts exactly
    fc = torch.where(ok, f, 0.0).clamp(-_TWO63, _TWO63 - 1024.0)
    return torch.where(f >= _TWO63, torch.iinfo(torch.int64).max, fc.to(torch.int64))


def _unix_millis(v: Val) -> torch.Tensor:
    """Seconds since the epoch -> whole milliseconds, truncated toward
    zero.  A decimal converts exactly from its scaled integer (the JAX
    package reads a short decimal's scaled integer as seconds and fails on
    a long decimal's limb planes; ROADMAP lists the difference)."""
    t = v.type
    if isinstance(t, T.DecimalType):
        from trino_tpu_torch.types import int128 as i128

        if t.scale <= 3:
            h, l = i128.rescale128(*_to_planes(v, t.scale), t.scale, 3)
        else:
            h, l, _ = i128.truncdiv_pow10(*_to_planes(v, t.scale), t.scale - 3)
        return l
    return _saturating_i64(v.data.to(torch.float64) * 1000.0)


@register("from_unixtime")
def _from_unixtime(ctx, call, secs, zone=None):
    off = _zone_offset_of(zone, "from_unixtime") if zone is not None else 0
    millis = _unix_millis(secs)
    if call.type is T.TIMESTAMP:
        return Val(millis * 1000, secs.valid, T.TIMESTAMP)
    return Val(T.pack_tz(millis, off), secs.valid, T.TIMESTAMP_TZ)


@register("to_unixtime")
def _to_unixtime(ctx, call, v):
    if v.type is T.TIMESTAMP_TZ:
        millis = T.unpack_tz_millis(_i64(v.data))
        return Val(millis.to(torch.float64) / 1000.0, v.valid, T.DOUBLE)
    return Val(v.data.to(torch.float64) / 1_000_000.0, v.valid, T.DOUBLE)


@register("timezone_minute")
def _timezone_minute(ctx, call, v):
    off = T.unpack_tz_offset(_i64(v.data))
    return Val(torch.sign(off) * (off.abs() % 60), v.valid, T.BIGINT)


@register("timezone_hour")
def _timezone_hour(ctx, call, v):
    off = T.unpack_tz_offset(_i64(v.data))
    # truncated toward zero: -03:30 is hour -3, minute -30
    return Val(
        off // 60 + torch.logical_and(off < 0, off % 60 != 0).to(torch.int64),
        v.valid,
        T.BIGINT,
    )


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


#: (function, dictionary entries, host seconds) of each table built over a
#: dictionary (not of the ones found kept); read and cleared by callers
#: that time this host work; bounded
HOST_TABLE_LOG: deque = deque(maxlen=4096)

#: the string functions' tables by (function, its literal arguments, the
#: dictionary's values).  The port evaluates each batch eagerly, where the
#: JAX package builds a table once a trace; every batch of a column carries
#: an equal dictionary, so the table is built once
_HOST_TABLES: "OrderedDict" = OrderedDict()
_HOST_TABLES_LIMIT = 32
_HOST_TABLES_LOCK = threading.Lock()


def _host_table(what: str, args: tuple, d: StringDictionary, build):
    """`build(d)`, kept under (what, args, d).  The cache is shared by the
    dispatcher's lanes, so it is read and written under a lock."""
    key = (what, args, d)
    with _HOST_TABLES_LOCK:
        hit = _HOST_TABLES.get(key)
        if hit is not None:
            _HOST_TABLES.move_to_end(key)
            return hit
    t0 = time.perf_counter()
    out = build(d)
    HOST_TABLE_LOG.append((what, len(d), time.perf_counter() - t0))
    with _HOST_TABLES_LOCK:
        _HOST_TABLES[key] = out
        while len(_HOST_TABLES) > _HOST_TABLES_LIMIT:
            _HOST_TABLES.popitem(last=False)
    return out


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
    return _string_map(
        ctx, call, value, lambda s: rx.sub(r, s), "regexp_replace", (rx.pattern, r)
    )


def _string_map(ctx, call, value: Val, fn, what: str, args: tuple) -> Val:
    """Map a Python string function over the dictionary: a new dictionary
    and a code table, kept under (what, args) (`args` are the literal
    arguments that, with `what`, define `fn`)."""
    d = _require_dict(value, what)
    nd, table = _host_table(what, args, d, lambda d: _dict_table([fn(s) for s in d.values]))
    return Val(take_table(table, value.data), value.valid, call.type, nd)


def _int_table(value: Val, what: str, args: tuple, build) -> torch.Tensor:
    """An int64 table over the dictionary (`build(d)`), kept as
    `_string_map`'s are, gathered by code."""
    d = _require_dict(value, what)
    return take_table(_host_table(what, args, d, build), value.data)


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

    return _string_map(ctx, call, value, fn, "substr", (s0, ln))


@register("upper")
def _upper(ctx, call, value):
    return _string_map(ctx, call, value, str.upper, "upper", ())


@register("lower")
def _lower(ctx, call, value):
    return _string_map(ctx, call, value, str.lower, "lower", ())


def _trim_fn(name: str, method):
    def handler(ctx, call, value, chars=None):
        cs = _literal_str(chars, name) if chars is not None else None
        return _string_map(ctx, call, value, lambda s: method(s, cs), name, (cs,))

    return handler


FUNCTIONS["trim"] = _trim_fn("trim", str.strip)
FUNCTIONS["ltrim"] = _trim_fn("ltrim", str.lstrip)
FUNCTIONS["rtrim"] = _trim_fn("rtrim", str.rstrip)


@register("reverse")
def _reverse(ctx, call, value):
    return _string_map(ctx, call, value, lambda s: s[::-1], "reverse", ())


@register("replace")
def _replace(ctx, call, value, find, repl=None):
    f = _literal_str(find, "replace")
    r = _literal_str(repl, "replace") if repl is not None else ""
    return _string_map(ctx, call, value, lambda s: s.replace(f, r), "replace", (f, r))


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
        out = _string_map(
            ctx, call, vals[col_ix[0]], lambda s: pre + s + post, "concat", (pre, post)
        )
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


@register("hamming_distance")
def _unsupported(ctx, call, *vals):
    raise NotImplementedError(call.name)


# ---------------------------------------------------------------------------
# string breadth (reference: operator/scalar/StringFunctions.java,
# SplitPart, PadFunctions, TranslateFunction, UrlFunctions.java)


@register("split_part")
def _split_part(ctx, call, value, delim, index):
    dl = _literal_str(delim, "split_part")
    ix = int(index.data)

    def fn(s: str) -> str:
        if ix < 1:
            return ""
        parts = s.split(dl) if dl else [s]
        return parts[ix - 1] if ix <= len(parts) else ""

    return _string_map(ctx, call, value, fn, "split_part", (dl, ix))


def _pad(name: str, left: bool):
    def handler(ctx, call, value, size, pad=None):
        n = int(size.data)
        p = _literal_str(pad, name) if pad is not None else " "

        def fn(s: str) -> str:
            if len(s) >= n:
                return s[:n]
            fill = (p * n)[: n - len(s)] if p else ""
            return fill + s if left else s + fill

        return _string_map(ctx, call, value, fn, name, (n, p))

    return handler


FUNCTIONS["lpad"] = _pad("lpad", left=True)
FUNCTIONS["rpad"] = _pad("rpad", left=False)


@register("translate")
def _translate(ctx, call, value, frm, to):
    f = _literal_str(frm, "translate")
    t = _literal_str(to, "translate")
    table = {}
    for i, ch in enumerate(f):
        if ord(ch) not in table:  # the first occurrence wins (TranslateFunction)
            table[ord(ch)] = t[i] if i < len(t) else None
    return _string_map(
        ctx, call, value, lambda s: s.translate(table), "translate", (f, t)
    )


@register("codepoint")
def _codepoint(ctx, call, value):
    out = _int_table(
        value, "codepoint", (),
        lambda d: np.fromiter((ord(s[0]) if s else 0 for s in d.values), np.int64, len(d)),
    )
    return Val(out, value.valid, call.type)


@register("chr")
def _chr(ctx, call, value):
    # literal only: a column of code points would need a data-dependent
    # dictionary, which the JAX package's trace-time compilation cannot build
    if value.data.ndim != 0:
        raise NotImplementedError("chr() supports only literal arguments")
    d = StringDictionary([chr(int(value.data))])
    return Val(ctx.tensor(0, torch.int32), value.valid, call.type, d)


@register("normalize")
def _normalize(ctx, call, value, form=None):
    import unicodedata

    f = _literal_str(form, "normalize") if form is not None else "NFC"
    return _string_map(
        ctx, call, value, lambda s: unicodedata.normalize(f, s), "normalize", (f,)
    )


def _levenshtein(a: str, b: str) -> int:
    """Edit distance, the row-by-row dynamic program."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


@register("levenshtein_distance")
def _levenshtein_distance(ctx, call, value, target):
    t = _literal_str(target, "levenshtein_distance")
    out = _int_table(
        value, "levenshtein_distance", (t,),
        lambda d: np.fromiter((_levenshtein(s, t) for s in d.values), np.int64, len(d)),
    )
    return Val(out, value.valid, call.type)


def _url_part(part: str):
    from urllib.parse import urlparse

    def get(s: str) -> str:
        try:
            u = urlparse(s)
            if part == "host":
                return u.hostname or ""
            if part == "protocol":
                return u.scheme or ""
            if part == "path":
                return u.path or ""
            if part == "query":
                return u.query or ""
            if part == "fragment":
                return u.fragment or ""
            if part == "port":
                return str(u.port) if u.port is not None else ""
        except ValueError:
            return ""
        return ""

    return get


def _url_extract(part: str):
    name = f"url_extract_{part}"

    def handler(ctx, call, value):
        get = _url_part(part)
        if part != "port":
            return _string_map(ctx, call, value, get, name, ())
        out = _int_table(
            value, name, (),
            lambda d: np.fromiter(
                ((int(p) if p else -1) for p in map(get, d.values)), np.int64, len(d)
            ),
        )
        # no port -> NULL
        return Val(out, _and_valid(value.valid, out >= 0), call.type)

    return handler


for _part in ("host", "protocol", "path", "query", "fragment", "port"):
    FUNCTIONS[f"url_extract_{_part}"] = _url_extract(_part)


@register("url_encode")
def _url_encode(ctx, call, value):
    from urllib.parse import quote_plus

    return _string_map(ctx, call, value, quote_plus, "url_encode", ())


@register("url_decode")
def _url_decode(ctx, call, value):
    from urllib.parse import unquote_plus

    return _string_map(ctx, call, value, unquote_plus, "url_decode", ())


# ---------------------------------------------------------------------------
# math breadth (reference: operator/scalar/MathFunctions.java)


def _unary_math(fn):
    def handler(ctx, call, v):
        return Val(fn(_to_float(v)), v.valid, call.type)

    return handler


FUNCTIONS["asin"] = _unary_math(torch.asin)
FUNCTIONS["acos"] = _unary_math(torch.acos)
FUNCTIONS["atan"] = _unary_math(torch.atan)
FUNCTIONS["sinh"] = _unary_math(torch.sinh)
FUNCTIONS["cosh"] = _unary_math(torch.cosh)
FUNCTIONS["tanh"] = _unary_math(torch.tanh)
# truncated toward zero
FUNCTIONS["truncate"] = _unary_math(lambda f: torch.sign(f) * torch.floor(f.abs()))
FUNCTIONS["is_nan"] = _unary_math(torch.isnan)
FUNCTIONS["is_finite"] = _unary_math(torch.isfinite)
FUNCTIONS["is_infinite"] = _unary_math(torch.isinf)


@register("atan2")
def _atan2(ctx, call, y, x):
    return Val(
        torch.atan2(_to_float(y), _to_float(x)), _and_valid(y.valid, x.valid), call.type
    )


@register("log")
def _log(ctx, call, base, x):
    # ln x / ln b, as the JAX package computes it (not through log2/log10)
    return Val(
        torch.log(_to_float(x)) / torch.log(_to_float(base)),
        _and_valid(base.valid, x.valid),
        call.type,
    )


def _double_constant(value: float):
    return lambda ctx, call: Val(ctx.tensor(value, torch.float64), None, call.type)


FUNCTIONS["e"] = _double_constant(np.e)
FUNCTIONS["pi"] = _double_constant(np.pi)
FUNCTIONS["nan"] = _double_constant(np.nan)
FUNCTIONS["infinity"] = _double_constant(np.inf)


@register("width_bucket")
def _width_bucket(ctx, call, v, lo, hi, n):
    """width_bucket(x, lo, hi, n): 0 below the range, n + 1 above it; equal
    bounds or a bucket count below 1 give NULL (the reference raises; an
    error is not expressible row by row).  A NaN operand gives 0, as the
    JAX package's float-to-int conversion of NaN does."""
    x, a, b = _to_float(v), _to_float(lo), _to_float(hi)
    k = n.data.to(torch.float64)
    ok = torch.logical_and(b != a, k > 0)
    raw = torch.floor((x - a) / torch.where(ok, b - a, 1.0) * k) + 1
    # maximum and minimum carry a NaN through, as jnp.clip does
    out = torch.minimum(torch.maximum(torch.where(ok, raw, 0.0), torch.zeros_like(k)),
                        k.clamp(min=0) + 1)
    out = _saturating_i64(out)
    valid = _and_valid(_and_valid(v.valid, lo.valid), _and_valid(hi.valid, n.valid))
    return Val(out, _and_valid(valid, ok), call.type)


# ---------------------------------------------------------------------------
# bitwise (reference: operator/scalar/BitwiseFunctions.java)


def _shift_left(a, b):
    # a shift by a negative amount or by 64 or more is 0, as in XLA (C++ and
    # CUDA leave it undefined): the amount is clamped before the shift
    out = a << b.clamp(0, 63)
    return torch.where(torch.logical_or(b < 0, b > 63), 0, out)


def _shift_right_arithmetic(a, b):
    # past the width the sign fills every bit (XLA); clamped as above
    out = a >> b.clamp(0, 63)
    return torch.where(torch.logical_or(b < 0, b > 63), torch.where(a < 0, -1, 0), out)


def _binary_bitwise(fn):
    def handler(ctx, call, a, b):
        return Val(fn(_i64(a.data), _i64(b.data)), _and_valid(a.valid, b.valid), call.type)

    return handler


FUNCTIONS["bitwise_and"] = _binary_bitwise(torch.bitwise_and)
FUNCTIONS["bitwise_or"] = _binary_bitwise(torch.bitwise_or)
FUNCTIONS["bitwise_xor"] = _binary_bitwise(torch.bitwise_xor)
FUNCTIONS["bitwise_left_shift"] = _binary_bitwise(_shift_left)
FUNCTIONS["bitwise_right_shift_arithmetic"] = _binary_bitwise(_shift_right_arithmetic)


@register("bitwise_not")
def _bitwise_not(ctx, call, a):
    return Val(torch.bitwise_not(_i64(a.data)), a.valid, call.type)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64's 64-bit pattern (SWAR; torch has neither
    uint64 arithmetic nor a popcount).  >> is arithmetic, so every shift is
    masked before its bits are summed; the subtraction, addition and
    multiplication wrap modulo 2**64 as unsigned ones would."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + ((x >> 4) & 0x0F0F0F0F0F0F0F0F)) & 0x0F0F0F0F0F0F0F0F
    return ((x * 0x0101010101010101) >> 56) & 0xFF


@register("bit_count")
def _bit_count(ctx, call, a, bits=None):
    x = _i64(a.data)
    if bits is not None:
        nb = int(bits.data)
        if nb < 64:
            x = x & ((1 << nb) - 1)
    return Val(_popcount64(x), a.valid, call.type)


@register("typeof")
def _typeof(ctx, call, v):
    d = StringDictionary([v.type.name])
    return Val(ctx.tensor(0, torch.int32), None, call.type, d)


@register("version")
def _version(ctx, call):
    d = StringDictionary(["trino-tpu 0.4"])
    return Val(ctx.tensor(0, torch.int32), None, call.type, d)


# ---------------------------------------------------------------------------
# concat_ws and format: rendered on the host, row by row (the JAX package
# runs a projection that holds either outside its jitted program, through
# EAGER_FUNCS; the port evaluates every expression eagerly and needs no such
# set)

#: (function, rows, host seconds) of each row render; read and cleared by
#: callers that time this host work; bounded
ROW_RENDER_LOG: deque = deque(maxlen=4096)


def _render_tz(millis: int, offset_minutes: int) -> str:
    """A packed timestamptz as local-time text with its offset."""
    import datetime

    dt = datetime.datetime(1970, 1, 1) + datetime.timedelta(
        milliseconds=millis + offset_minutes * 60_000
    )
    sign = "+" if offset_minutes >= 0 else "-"
    om = abs(offset_minutes)
    return f"{dt.isoformat(sep=' ')} {sign}{om // 60:02d}:{om % 60:02d}"


def _host_rows(ctx, v: Val):
    """(data, valid) of a value broadcast to the batch's rows, on the host."""
    cap = ctx.capacity
    d = torch.broadcast_to(v.data, (cap,)).cpu().numpy()
    if v.valid is None:
        return d, np.ones(cap, dtype=bool)
    return d, torch.broadcast_to(v.valid, (cap,)).cpu().numpy()


def _rendered_val(ctx, call, outs: list, valid: np.ndarray) -> Val:
    nd = StringDictionary.from_unsorted(outs)
    codes = ctx.tensor(np.asarray(nd.encode(outs), np.int32), torch.int32)
    return Val(
        codes, None if valid.all() else ctx.tensor(valid, torch.bool), call.type, nd
    )


@register("concat_ws")
def _concat_ws(ctx, call, sep, *parts):
    """concat_ws(sep, v1, ..., vn) over three or more values, rendered per
    row on the host (reference: operator/scalar/ConcatWsFunction.java: NULL
    values are skipped, a NULL separator gives NULL).  The analyzer
    rewrites two or fewer values into compiled IF/concat forms, which never
    reach here."""
    t0 = time.perf_counter()
    cap = ctx.capacity

    def strings_of(v: Val) -> list:
        if v.is_literal_null:
            return [None] * cap
        d, va = _host_rows(ctx, v)
        vals = v.dictionary.values if v.dictionary is not None else None
        out = []
        for i in range(cap):
            if not va[i]:
                out.append(None)
            elif vals is not None:
                c = int(d[i])
                out.append(vals[c] if 0 <= c < len(vals) else "")
            else:
                out.append(str(d[i]))  # numpy's text of the value
        return out

    sep_s = strings_of(sep)
    part_s = [strings_of(p) for p in parts]
    outs, valid = [], np.ones(cap, dtype=bool)
    for i in range(cap):
        if sep_s[i] is None:
            valid[i] = False
            outs.append("")
            continue
        outs.append(sep_s[i].join(p[i] for p in part_s if p[i] is not None))
    out = _rendered_val(ctx, call, outs, valid)
    ROW_RENDER_LOG.append(("concat_ws", cap, time.perf_counter() - t0))
    return out


def _format_template(f: str) -> tuple:
    """Java format directives (%s %d %x %X %o %f %e %g with the -, +, space,
    #, 0 and , flags, width and precision) -> (one Python str.format
    template, the conversion of each directive)."""
    import re

    if re.search(r"%\d+\$", f):
        raise NotImplementedError("format: %n$ argument indexes")
    pieces, specs = [], []
    last = 0
    for m in re.finditer(r"%([-+0, #]*)(\d*)(?:\.(\d+))?([a-zA-Z%])", f):
        pieces.append(f[last : m.start()].replace("{", "{{").replace("}", "}}"))
        last = m.end()
        flags, width, prec, conv = m.groups()
        if conv == "%":
            pieces.append("%")
            continue
        if conv not in "sdxXofeEgG":
            raise NotImplementedError(f"format: unsupported directive %{conv}")
        spec = ""
        if "-" in flags:
            spec += "<"
        elif conv == "s" and width:
            spec += ">"  # Java right-aligns %Ns; Python left-aligns strings
        if "+" in flags:
            spec += "+"
        elif " " in flags:
            spec += " "
        if "#" in flags:
            spec += "#"
        if "0" in flags and "-" not in flags:
            spec += "0"
        spec += width
        if "," in flags and conv in "dfeEgG":
            spec += ","
        if prec:
            spec += "." + prec
        pieces.append("{%d:%s}" % (len(specs), spec + conv))
        specs.append(conv)
    pieces.append(f[last:].replace("{", "{{").replace("}", "}}"))
    return "".join(pieces), specs


def _format_column(t: T.Type, d: np.ndarray, dictionary) -> list:
    """Python values of one format argument's rows."""
    import datetime

    if dictionary is not None:
        vals = dictionary.values
        return [vals[int(c)] if 0 <= int(c) < len(vals) else "" for c in d]
    if isinstance(t, T.DecimalType) and t.scale > 0:
        q = 10**t.scale
        return [
            f"{'-' if int(c) < 0 else ''}{abs(int(c)) // q}.{abs(int(c)) % q:0{t.scale}d}"
            for c in d
        ]
    if t.name == "timestamp with time zone":
        return [
            _render_tz(int(T.unpack_tz_millis(int(c))), int(T.unpack_tz_offset(int(c))))
            for c in d
        ]
    if t.name == "date":
        epoch = datetime.date(1970, 1, 1)
        return [(epoch + datetime.timedelta(days=int(c))).isoformat() for c in d]
    if t.name == "timestamp":
        ep = datetime.datetime(1970, 1, 1)
        return [
            (ep + datetime.timedelta(microseconds=int(c))).isoformat(sep=" ") for c in d
        ]
    if t.name == "boolean":
        return ["true" if c else "false" for c in d]
    if d.dtype.kind == "f":
        return [float(c) for c in d]
    return [int(c) for c in d]


@register("format")
def _format(ctx, call, fmt, *args):
    """format(fmt, args...) (reference: operator/scalar/FormatFunction.java,
    the Java directive subset of `_format_template`), rendered per row on
    the host.  A NULL argument renders as 'null' under %s, as Java's
    formatter does; under a numeric directive it makes the row NULL."""
    t0 = time.perf_counter()
    f = _literal_str(fmt, "format")
    cap = ctx.capacity
    if any(a.lengths is not None for a in args):
        raise NotImplementedError("format is not supported in this expression context")
    if any(_is_long_dec(a.type) for a in args):
        raise NotImplementedError("format over a long decimal")
    template, specs = _format_template(f)
    if len(specs) != len(args):
        raise NotImplementedError(f"format: {len(specs)} directives but {len(args)} arguments")
    avalids, cols = [], []
    for a in args:
        if a.is_literal_null:
            avalids.append(np.zeros(cap, dtype=bool))
            cols.append([None] * cap)
            continue
        d, va = _host_rows(ctx, a)
        avalids.append(va)
        cols.append(_format_column(a.type, d, a.dictionary))
    outs = []
    valid = np.ones(cap, dtype=bool)
    for i in range(cap):
        row = []
        for j, conv in enumerate(specs):
            if not avalids[j][i]:
                if conv == "s":
                    row.append("null")
                    continue
                valid[i] = False
                break
            v = cols[j][i]
            if conv in "dxXo" and not isinstance(v, int):
                v = int(float(v))
            elif conv in "feEgG" and not isinstance(v, float):
                v = float(v)
            elif conv == "s":
                v = str(v)
            row.append(v)
        outs.append(template.format(*row) if valid[i] else "")
    out = _rendered_val(ctx, call, outs, valid)
    ROW_RENDER_LOG.append(("format", cap, time.perf_counter() - t0))
    return out


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
    temporal = _cast_temporal(v, to)
    if temporal is not None:
        return temporal
    if to is T.BOOLEAN:
        return Val(v.data != 0, v.valid, to)
    if frm is T.BOOLEAN:
        return Val(v.data.to(torch_dtype(to.np_dtype)), v.valid, to)
    raise NotImplementedError(f"cast {frm.name} -> {to.name}")


def _cast_temporal(v: Val, to: T.Type):
    """The casts among date, time, timestamp and timestamptz (the session
    zone is UTC; reference: DateTimeOperators' cast family over packed
    values), or None for any other pair."""
    frm = v.type
    d = _i64(v.data)
    if to is T.DATE and frm is T.TIMESTAMP:
        return Val(d // _DAY_US, v.valid, to)
    if to is T.TIME and frm is T.TIMESTAMP:
        return Val(d % _DAY_US, v.valid, to)
    if to is T.TIMESTAMP and frm is T.TIME:
        return Val(d, v.valid, to)
    if to is T.TIMESTAMP and frm is T.DATE:
        return Val(d * _DAY_US, v.valid, to)
    if frm is T.TIMESTAMP_TZ and to is T.TIMESTAMP:
        # the wall clock in the value's zone: the cast drops the zone, not
        # the offset
        return Val(_tz_local_micros(v), v.valid, to)
    if frm is T.TIMESTAMP_TZ and to is T.DATE:
        return Val(_tz_local_micros(v) // _DAY_US, v.valid, to)
    if to is T.TIMESTAMP_TZ and frm is T.TIMESTAMP:
        return Val(T.pack_tz(d // 1000, 0), v.valid, to)
    if to is T.TIMESTAMP_TZ and frm is T.DATE:
        return Val(T.pack_tz(d * 86_400_000, 0), v.valid, to)
    return None


def _cast_from_varchar(ctx, v: Val, to: T.Type) -> Val:
    """varchar -> numeric/decimal/date/time/timestamp/boolean through a
    parse table over the dictionary (NULL where an entry does not parse; a
    timestamptz never parses, as in the JAX package)."""
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
    if to is T.TIME:
        return T.parse_time_micros(s)
    if to is T.TIMESTAMP:
        import datetime

        txt = s.replace("T", " ")
        d, tm = txt.split(" ", 1) if " " in txt else (txt, "00:00:00")
        y, m, dd = map(int, d.split("-"))
        days = (datetime.date(y, m, dd) - datetime.date(1970, 1, 1)).days
        return days * _DAY_US + T.parse_time_micros(tm)
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

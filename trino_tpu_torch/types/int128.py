"""Two-limb i128 device arithmetic for long decimals (precision 19-38).

Port of trino_tpu/types/int128.py to torch int64 tensors.  A long-decimal
value v is (hi, lo) with v = hi * 2**64 + (lo read as unsigned 64-bit); hi
is the signed high limb and lo carries the raw low 64 bits in an int64
(torch integer adds and multiplies wrap two's-complement, which is exactly
mod-2**64 arithmetic).  Long-decimal columns store the planes stacked on
the last axis: data[..., 0] = hi, data[..., 1] = lo.

torch has no logical right shift on int64 and its uint64 shifts are not
implemented on every backend, so every logical shift here is an
arithmetic shift followed by a mask.
"""

from __future__ import annotations

import torch

#: sign-flip constant for unsigned compares over int64 bit patterns
_SIGN = -(2**63)
_MASK32 = 0xFFFFFFFF

#: python-side constants
TWO64 = 1 << 64


# -- host (python int) conversions -------------------------------------------


def split_py(v: int) -> tuple:
    """Python int -> (hi, lo) limb ints suitable for int64 storage."""
    lo = v & (TWO64 - 1)
    hi = (v - lo) >> 64
    if lo >= 1 << 63:
        lo -= TWO64  # store as int64 bit pattern
    return int(hi), int(lo)


def join_py(hi: int, lo: int) -> int:
    """(hi, lo) int64 limbs -> python int."""
    return (int(hi) << 64) + (int(lo) & (TWO64 - 1))


# -- device helpers -----------------------------------------------------------


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64)


def _segment_sum(x: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, gid, x)


def _ult(a, b):
    """Unsigned < over int64 bit patterns (sign-bit flip trick)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def widen64(v):
    """int64 value -> (hi, lo) planes of the same i128 value."""
    v = _i64(v)
    return v >> 63, v  # arithmetic shift: hi is all sign bits


def add128(ah, al, bh, bl):
    lo = al + bl  # wraps mod 2**64
    carry = _ult(lo, al).to(torch.int64)
    return ah + bh + carry, lo


def neg128(h, l):
    lo = -l  # two's complement of the low limb (wraps)
    hi = ~h + (l == 0).to(torch.int64)
    return hi, lo


def sub128(ah, al, bh, bl):
    nh, nl = neg128(bh, bl)
    return add128(ah, al, nh, nl)


def eq128(ah, al, bh, bl):
    return torch.logical_and(ah == bh, al == bl)


def lt128(ah, al, bh, bl):
    return torch.logical_or(ah < bh, torch.logical_and(ah == bh, _ult(al, bl)))


def is_neg128(h, l):
    return h < 0


def mul128_by_u32(h, l, c: int):
    """(h, l) * c for a small nonnegative python constant c <= 2**31
    ((2**32-1) * 2**31 < 2**63, so the chunk products stay exact).
    Used for decimal rescaling by powers of ten (applied in <=10**9 steps)."""
    if not 0 <= c <= (1 << 31):
        raise ValueError(f"multiplier out of range: {c}")
    l0 = l & _MASK32
    l1 = (l >> 32) & _MASK32  # logical: mask after arithmetic shift
    p0 = l0 * c  # < 2**63: exact
    p1 = l1 * c
    lo_lo = p0 & _MASK32
    carry = (p0 >> 32) + (p1 & _MASK32)  # nonneg
    lo_hi = carry & _MASK32
    lo = lo_lo | (lo_hi << 32)
    hi_carry = (carry >> 32) + ((p1 >> 32) & _MASK32)
    return h * c + hi_carry, lo


def divmod128_by_u31(h, l, c: int):
    """Exact (quotient, remainder) of the SIGNED (h, l) value by a python
    constant 0 < c < 2**31, truncating toward zero.  Schoolbook long
    division over four 32-bit chunks (the running remainder stays
    < c < 2**31, so r*2**32 + chunk < 2**63)."""
    if not 0 < c < (1 << 31):
        raise ValueError(f"divisor out of range: {c}")
    neg = h < 0
    ph, pl = neg128(h, l)
    h_ = torch.where(neg, ph, h)
    l_ = torch.where(neg, pl, l)
    chunks = [
        (h_ >> 32) & _MASK32,
        h_ & _MASK32,
        (l_ >> 32) & _MASK32,
        l_ & _MASK32,
    ]
    r = torch.zeros_like(h_)
    qs = []
    for ch in chunks:
        acc = (r << 32) | ch
        qs.append(acc // c)
        r = acc % c
    qh = (qs[0] << 32) | qs[1]
    ql = (qs[2] << 32) | qs[3]
    nqh, nql = neg128(qh, ql)
    return (
        torch.where(neg, nqh, qh),
        torch.where(neg, nql, ql),
        torch.where(neg, -r, r),
    )


def mul128_by_vec31(h, l, c):
    """(h, l) * c for a NONNEGATIVE int64 vector c < 2**31 (same chunk math
    as mul128_by_u32 with a data-dependent multiplier)."""
    c = _i64(c)
    l0 = l & _MASK32
    l1 = (l >> 32) & _MASK32
    p0 = l0 * c  # < 2**63: exact
    p1 = l1 * c
    lo_lo = p0 & _MASK32
    carry = (p0 >> 32) + (p1 & _MASK32)
    lo_hi = carry & _MASK32
    lo = lo_lo | (lo_hi << 32)
    hi_carry = (carry >> 32) + ((p1 >> 32) & _MASK32)
    return h * c + hi_carry, lo


def mul64x64(a, b):
    """Exact (hi, lo) planes of a * b for two int64 vectors (the hot case:
    short-decimal x short-decimal with a long result, e.g. TPC-H Q1's
    extendedprice * (1 - discount)).  Schoolbook 32-bit chunks."""
    a = _i64(a)
    b = _i64(b)
    neg = (a < 0) ^ (b < 0)
    aa = a.abs()
    ab = b.abs()
    a0 = aa & _MASK32
    a1 = (aa >> 32) & _MASK32  # < 2**31 for |a| < 2**63
    b0 = ab & _MASK32
    b1 = (ab >> 32) & _MASK32
    p00 = a0 * b0  # may wrap: bit pattern IS the unsigned product mod 2**64
    p01 = a0 * b1  # < 2**63: exact
    p10 = a1 * b0
    p11 = a1 * b1
    t = ((p00 >> 32) & _MASK32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | ((t & _MASK32) << 32)
    hi = p11 + (p01 >> 32) + (p10 >> 32) + (t >> 32)
    nh, nl = neg128(hi, lo)
    return torch.where(neg, nh, hi), torch.where(neg, nl, lo)


def mul128_by_i64vec(h, l, c):
    """(h, l) * c for an arbitrary int64 vector c (mod 2**128): split |c|
    into three chunks (31+31+1 bits, each < 2**31 so the 32x31 chunk
    products stay exact in i64), combine shifted partials, apply the sign."""
    c = _i64(c)
    neg = (h < 0) ^ (c < 0)
    ph, pl = neg128(h, l)
    h_ = torch.where(h < 0, ph, h)
    l_ = torch.where(h < 0, pl, l)
    ca = c.abs()
    m31 = (1 << 31) - 1
    c0 = ca & m31
    c1 = (ca >> 31) & m31
    c2 = ca >> 62  # 0 or 1 (|c| < 2**63)
    h0, l0v = mul128_by_vec31(h_, l_, c0)
    h1, l1v = mul128_by_vec31(h_, l_, c1)
    h1, l1v = mul128_by_u32(h1, l1v, 1 << 31)  # partial << 31
    h2, l2v = mul128_by_vec31(h_, l_, c2)
    h2, l2v = mul128_by_u32(h2, l2v, 1 << 31)  # partial << 62
    h2, l2v = mul128_by_u32(h2, l2v, 1 << 31)
    rh, rl = add128(h0, l0v, h1, l1v)
    rh, rl = add128(rh, rl, h2, l2v)
    nh, nl = neg128(rh, rl)
    return torch.where(neg, nh, rh), torch.where(neg, nl, rl)


def divmod128_by_vec(h, l, c):
    """Exact (q_hi, q_lo, remainder) of signed (h, l) by a POSITIVE int64
    vector c (any magnitude up to 2**63-1), truncating toward zero.
    Restoring binary long division over the 128 dividend bits: the running
    remainder stays < c so it fits one int64 plane (unsigned compares via
    the sign-flip trick).  The bit index is a python int, so each step
    reads its limb statically."""
    c = _i64(c)
    neg = h < 0
    ph, pl = neg128(h, l)
    h_ = torch.where(neg, ph, h)
    l_ = torch.where(neg, pl, l)
    rem = torch.zeros_like(h_)
    qh = torch.zeros_like(h_)
    ql = torch.zeros_like(l_)
    for bit_idx in range(127, -1, -1):
        from_hi = bit_idx >= 64
        word = h_ if from_hi else l_
        bit = (word >> (bit_idx - 64 if from_hi else bit_idx)) & 1
        rem2 = (rem << 1) | bit  # bit pattern; may exceed 2**63 (unsigned)
        ge = torch.logical_not(_ult(rem2, c))  # unsigned rem2 >= c
        rem = torch.where(ge, rem2 - c, rem2)
        qbit = ge.to(torch.int64)
        if from_hi:
            qh = (qh << 1) | qbit
        else:
            ql = (ql << 1) | qbit
    nqh, nql = neg128(qh, ql)
    return (
        torch.where(neg, nqh, qh),
        torch.where(neg, nql, ql),
        torch.where(neg, -rem, rem),
    )


def truncdiv_pow10(h, l, k: int):
    """(q_hi, q_lo, any_remainder) of truncate-toward-zero division by
    10**k, k >= 0 (stepped through <=10**9 chunks)."""
    any_r = None
    while k > 0:
        step = min(k, 9)
        h, l, r = divmod128_by_u31(h, l, 10**step)
        nz = r != 0
        any_r = nz if any_r is None else torch.logical_or(any_r, nz)
        k -= step
    if any_r is None:
        any_r = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    return h, l, any_r


def rescale128(h, l, from_scale: int, to_scale: int):
    """Multiply/divide by 10**(to-from) with round-half-away-from-zero on
    downscale (SQL decimal semantics)."""
    if to_scale == from_scale:
        return h, l
    if to_scale > from_scale:
        k = to_scale - from_scale
        while k > 0:
            step = min(k, 9)
            h, l = mul128_by_u32(h, l, 10**step)
            k -= step
        return h, l
    k = from_scale - to_scale
    # divide by 10**k in <=10**9 steps, rounding only on the last step
    while k > 9:
        h, l, _ = divmod128_by_u31(h, l, 10**9)
        k -= 9
    c = 10**k
    q_h, q_l, r = divmod128_by_u31(h, l, c)
    round_up = (2 * r.abs()) >= c
    bump = round_up.to(torch.int64)
    bump = torch.where(is_neg128(h, l), -bump, bump)
    return add128(q_h, q_l, bump >> 63, bump)


def segment_sum128(h, l, gid, num_segments: int, valid=None, hi_direct=False):
    """Exact segmented i128 sum via 32-bit plane sums (each plane sum fits
    i64 for < 2**31 rows), recombined with carries.

    hi_direct: the caller proves |hi| * rows < 2**62 (e.g. from the decimal
    precision bound), so the high limb sums in ONE pass without chunking."""
    if valid is not None:
        h = torch.where(valid, h, 0)
        l = torch.where(valid, l, 0)
    l0 = l & _MASK32
    l1 = (l >> 32) & _MASK32
    s_l0 = _segment_sum(l0, gid, num_segments)
    s_l1 = _segment_sum(l1, gid, num_segments)
    c1 = (s_l0 >> 32) + s_l1  # nonneg
    lo = (s_l0 & _MASK32) | ((c1 & _MASK32) << 32)
    carry = c1 >> 32  # nonneg
    if hi_direct:
        s_h = _segment_sum(h, gid, num_segments)
        return s_h + carry, lo
    h0 = h & _MASK32
    h1 = h >> 32  # signed top chunk
    s_h0 = _segment_sum(h0, gid, num_segments)
    s_h1 = _segment_sum(h1, gid, num_segments)
    c2 = carry + s_h0  # nonneg
    hi = ((s_h1 + (c2 >> 32)) << 32) | (c2 & _MASK32)
    return hi, lo


def sum128_widened(d, gid, num_segments: int, valid=None):
    """Exact segmented i128 sum of SHORT (int64) inputs: two plane sums."""
    if valid is not None:
        d = torch.where(valid, d, 0)
    d0 = d & _MASK32  # in [0, 2**32)
    d1 = d >> 32  # signed top chunk in [-2**31, 2**31)
    s0 = _segment_sum(d0, gid, num_segments)
    s1 = _segment_sum(d1, gid, num_segments)
    return recombine2(s0, s1)


def segment_minmax128(h, l, gid, num_segments: int, valid, is_max: bool):
    """Segmented lexicographic min/max over i128 planes: reduce the high
    limb first, then the low limb among rows matching the winning high."""
    big = torch.iinfo(torch.int64).max
    small = torch.iinfo(torch.int64).min
    lu = l ^ _SIGN  # low limb in signed-comparable (unsigned) order
    fill, how = (small, "amax") if is_max else (big, "amin")

    def reduce(x):
        out = torch.full((num_segments,), fill, dtype=torch.int64, device=x.device)
        return out.scatter_reduce_(0, gid, x, how, include_self=True)

    win_h = reduce(torch.where(valid, h, fill))
    on_win = torch.logical_and(valid, h == win_h[gid])
    win_l = reduce(torch.where(on_win, lu, fill))
    return win_h, win_l ^ _SIGN


def recombine2(s_lo, s_hi32):
    """(hi, lo) from plane sums of a 32-bit chunk split of SHORT values:
    s_lo = sum of low 32-bit chunks (nonneg), s_hi32 = sum of signed top
    chunks.  Value = s_hi32 * 2**32 + s_lo as i128."""
    a = s_hi32 << 32
    lo = a + s_lo
    carry = _ult(lo, a).to(torch.int64)
    return (s_hi32 >> 32) + carry, lo


def recombine4(s_l0, s_l1, s_h0, s_h1):
    """(hi, lo) from the four 32-bit chunk-plane sums of LONG (two-limb)
    values (s_h1 is the signed top chunk)."""
    c1 = (s_l0 >> 32) + s_l1  # nonneg
    lo = (s_l0 & _MASK32) | ((c1 & _MASK32) << 32)
    c2 = (c1 >> 32) + s_h0  # nonneg
    hi = ((s_h1 + (c2 >> 32)) << 32) | (c2 & _MASK32)
    return hi, lo


def to_float128(h, l):
    """Approximate float64 of the i128 value (for stats/debug only)."""
    lf = l.to(torch.float64)
    lo_u = torch.where(l < 0, lf + float(TWO64), lf)
    return h.to(torch.float64) * float(TWO64) + lo_u

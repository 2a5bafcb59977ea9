"""ORC's run-length encodings, decoded and encoded with numpy per stream
(reference: lib/trino-orc's ByteInputStream, BooleanInputStream,
LongInputStreamV1, LongInputStreamV2 and DecimalInputStream, and their
output counterparts).

- Byte RLE: a control byte below 128 is a run of (control + 3) copies of
  the next byte; above, (256 - control) literal bytes follow.
- Boolean RLE: byte RLE over bits packed MSB first.
- Integer RLE v1 (file version 0.11): a run of 3-130 values is a control
  byte, a signed delta byte and a base varint; a negative control byte
  counts literal varints.
- Integer RLE v2 (0.12): four sub-encodings named by a header's top two
  bits: SHORT_REPEAT (3-10 copies of one value of 1-8 big-endian bytes),
  DIRECT (up to 512 bit-packed values), PATCHED_BASE (a base, packed
  offsets, and a list of (gap, patch) entries that set the offsets' high
  bits) and DELTA (a base, a delta base and packed delta magnitudes, or a
  fixed delta at width 0).  Bit packing is big-endian; the 5-bit width code
  is not linear above 24 bits (`WIDTHS`).  Signed streams zigzag every
  value but PATCHED_BASE's, whose base carries its sign in its top bit.
- Decimal varints: zigzagged base-128 varints of up to 128 bits, returned
  as (hi, lo) int64 limb planes.

Run headers are parsed in a Python loop; every DIRECT run of one width is
unpacked in one numpy pass after the loop.  A decoder takes an optional
`stats` object with `enc(name, seconds)` and `runs(name, count)`, which
receives host seconds and run counts by sub-encoding.
"""

from __future__ import annotations

import time

import numpy as np

from trino_tpu_torch.formats.orc.protobuf import read_varint, write_varint, zigzag_encode

#: RLE v2's 5-bit width code -> bits
WIDTHS = tuple(range(1, 25)) + (26, 28, 30, 32, 40, 48, 56, 64)
_CODE_OF = {w: i for i, w in enumerate(WIDTHS)}
SHORT_REPEAT, DIRECT, PATCHED_BASE, DELTA = range(4)
SUB_ENCODINGS = ("RLE_V2_SHORT_REPEAT", "RLE_V2_DIRECT", "RLE_V2_PATCHED_BASE", "RLE_V2_DELTA")
#: the longest RLE v2 run
MAX_RUN = 512
_U8 = np.uint8
_U64 = np.uint64
_I64 = np.int64


class RleError(ValueError):
    """Malformed run-length input."""


def closest_fixed_bits(n: int) -> int:
    """The smallest RLE v2 width holding `n` bits (1 for 0)."""
    if n <= 1:
        return 1
    for w in WIDTHS:
        if w >= n:
            return w
    raise RleError(f"a width of {n} bits exceeds 64")


def _as_u8(buf) -> np.ndarray:
    """The buffer as uint8, padded with 8 zero bytes for the unpacker's
    8-byte loads."""
    raw = np.frombuffer(buf, _U8) if not isinstance(buf, np.ndarray) else buf
    out = np.zeros(len(raw) + 8, _U8)
    out[: len(raw)] = raw
    return out


def unpack_bits(u8: np.ndarray, starts, counts, width: int) -> np.ndarray:
    """Big-endian bit-packed values of `width` bits: `counts[i]` values from
    byte `starts[i]` of the padded `u8` -> uint64, runs concatenated."""
    starts = np.asarray(starts, _I64)
    counts = np.asarray(counts, _I64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, _U64)
    first = np.cumsum(counts) - counts
    j = np.arange(total, dtype=_I64) - np.repeat(first, counts)
    if width % 8 == 0:  # byte-aligned values: gather their bytes alone
        wb = width // 8
        byte = np.repeat(starts, counts) + j * wb
        if int(byte[-1]) + wb > len(u8):
            raise RleError("bit-packed values overrun their stream")
        x = u8[byte].astype(_U64)
        for k in range(1, wb):
            x = (x << _U64(8)) | u8[byte + k]
        return x
    bit = j * width
    byte = np.repeat(starts, counts) + (bit >> 3)
    if int(byte[-1]) + 8 > len(u8):
        raise RleError("bit-packed values overrun their stream")
    windows = np.lib.stride_tricks.as_strided(u8, shape=(len(u8) - 7, 8), strides=(1, 1))
    x = windows[byte].view(">u8").reshape(total).astype(_U64)
    shift = (bit & 7).astype(_U64)
    return (x << shift) >> _U64(64 - width)


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(_U64, copy=False)
    return (u >> _U64(1)).view(_I64) ^ -(u & _U64(1)).view(_I64)


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(_I64, copy=False)
    return ((v << 1) ^ (v >> 63)).view(_U64)


class _Clock:
    """Host seconds and run counts by sub-encoding, one clock read a run."""

    __slots__ = ("stats", "t", "secs", "counts")

    def __init__(self, stats):
        self.stats = stats
        self.t = time.perf_counter()
        self.secs = {}
        self.counts = {}

    def tick(self, name: str) -> None:
        now = time.perf_counter()
        self.secs[name] = self.secs.get(name, 0.0) + now - self.t
        self.counts[name] = self.counts.get(name, 0) + 1
        self.t = now

    def add(self, name: str, seconds: float) -> None:
        self.secs[name] = self.secs.get(name, 0.0) + seconds

    def flush(self) -> None:
        if self.stats is None:
            return
        for name, s in self.secs.items():
            self.stats.enc(name, s)
        for name, c in self.counts.items():
            self.stats.runs(name, c)


# -- byte and boolean RLE -----------------------------------------------------


def decode_byte_rle(buf, n: int, stats=None) -> np.ndarray:
    """`n` bytes of a byte-RLE stream -> uint8."""
    t0 = time.perf_counter()
    out = bytearray()
    pos = 0
    size = len(buf)
    runs = 0
    while len(out) < n:
        if pos >= size:
            raise RleError(f"byte RLE ended after {len(out)} of {n} values")
        h = buf[pos]
        pos += 1
        if h < 128:
            out += bytes((buf[pos],)) * (h + 3)
            pos += 1
        else:
            c = 256 - h
            out += buf[pos:pos + c]
            pos += c
        runs += 1
    if stats is not None:
        stats.enc("BYTE_RLE", time.perf_counter() - t0)
        stats.runs("BYTE_RLE", runs)
    return np.frombuffer(bytes(out[:n]), _U8)


def decode_boolean_rle(buf, n: int, stats=None) -> np.ndarray:
    """`n` booleans (bits MSB first over byte RLE) -> bool."""
    packed = decode_byte_rle(buf, (n + 7) // 8, stats)
    return np.unpackbits(packed, bitorder="big")[:n].astype(bool)


def encode_byte_rle(values) -> bytes:
    """uint8 values -> byte RLE: runs of 3 or more equal bytes as runs, the
    rest as literal groups of up to 128."""
    v = np.ascontiguousarray(values, _U8)
    n = len(v)
    out = bytearray()
    if n == 0:
        return b""
    starts = np.concatenate([[0], np.flatnonzero(v[1:] != v[:-1]) + 1])
    lens = np.diff(np.append(starts, n))
    keep = lens >= 3
    lit = 0

    def literals(a: int, b: int) -> None:
        for s in range(a, b, 128):
            c = min(128, b - s)
            out.append(256 - c)
            out.extend(v[s:s + c].tobytes())

    for s, ln in zip(starts[keep].tolist(), lens[keep].tolist()):
        literals(lit, s)
        while ln >= 3:
            c = min(ln, 130)
            out.append(c - 3)
            out.append(int(v[s]))
            s += c
            ln -= c
        lit = s  # a remainder of 1-2 joins the next literals
    literals(lit, n)
    return bytes(out)


def encode_boolean_rle(values) -> bytes:
    bits = np.asarray(values, bool)
    return encode_byte_rle(np.packbits(bits, bitorder="big"))


# -- varints ------------------------------------------------------------------


def _varint_spans(arr: np.ndarray, n: int):
    """(starts, ends) of the first `n` varints of `arr` (ends exclusive)."""
    ends = np.flatnonzero(arr < 0x80)
    if len(ends) < n:
        raise RleError(f"{len(ends)} varints in a stream of {n} values")
    ends = ends[:n] + 1
    starts = np.concatenate([[0], ends[:-1]]).astype(_I64)
    return starts, ends


def decode_varints(buf, n: int) -> np.ndarray:
    """The first `n` unsigned base-128 varints (at most 64 bits) -> uint64."""
    if n == 0:
        return np.zeros(0, _U64)
    arr = np.frombuffer(buf, _U8) if not isinstance(buf, np.ndarray) else buf
    starts, ends = _varint_spans(arr, n)
    stop = int(ends[-1])
    lens = ends - starts
    pos = np.arange(stop, dtype=_I64) - np.repeat(starts, lens)
    if int(lens.max()) > 10:
        raise RleError("a varint longer than 64 bits")
    sh = (7 * pos).astype(_U64)
    part = (arr[:stop] & 0x7F).astype(_U64) << sh
    return np.add.reduceat(part, starts)


def decode_decimal_varints(buf, n: int):
    """The first `n` zigzagged varints of up to 128 bits -> (hi, lo) int64
    planes of the signed values (lo is the low word's bit pattern)."""
    if n == 0:
        return np.zeros(0, _I64), np.zeros(0, _I64)
    arr = np.frombuffer(buf, _U8) if not isinstance(buf, np.ndarray) else buf
    starts, ends = _varint_spans(arr, n)
    lens = ends - starts
    width = int(lens.max())
    if width > 19:
        raise RleError("a decimal varint longer than 128 bits")
    # one column of bytes per varint position (a short varint reads 0s)
    last = len(arr) - 1
    zlo = np.zeros(n, _U64)
    zhi = np.zeros(n, _U64)
    for g in range(width):
        b7 = (arr[np.minimum(starts + g, last)] & 0x7F).astype(_U64)
        b7[lens <= g] = 0
        s = 7 * g
        if s < 64:
            zlo |= b7 << _U64(s)
            if s + 7 > 64:
                zhi |= b7 >> _U64(64 - s)
        else:
            zhi |= b7 << _U64(s - 64)
    neg = (zlo & _U64(1)).astype(bool)
    lo = (zlo >> _U64(1)) | (zhi << _U64(63))
    hi = zhi >> _U64(1)
    lo = np.where(neg, ~lo, lo)
    hi = np.where(neg, ~hi, hi)
    return hi.view(_I64), lo.view(_I64)


def encode_decimal_varints(hi, lo) -> bytes:
    """(hi, lo) int64 planes of signed 128-bit values -> zigzagged varints."""
    hi = np.asarray(hi, _I64)
    lo = np.asarray(lo, _I64)
    n = len(lo)
    if n == 0:
        return b""
    sign = (hi >> 63).view(_U64)
    ulo = lo.view(_U64)
    zlo = (ulo << _U64(1)) ^ sign
    zhi = ((hi.view(_U64) << _U64(1)) | (ulo >> _U64(63))) ^ sign
    groups = []
    nonzero = []
    for g in range(19):
        s = 7 * g
        if s < 64:
            grp = zlo >> _U64(s)
            if s + 7 > 64:
                grp = grp | (zhi << _U64(64 - s))
            rest = ((zlo >> _U64(s)) != 0) | (zhi != 0)
        else:
            grp = zhi >> _U64(s - 64)
            rest = grp != 0
        grp = grp & _U64(0x7F)
        if g and not rest.any():
            break
        groups.append(grp.astype(_U8))
        nonzero.append(rest)
    k = len(groups)
    mat = np.stack(groups, axis=1)
    alive = np.stack(nonzero, axis=1)
    alive[:, 0] = True
    ng = alive.sum(axis=1)
    cont = np.arange(k)[None, :] < (ng[:, None] - 1)
    mat = mat | (cont.astype(_U8) << 7)
    return mat[alive].tobytes()


# -- integer RLE v1 -----------------------------------------------------------


def decode_int_rle_v1(buf, n: int, signed: bool, stats=None) -> np.ndarray:
    """`n` values of an integer RLE v1 stream -> int64."""
    t0 = time.perf_counter()
    out = np.empty(n, _I64)
    arr = np.frombuffer(buf, _U8)
    term = np.flatnonzero(arr < 0x80)
    spans = []
    pos = 0
    k = 0
    size = len(buf)
    runs = 0
    while k < n:
        if pos >= size:
            raise RleError(f"integer RLE v1 ended after {k} of {n} values")
        h = buf[pos]
        pos += 1
        runs += 1
        if h < 128:
            cnt = h + 3
            delta = buf[pos] - 256 if buf[pos] >= 128 else buf[pos]
            base, pos = read_varint(buf, pos + 1)
            if signed:
                base = (base >> 1) ^ -(base & 1)
            elif base >= 1 << 63:
                base -= 1 << 64
            cnt = min(cnt, n - k)
            out[k:k + cnt] = base + delta * np.arange(cnt, dtype=_I64)
        else:
            cnt = min(256 - h, n - k)
            i = int(np.searchsorted(term, pos))
            if i + cnt - 1 >= len(term):
                raise RleError("integer RLE v1 literals overrun their stream")
            end = int(term[i + cnt - 1]) + 1
            spans.append((k, pos, end, cnt))
            pos = end
        k += cnt
    if spans:
        seg = np.concatenate([arr[s:e] for _, s, e, _ in spans])
        vals = decode_varints(seg, sum(c for *_, c in spans))
        vals = _unzigzag(vals) if signed else vals.view(_I64)
        dest = np.concatenate([np.arange(k0, k0 + c) for k0, _, _, c in spans])
        out[dest] = vals
    if stats is not None:
        stats.enc("RLE_V1", time.perf_counter() - t0)
        stats.runs("RLE_V1", runs)
    return out


# -- integer RLE v2 -----------------------------------------------------------


def _be_int(buf, pos: int, width: int) -> int:
    return int.from_bytes(buf[pos:pos + width], "big")


def decode_int_rle_v2(buf, n: int, signed: bool, stats=None) -> np.ndarray:
    """`n` values of an integer RLE v2 stream -> int64."""
    clock = _Clock(stats)
    out = np.empty(n, _I64)
    u8 = _as_u8(buf)
    size = len(buf)
    direct: dict = {}  # width -> ([out offsets], [byte starts], [counts])
    # SHORT_REPEAT and fixed-delta runs: out[k + i] = base + delta * i,
    # filled after the loop in one pass
    fill_k, fill_n, fill_base, fill_delta = [], [], [], []
    repeated = 0  # values of the SHORT_REPEAT runs among them
    pos = 0
    k = 0
    while k < n:
        if pos >= size:
            raise RleError(f"integer RLE v2 ended after {k} of {n} values")
        h = buf[pos]
        enc = h >> 6
        if enc == SHORT_REPEAT:
            w = ((h >> 3) & 7) + 1
            cnt = (h & 7) + 3
            v = _be_int(buf, pos + 1, w)
            pos += 1 + w
            if signed:
                v = (v >> 1) ^ -(v & 1)
            elif v >= 1 << 63:
                v -= 1 << 64
            cnt = min(cnt, n - k)
            fill_k.append(k)
            fill_n.append(cnt)
            fill_base.append(v)
            fill_delta.append(0)
            repeated += cnt
            k += cnt
            clock.tick(SUB_ENCODINGS[SHORT_REPEAT])
            continue
        width_code = (h >> 1) & 31
        cnt = (((h & 1) << 8) | buf[pos + 1]) + 1
        if enc == DIRECT:
            w = WIDTHS[width_code]
            runs = direct.setdefault(w, ([], [], []))
            runs[0].append(k)
            runs[1].append(pos + 2)
            runs[2].append(min(cnt, n - k))
            pos += 2 + (cnt * w + 7) // 8
            k += cnt
            clock.tick(SUB_ENCODINGS[DIRECT])
            continue
        if enc == DELTA:
            w = WIDTHS[width_code] if width_code else 0
            base, pos = read_varint(buf, pos + 2)
            if signed:
                base = (base >> 1) ^ -(base & 1)
            elif base >= 1 << 63:
                base -= 1 << 64
            dz, pos = read_varint(buf, pos)
            delta = (dz >> 1) ^ -(dz & 1)
            if w == 0:
                take = min(cnt, n - k)
                fill_k.append(k)
                fill_n.append(take)
                fill_base.append(base)
                fill_delta.append(delta)
                k += take
                clock.tick(SUB_ENCODINGS[DELTA])
                continue
            vals = np.empty(cnt, _I64)
            vals[0] = base
            if cnt > 1:
                vals[1] = base + delta
            if cnt > 2:
                mags = unpack_bits(u8, [pos], [cnt - 2], w).view(_I64)
                steps = np.cumsum(mags if delta >= 0 else -mags)
                vals[2:] = vals[1] + steps
                pos += ((cnt - 2) * w + 7) // 8
            take = min(cnt, n - k)
            out[k:k + take] = vals[:take]
            k += take
            clock.tick(SUB_ENCODINGS[DELTA])
            continue
        # PATCHED_BASE
        w = WIDTHS[width_code]
        h2 = buf[pos + 2]
        h3 = buf[pos + 3]
        bw = ((h2 >> 5) & 7) + 1
        pw = WIDTHS[h2 & 31]
        pgw = ((h3 >> 5) & 7) + 1
        pll = h3 & 31
        pos += 4
        base = _be_int(buf, pos, bw)
        top = 1 << (bw * 8 - 1)
        if base & top:
            base = -(base & ~top)
        pos += bw
        data = unpack_bits(u8, [pos], [cnt], w)
        pos += (cnt * w + 7) // 8
        if pgw + pw > 64:
            raise RleError("PATCHED_BASE: a patch entry wider than 64 bits")
        cfb = closest_fixed_bits(pgw + pw)
        entries = unpack_bits(u8, [pos], [pll], cfb).tolist()
        pos += (pll * cfb + 7) // 8
        mask = (1 << pw) - 1
        at = 0
        # gaps add up; a gap above 255 comes as filler entries (gap 255,
        # patch 0), which OR nothing into their slot
        for entry in entries:
            at += entry >> pw
            if at >= cnt:
                raise RleError("PATCHED_BASE: a patch beyond its run")
            data[at] |= np.uint64(((entry & mask) << w) & ((1 << 64) - 1))
        vals = data.view(_I64) + np.int64(base)
        take = min(cnt, n - k)
        out[k:k + take] = vals[:take]
        k += take
        clock.tick(SUB_ENCODINGS[PATCHED_BASE])
    if fill_k:
        t0 = time.perf_counter()
        counts = np.asarray(fill_n, _I64)
        first = np.cumsum(counts) - counts
        i = np.arange(int(counts.sum()), dtype=_I64) - np.repeat(first, counts)
        out[np.repeat(np.asarray(fill_k, _I64), counts) + i] = (
            np.repeat(np.asarray(fill_base, _I64), counts)
            + np.repeat(np.asarray(fill_delta, _I64), counts) * i)
        share = repeated / len(i)  # the pass's seconds, split by values filled
        seconds = time.perf_counter() - t0
        if repeated:
            clock.add(SUB_ENCODINGS[SHORT_REPEAT], seconds * share)
        if share < 1:
            clock.add(SUB_ENCODINGS[DELTA], seconds * (1 - share))
    if direct:
        t0 = time.perf_counter()
        for w, (offs, starts, counts) in direct.items():
            vals = unpack_bits(u8, starts, counts, w)
            vals = _unzigzag(vals) if signed else vals.view(_I64)
            counts = np.asarray(counts, _I64)
            first = np.cumsum(counts) - counts
            dest = np.repeat(np.asarray(offs, _I64) - first, counts) + np.arange(len(vals))
            out[dest] = vals
        clock.add(SUB_ENCODINGS[DIRECT], time.perf_counter() - t0)
    clock.flush()
    return out


def encode_int_rle_v2(values, signed: bool) -> bytes:
    """int64 values -> integer RLE v2, in runs of up to 512: an arithmetic
    run of 3 or more (a constant one too) as SHORT_REPEAT (constant, up to
    10) or DELTA at width 0; any other run as DIRECT at a byte-aligned
    width."""
    v = np.ascontiguousarray(values, _I64)
    n = len(v)
    if n == 0:
        return b""
    u = _zigzag(v) if signed else v.view(_U64)
    starts = np.arange(0, n, MAX_RUN, dtype=_I64)
    lens = np.minimum(MAX_RUN, n - starts)
    # an arithmetic block: no change of the step inside it, and values far
    # from the int64 edges (the step must not wrap)
    d = np.diff(v)
    change = np.concatenate([[0], np.cumsum(d[1:] != d[:-1])]) if n > 2 else np.zeros(max(n - 1, 0), _I64)
    safe = np.abs(v) < (1 << 62)
    unsafe_before = np.concatenate([[0], np.cumsum(~safe)])
    ends = starts + lens
    arith = np.zeros(len(starts), bool)
    steps = np.zeros(len(starts), _I64)
    multi = lens >= 3
    if multi.any():
        s, e = starts[multi], ends[multi]
        arith[multi] = (change[e - 2] == change[s]) & (unsafe_before[e] == unsafe_before[s])
        steps[multi] = d[s]
    # byte widths of the DIRECT blocks
    top = np.maximum.reduceat(u, starts)
    nbytes = np.ones(len(starts), _I64)
    for b in range(1, 8):
        nbytes[top >= (_U64(1) << _U64(8 * b))] = b + 1
    direct = ~arith
    packed = {}
    for b in np.unique(nbytes[direct]).tolist():
        sel = direct & (nbytes == b)
        raw = u[np.repeat(sel, lens)].astype(">u8").view(_U8).reshape(-1, 8)[:, 8 - b:]
        packed[b] = [memoryview(np.ascontiguousarray(raw).reshape(-1)), 0]
    out = bytearray()
    for s, ln, ar, step, b in zip(starts.tolist(), lens.tolist(), arith.tolist(),
                                  steps.tolist(), nbytes.tolist()):
        if ar:
            first = int(u[s]) if signed else int(v[s])
            if step == 0 and ln <= 10:
                width = max(1, (int(u[s]).bit_length() + 7) // 8)
                out.append((SHORT_REPEAT << 6) | ((width - 1) << 3) | (ln - 3))
                out += int(u[s]).to_bytes(width, "big")
                continue
            out.append((DELTA << 6) | ((ln - 1) >> 8))
            out.append((ln - 1) & 0xFF)
            write_varint(out, first if signed else first & ((1 << 64) - 1))
            write_varint(out, zigzag_encode(step))
            continue
        code = _CODE_OF[8 * b]
        out.append((DIRECT << 6) | (code << 1) | ((ln - 1) >> 8))
        out.append((ln - 1) & 0xFF)
        buf, at = packed[b]
        out += buf[at:at + ln * b]
        packed[b][1] = at + ln * b
    return bytes(out)

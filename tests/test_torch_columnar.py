"""The port's device building blocks against the JAX package's: two-limb
int128 arithmetic, segmented reductions (empty segments included), the
stable multi-key sort, splitmix64, batch compaction/concatenation/rendering,
and the copied TPC-H generator's pages.

Inputs are made from a seed with numpy and handed to both engines; every
comparison here is exact (integer arithmetic, permutations, bit patterns,
generated pages), except the float path of `to_float128`, which both
engines compute by the same f64 formula.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu import types as JT
from trino_tpu.columnar import Batch as JBatch, Column as JColumn
from trino_tpu.columnar.dictionary import StringDictionary as JDict
from trino_tpu.ops import common as jcommon
from trino_tpu.types import int128 as ji128
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, StringDictionary
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.ops import common
from trino_tpu_torch.types import int128 as i128

I64_MIN = -(2**63)
I64_MAX = 2**63 - 1
EDGES = np.array(
    [0, 1, -1, I64_MIN, I64_MAX, I64_MIN + 1, 2**32 - 1, 2**32, -(2**32),
     2**31, -(2**31), 2**62, -(2**62), 10**18, -(10**18)],
    dtype=np.int64,
)


def _limbs(seed: int, n: int = 64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        r = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
        r[: len(EDGES)] = rng.permutation(EDGES)
        out.append(r)
    return out


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(port_out, jax_out):
    if not isinstance(port_out, tuple):
        port_out, jax_out = (port_out,), (jax_out,)
    assert len(port_out) == len(jax_out)
    for p, j in zip(port_out, jax_out):
        np.testing.assert_array_equal(_np(p), np.asarray(j))


_BINARY_128 = ["add128", "sub128", "eq128", "lt128"]


@pytest.mark.parametrize("fn", _BINARY_128)
def test_int128_binary(fn):
    ah, al, bh, bl = _limbs(seed=len(fn))
    port = getattr(i128, fn)(*(torch.from_numpy(x) for x in (ah, al, bh, bl)))
    ref = getattr(ji128, fn)(*(jnp.asarray(x) for x in (ah, al, bh, bl)))
    _same(port, ref)


def test_int128_neg_and_widen():
    h, l, _, _ = _limbs(seed=11)
    _same(i128.neg128(torch.from_numpy(h), torch.from_numpy(l)),
          ji128.neg128(jnp.asarray(h), jnp.asarray(l)))
    _same(i128.widen64(torch.from_numpy(l)), ji128.widen64(jnp.asarray(l)))


def test_int128_mul64x64():
    a, b, _, _ = _limbs(seed=12)
    _same(i128.mul64x64(torch.from_numpy(a), torch.from_numpy(b)),
          ji128.mul64x64(jnp.asarray(a), jnp.asarray(b)))


def test_int128_mul128_by_i64vec():
    h, l, c, _ = _limbs(seed=13)
    h = h >> 8  # keep products inside the 128-bit range the callers use
    _same(
        i128.mul128_by_i64vec(*(torch.from_numpy(x) for x in (h, l, c))),
        ji128.mul128_by_i64vec(*(jnp.asarray(x) for x in (h, l, c))),
    )


@pytest.mark.parametrize("c", [1, 7, 10**9, 2**31])
def test_int128_mul128_by_u32(c):
    h, l, _, _ = _limbs(seed=14)
    _same(i128.mul128_by_u32(torch.from_numpy(h), torch.from_numpy(l), c),
          ji128.mul128_by_u32(jnp.asarray(h), jnp.asarray(l), c))


@pytest.mark.parametrize("c", [1, 7, 10**9, 2**31 - 1])
def test_int128_divmod_by_u31(c):
    h, l, _, _ = _limbs(seed=15)
    h[0] = I64_MIN + 1  # avoid the unrepresentable -2**127 negation
    _same(i128.divmod128_by_u31(torch.from_numpy(h), torch.from_numpy(l), c),
          ji128.divmod128_by_u31(jnp.asarray(h), jnp.asarray(l), c))


def test_int128_divmod_by_vec():
    h, l, c, _ = _limbs(seed=16, n=32)
    c = np.abs(c)
    c[c <= 0] = I64_MAX
    c[:3] = [1, 3, I64_MAX]
    h = np.where(h == I64_MIN, 0, h)
    _same(
        i128.divmod128_by_vec(*(torch.from_numpy(x) for x in (h, l, c))),
        ji128.divmod128_by_vec(*(jnp.asarray(x) for x in (h, l, c))),
    )


@pytest.mark.parametrize("frm, to", [(2, 6), (6, 2), (4, 0), (25, 2), (0, 20)])
def test_int128_rescale(frm, to):
    h, l, _, _ = _limbs(seed=17 + frm + to)
    h = h >> 40  # rescaling up by 10**20 must stay inside 128 bits
    _same(i128.rescale128(torch.from_numpy(h), torch.from_numpy(l), frm, to),
          ji128.rescale128(jnp.asarray(h), jnp.asarray(l), frm, to))


def test_int128_recombine():
    rng = np.random.default_rng(18)
    s = [rng.integers(0, 2**52, 32, dtype=np.int64) for _ in range(3)]
    top = rng.integers(-(2**52), 2**52, 32, dtype=np.int64)
    _same(i128.recombine2(torch.from_numpy(s[0]), torch.from_numpy(top)),
          ji128.recombine2(jnp.asarray(s[0]), jnp.asarray(top)))
    _same(
        i128.recombine4(*(torch.from_numpy(x) for x in (*s, top))),
        ji128.recombine4(*(jnp.asarray(x) for x in (*s, top))),
    )


@pytest.mark.parametrize("hi_direct", [False, True])
def test_int128_segment_sum(hi_direct):
    h, l, _, _ = _limbs(seed=19)
    h = h >> 20  # |hi| * rows stays inside i64 for the hi_direct proof
    rng = np.random.default_rng(19)
    gid = rng.integers(0, 5, len(h)).astype(np.int64)
    valid = rng.random(len(h)) < 0.8
    _same(
        i128.segment_sum128(
            torch.from_numpy(h), torch.from_numpy(l), torch.from_numpy(gid), 7,
            valid=torch.from_numpy(valid), hi_direct=hi_direct,
        ),
        ji128.segment_sum128(
            jnp.asarray(h), jnp.asarray(l), jnp.asarray(gid), 7,
            valid=jnp.asarray(valid), hi_direct=hi_direct,
        ),
    )
    d = l
    _same(
        i128.sum128_widened(torch.from_numpy(d), torch.from_numpy(gid), 7,
                            valid=torch.from_numpy(valid)),
        ji128.sum128_widened(jnp.asarray(d), jnp.asarray(gid), 7,
                             valid=jnp.asarray(valid)),
    )


@pytest.mark.parametrize("is_max", [False, True])
def test_int128_segment_minmax(is_max):
    h, l, _, _ = _limbs(seed=20)
    h = h % 4 - 2  # many equal high limbs, so the low limb decides
    rng = np.random.default_rng(20)
    gid = rng.integers(0, 5, len(h)).astype(np.int64)
    valid = rng.random(len(h)) < 0.8
    _same(
        i128.segment_minmax128(
            torch.from_numpy(h), torch.from_numpy(l), torch.from_numpy(gid), 7,
            torch.from_numpy(valid), is_max,
        ),
        ji128.segment_minmax128(
            jnp.asarray(h), jnp.asarray(l), jnp.asarray(gid), 7,
            jnp.asarray(valid), is_max,
        ),
    )


def test_int128_to_float_and_python_limbs():
    h, l, _, _ = _limbs(seed=21)
    np.testing.assert_array_equal(
        i128.to_float128(torch.from_numpy(h), torch.from_numpy(l)).numpy(),
        np.asarray(ji128.to_float128(jnp.asarray(h), jnp.asarray(l))),
    )
    for v in [0, -1, 2**64, -(2**100) + 3, 10**38 - 1, -(10**38) + 1]:
        assert i128.split_py(v) == ji128.split_py(v)
        assert i128.join_py(*i128.split_py(v)) == v


# -- segmented reductions ------------------------------------------------------


@pytest.mark.parametrize(
    "kind, dtype",
    [
        (kind, dtype)
        for kind in ["sum", "min", "max", "count", "any"]
        for dtype in [np.int64, np.int32, np.float64, np.bool_]
        if not (dtype == np.bool_ and kind == "sum")
    ],
)
def test_segment_reduce_with_empty_segments(kind, dtype):
    rng = np.random.default_rng(31)
    n, nseg = 64, 12  # segments 3, 7 and 10..11 stay empty
    gid = rng.choice([0, 1, 2, 4, 5, 6, 8, 9], n).astype(np.int64)
    if dtype == np.bool_:
        values = rng.random(n) < 0.5
    else:
        values = (rng.standard_normal(n) * 1000).astype(dtype)
    valid = rng.random(n) < 0.7
    valid[gid == 9] = False  # a segment with rows but no valid row
    port = common.segment_reduce(
        torch.from_numpy(values), torch.from_numpy(gid), nseg, kind,
        valid=torch.from_numpy(valid),
    )
    ref = jcommon.segment_reduce(
        jnp.asarray(values), jnp.asarray(gid), nseg, kind, valid=jnp.asarray(valid)
    )
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# -- the stable multi-key sort ----------------------------------------------------


def _sort_batches(seed: int):
    rng = np.random.default_rng(seed)
    n = 256
    ints = rng.integers(-3, 4, n).astype(np.int64)
    ints[0], ints[1] = I64_MIN, I64_MAX
    int_valid = rng.random(n) < 0.8
    floats = rng.choice([-1.5, 0.0, 2.25, np.nan, np.inf, -np.inf], n)
    float_valid = rng.random(n) < 0.85
    words = ["delta", "alpha", "charlie", "bravo"]
    d = sorted(words)
    codes = rng.integers(0, len(d), n).astype(np.int32)
    str_valid = rng.random(n) < 0.9
    longs = np.stack([rng.integers(-2, 2, n), rng.integers(I64_MIN, I64_MAX, n)], -1)
    long_t = T.DecimalType(30, 2)
    mask = rng.random(n) < 0.9
    port = Batch(
        [
            Column(torch.from_numpy(ints), T.BIGINT, torch.from_numpy(int_valid)),
            Column(torch.from_numpy(floats), T.DOUBLE, torch.from_numpy(float_valid)),
            Column(torch.from_numpy(codes), T.VARCHAR, torch.from_numpy(str_valid),
                   StringDictionary(d)),
            Column(torch.from_numpy(longs), long_t, torch.from_numpy(int_valid)),
        ],
        torch.from_numpy(mask),
    )
    ref = JBatch(
        [
            JColumn(jnp.asarray(ints), JT.BIGINT, jnp.asarray(int_valid)),
            JColumn(jnp.asarray(floats), JT.DOUBLE, jnp.asarray(float_valid)),
            JColumn(jnp.asarray(codes), JT.VARCHAR, jnp.asarray(str_valid), JDict(d)),
            JColumn(jnp.asarray(longs), JT.DecimalType(30, 2), jnp.asarray(int_valid)),
        ],
        jnp.asarray(mask),
    )
    return port, ref


@pytest.mark.parametrize(
    "keys",
    [
        [(0, True, False)],
        [(0, False, True)],
        [(1, True, False)],
        [(1, False, True)],
        [(2, True, True), (0, False, False)],
        [(3, True, False)],
        [(3, False, True), (1, True, True)],
        [(2, False, False), (1, False, False), (0, True, True)],
    ],
)
def test_multi_key_sort_perm_matches_jax(keys):
    port, ref = _sort_batches(seed=41)
    p = common.multi_key_sort_perm(port, [common.SortKey(*k) for k in keys])
    j = jcommon.multi_key_sort_perm(ref, [jcommon.SortKey(*k) for k in keys])
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_group_ids_from_sorted_matches_jax():
    port, ref = _sort_batches(seed=42)
    keys = [0, 2]
    p = common.multi_key_sort_perm(port, [common.SortKey(k) for k in keys])
    j = jcommon.multi_key_sort_perm(ref, [jcommon.SortKey(k) for k in keys])
    pg = common.group_ids_from_sorted(port, p, keys)
    jg = jcommon.group_ids_from_sorted(ref, j, keys)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_splitmix64_bit_equal():
    rng = np.random.default_rng(51)
    u = rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64, endpoint=True)
    u[:4] = [0, 1, 2**63, 2**64 - 1]
    ref = jcommon.splitmix64(u)
    port = common.splitmix64(torch.from_numpy(u.view(np.int64)))
    np.testing.assert_array_equal(port.numpy().view(np.uint64), ref)


# -- batches --------------------------------------------------------------------


def test_compact_device_and_to_pylist_match_jax():
    port, ref = _sort_batches(seed=61)
    np.testing.assert_array_equal(
        port.compact_device(512).mask().numpy(),
        np.asarray(ref.compact_device(512).mask()),
    )
    def nan_free(rows):  # NaN != NaN: compare its rendering instead
        return [[repr(v) if v != v else v for v in r] for r in rows]

    assert nan_free(port.compact_device().to_pylist()) == nan_free(
        ref.compact_device().to_pylist()
    )
    assert port.num_rows_host() == ref.num_rows_host()


def test_concat_batches_unifies_dictionaries():
    a = Column(torch.tensor([0, 1], dtype=torch.int32), T.VARCHAR, None,
               StringDictionary(["x", "z"]))
    b = Column(torch.tensor([1, 0], dtype=torch.int32), T.VARCHAR,
               torch.tensor([True, False]), StringDictionary(["w", "y"]))
    out = concat_batches([Batch([a]), Batch([b], torch.tensor([True, True]))])
    assert out.to_pylist() == [["x"], ["z"], ["y"], [None]]
    assert list(out.columns[0].dictionary.values) == ["w", "x", "y", "z"]


# -- the copied TPC-H generator ---------------------------------------------------


@pytest.mark.parametrize(
    "table", ["lineitem", "orders", "customer", "supplier", "nation", "region"]
)
def test_tpch_generator_pages_identical(table):
    from trino_tpu.connectors.tpch import TpchConnector as JTpch
    from trino_tpu.connectors.api import TableHandle as JHandle
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.connectors.api import TableHandle

    port, ref = TpchConnector(), JTpch()
    ph, jh = TableHandle("tpch", "tiny", table), JHandle("tpch", "tiny", table)
    cols = [c.name for c in ref.metadata().table_metadata("tiny", table).columns]
    psplits = list(port.splits(ph, target_splits=4))
    jsplits = list(ref.splits(jh, target_splits=4))
    assert [(s.row_start, s.row_count) for s in psplits] == [
        (s.row_start, s.row_count) for s in jsplits
    ]
    for ps, js in zip(psplits, jsplits):
        ppages = list(port.page_source(ps, cols, 1 << 12).pages())
        jpages = list(ref.page_source(js, cols, 1 << 12).pages())
        assert len(ppages) == len(jpages)
        for pp, jp in zip(ppages, jpages):
            for pc, jc in zip(pp, jp):
                np.testing.assert_array_equal(pc.values, jc.values)
                assert (pc.valid is None) == (jc.valid is None)
                if pc.valid is not None:
                    np.testing.assert_array_equal(pc.valid, jc.valid)
                assert (pc.dictionary is None) == (jc.dictionary is None)
                if pc.dictionary is not None:
                    assert list(pc.dictionary.values) == list(jc.dictionary.values)

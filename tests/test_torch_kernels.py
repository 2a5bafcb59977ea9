"""The port's kernel modules: the grouped-sums kernel (trino_tpu_torch/ops/grouped_sums.py)
against the JAX package's Pallas kernel (run in interpret mode, as
tests/test_pallas_agg.py runs it) and its XLA formulation.

The same inputs, made from a seed with numpy, go to both engines.  Values
are uniform in [0, 1) and accumulated in float32 by the JAX kernel, while
the port's plain version accumulates in float64 and rounds once, so sums
agree within rtol 1e-5 (f32 summation over at most 8192 rows in a
different order); a column of ones carries counts, which are exact.

The CUDA kernel itself runs only on the card, where `python3 chip_smoke.py`
holds it to the plain version at the main path's shapes and at the edges.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from trino_tpu.ops.pallas_agg import grouped_sums_pallas, grouped_sums_xla
from trino_tpu_torch.ops import grouped_sums as gs


def _inputs(n: int, g: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    mask[-(n // 8):] = False  # a dead tail, as padded scan batches have
    # dead rows may carry an out-of-range slot (the engine's `prod`)
    gids[-(n // 16):] = g
    values = rng.random((n, k)).astype(np.float32)
    values[:, 0] = 1.0  # counts column
    return gids, mask, values


@pytest.mark.parametrize("n", [2048, 8192])
@pytest.mark.parametrize("k", [1, 11, 32])
@pytest.mark.parametrize("g", [1, 12, 512])
def test_reference_matches_pallas_and_xla(g, k, n):
    gids, mask, values = _inputs(n, g, k, seed=g * 1000 + k * 10 + n)
    ref = gs.grouped_sums_reference(
        torch.from_numpy(gids), torch.from_numpy(mask), torch.from_numpy(values), g
    ).numpy()
    pallas = np.asarray(
        grouped_sums_pallas(
            jnp.asarray(gids), jnp.asarray(mask), jnp.asarray(values),
            n_groups=g, interpret=True,
        )
    )
    xla = np.asarray(
        grouped_sums_xla(jnp.asarray(gids), jnp.asarray(mask), jnp.asarray(values), g)
    )
    assert ref.shape == pallas.shape == (g, k)
    assert ref.dtype == np.float32
    live = mask & (gids < g)
    counts = np.bincount(gids[live], minlength=g).astype(np.float32)
    np.testing.assert_array_equal(ref[:, 0], counts)
    np.testing.assert_array_equal(pallas[:, 0], counts)
    np.testing.assert_allclose(ref, pallas, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ref, xla, rtol=1e-5, atol=0)


def test_wrapper_routes_cpu_tensors_to_reference():
    gids, mask, values = _inputs(2048, 12, 11, seed=3)
    before_kernel = gs.grouped_sums.launches
    before_ref = gs.grouped_sums_reference.launches
    out = gs.grouped_sums(
        torch.from_numpy(gids), torch.from_numpy(mask), torch.from_numpy(values), 12
    )
    assert gs.grouped_sums.launches == before_kernel  # no kernel on the CPU
    assert gs.grouped_sums_reference.launches == before_ref + 1
    assert out.shape == (12, 11) and out.dtype == torch.float32


@pytest.mark.parametrize(
    "gids, mask, values, g",
    [
        (torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool),
         torch.ones(4, 1), 2),
        (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.uint8),
         torch.ones(4, 1), 2),
        (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
         torch.ones(4, 1, dtype=torch.float64), 2),
        (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
         torch.ones(3, 1), 2),
        (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
         torch.ones(4, 1), 0),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(gids, mask, values, g):
    with pytest.raises((TypeError, ValueError)):
        gs.grouped_sums(gids, mask, values, g)


@pytest.mark.parametrize(
    "n, g, k", [(1 << 20, 12, 11), (2048, 1, 1), (2048, 512, 11), (8192, 512, 32),
                (4096, 512, 200), (1 << 24, 512, 3), (100, 12, 11), (1000, 12, 3),
                (5000, 7, 5), (1 << 20, 1, 1000)]
)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_launch_plan_fits_shared_memory(n, g, k, aligned):
    plan = gs.launch_plan(n, g, k, sm_count=132, aligned=aligned)
    kt, copies, rows = plan["kt"], plan["copies"], plan["tile_rows"]
    assert 1 <= kt <= k
    assert copies >= 1
    assert copies * g * kt * 4 <= gs._SMEM_BUDGET
    acc = -(-copies * g * kt * 4 // gs._ALIGN) * gs._ALIGN
    ring = plan["stages"] * (-(-plan["stage_bytes"] // gs._ALIGN) * gs._ALIGN)
    assert plan["smem"] == gs._BARRIER_BYTES + acc + ring <= gs._SM_SMEM - 1024
    assert 1 <= plan["stages"] <= gs._MAX_STAGES
    assert 1 <= plan["grid_x"] <= gs._BLOCKS_PER_SM * 132
    # the ring: tiles of a multiple of 16 rows, so each of the three bulk
    # copies (values, group ids, masks) is a multiple of 16 bytes
    assert rows % 16 == 0 and 0 <= rows <= gs._TILE_ROWS
    assert plan["stage_bytes"] == rows * (4 * k + 5)
    for nbytes in (rows * k * 4, rows * 4, rows):
        assert nbytes % 16 == 0
    # staged exactly when one accumulator column tile covers K and the
    # inputs are 16-byte aligned (and a 16-row tile fits)
    if not aligned or kt < k:
        assert rows == 0
    elif (n, g, k) in ((1 << 20, 12, 11), (2048, 512, 11), (8192, 512, 32)):
        assert rows >= 16
    rows_per_step = 32 // kt if kt <= 32 else 1
    if g * kt * gs._WARPS * rows_per_step * 4 <= gs._SMEM_BUDGET:
        # every warp row slot gets a private accumulator (no contention)
        assert copies == gs._WARPS * rows_per_step


def test_launch_plan_main_shape():
    """Q1-double's batch: a private [12][11] copy per row slot (two slots
    of 11 lanes per warp, 16 consumer warps), 512-row tiles in a
    three-stage ring, two blocks per SM of the H100's 132."""
    plan = gs.launch_plan(1 << 20, 12, 11, sm_count=132)
    assert plan["copies"] == 2 * gs._WARPS == 32
    assert plan["tile_rows"] == 512 and plan["stages"] == 3
    assert plan["stage_bytes"] == 512 * 49
    assert plan["grid_x"] == 2 * 132
    assert 2 * (plan["smem"] + 1024) <= gs._SM_SMEM


# -- K2: the sorted-build probe (ops/locate_sorted.py) -------------------------
#
# The port's plain version, `locate_sorted_reference`, against the JAX
# package's Pallas kernel `locate_sorted_pallas` (interpret mode, as
# tests/test_pallas_probe.py runs it) and both packages' `_locate_sorted`,
# bit-exact.  The Pallas grid covers whole blocks only (`p_cap // block`), so
# a probe length that is not a multiple of 1024 runs there with a block that
# divides it; the JAX `_locate_sorted` takes every length as it is.

from trino_tpu.ops.join import _locate_sorted as jax_locate_sorted  # noqa: E402
from trino_tpu.ops.pallas_probe import (  # noqa: E402
    locate_sorted_pallas,
    probe_kernel_eligible as jax_probe_kernel_eligible,
)
from trino_tpu_torch.ops import join as tjoin  # noqa: E402
from trino_tpu_torch.ops import locate_sorted as ls  # noqa: E402

_I64 = np.iinfo(np.int64)


def _sorted_plane(rng, cap_b, n_match, lo, hi, dtype=np.int64):
    """The runner's invariant: matchable keys sorted in [0, n_match), the
    tail padded with the dtype's largest value."""
    keys = np.sort(rng.integers(lo, hi, n_match)).astype(dtype)
    pad = np.full(cap_b - n_match, np.iinfo(dtype).max, dtype=dtype)
    return np.concatenate([keys, pad])


def _probe_case(name):
    """(build, n_match, probe, nomatch, cap_b, pallas block)."""
    rng = np.random.default_rng(_PROBE_CASES.index(name) + 1)
    if name == "dups_misses":  # heavy duplicate runs, keys outside the build
        b = _sorted_plane(rng, 512, 389, 0, 64)
        return b, 389, rng.integers(-4, 72, 2048), rng.random(2048) < 0.15, 512, 1024
    if name == "all_nomatch":
        b = _sorted_plane(rng, 512, 389, 0, 64)
        return b, 389, rng.integers(0, 64, 2048), np.ones(2048, bool), 512, 1024
    if name == "n_match_0":
        return np.full(16, _I64.max), 0, np.arange(64), np.zeros(64, bool), 16, 1024
    if name == "ragged_p":  # 1500 = 3 x 500: not a multiple of 1024
        b = _sorted_plane(rng, 4096, 3000, -1000, 1000)
        return b, 3000, rng.integers(-1100, 1100, 1500), rng.random(1500) < 0.1, 4096, 500
    if name == "small_p":  # one block shorter than 1024
        b = _sorted_plane(rng, 4096, 3000, -1000, 1000)
        return b, 3000, rng.integers(-1100, 1100, 100), np.zeros(100, bool), 4096, 1024
    if name == "int64_extremes":
        b = np.array([_I64.min, _I64.min, -1, 0, 5, _I64.max - 1, _I64.max, _I64.max])
        p = np.array([_I64.min, _I64.max, 0, -1, 7, _I64.max - 1, 3, _I64.min + 1])
        return b, 8, p, np.array([0, 0, 0, 0, 0, 0, 0, 1], bool), 8, 1024
    if name == "multi_block":  # 4 grid steps of 256 rows on the TPU side
        b = _sorted_plane(rng, 128, 100, 0, 1000)
        return b, 100, rng.integers(0, 1000, 1024), np.zeros(1024, bool), 128, 256
    raise KeyError(name)


_PROBE_CASES = [
    "dups_misses", "all_nomatch", "n_match_0", "ragged_p", "small_p",
    "int64_extremes", "multi_block",
]


def _jax_probe(build, n_match, probe, nomatch, cap_b, block):
    b = jnp.asarray(build.astype(np.int64))
    p = jnp.asarray(probe.astype(np.int64))
    no = jnp.asarray(nomatch)
    ps, pc = locate_sorted_pallas(
        b, n_match, p, no, cap_b=cap_b, interpret=True, block=min(block, len(probe))
    )
    xs, xc = jax_locate_sorted(
        [jnp.asarray(build)], jnp.asarray(n_match, jnp.int64), [jnp.asarray(probe)],
        no, cap_b=cap_b,
    )
    return (np.asarray(ps), np.asarray(pc)), (np.asarray(xs), np.asarray(xc))


@pytest.mark.parametrize("case", _PROBE_CASES)
def test_locate_sorted_reference_bit_exact_with_pallas(case):
    build, n_match, probe, nomatch, cap_b, block = _probe_case(case)
    (ps, pc), (xs, xc) = _jax_probe(build, n_match, probe, nomatch, cap_b, block)
    rs, rc = ls.locate_sorted_reference(
        torch.from_numpy(build), torch.tensor(n_match), torch.from_numpy(probe),
        torch.from_numpy(nomatch), cap_b=cap_b,
    )
    for got in ((rs, rc),):
        np.testing.assert_array_equal(got[0].numpy(), ps)
        np.testing.assert_array_equal(got[1].numpy(), pc)
    np.testing.assert_array_equal(ps, xs)
    np.testing.assert_array_equal(pc, xc)
    assert rs.dtype == rc.dtype == torch.int64
    # the multi-plane form of the port's search gives the same bits
    ts, tc = tjoin._locate_sorted(
        [torch.from_numpy(build)], n_match, [torch.from_numpy(probe)],
        torch.from_numpy(nomatch), cap_b=cap_b,
    )
    assert torch.equal(ts, rs) and torch.equal(tc, rc)


def test_locate_sorted_int32_planes_widened():
    """int32 build and probe planes: the wrapper's int64 view (the kernel's
    type) and the int32 plain search agree with the JAX kernel over the
    widened planes."""
    rng = np.random.default_rng(5)
    build = _sorted_plane(rng, 1024, 900, -50, 50, np.int32)
    probe = rng.integers(-60, 60, 3072).astype(np.int32)
    nomatch = rng.random(3072) < 0.05
    (ps, pc), (xs, xc) = _jax_probe(build, 900, probe, nomatch, 1024, 1024)
    args = (torch.from_numpy(build), torch.tensor(900), torch.from_numpy(probe),
            torch.from_numpy(nomatch))
    for fn in (ls.locate_sorted, ls.locate_sorted_reference):
        s, c = fn(*args, cap_b=1024)
        np.testing.assert_array_equal(s.numpy(), ps)
        np.testing.assert_array_equal(c.numpy(), pc)
    np.testing.assert_array_equal(ps, xs)
    np.testing.assert_array_equal(pc, xc)


def test_locate_sorted_wrapper_routes_cpu_tensors_to_reference():
    build, n_match, probe, nomatch, cap_b, _ = _probe_case("dups_misses")
    before = ls.locate_sorted.launches
    s, c = ls.locate_sorted(
        torch.from_numpy(build), n_match, torch.from_numpy(probe),
        torch.from_numpy(nomatch), cap_b=cap_b,
    )
    assert ls.locate_sorted.launches == before  # no kernel on the CPU
    assert s.shape == c.shape == (len(probe),)


@pytest.mark.parametrize(
    "build, probe, nomatch",
    [
        (torch.zeros(8, dtype=torch.float64), torch.zeros(4, dtype=torch.int64),
         torch.zeros(4, dtype=torch.bool)),
        (torch.zeros(8, dtype=torch.int64), torch.zeros(4, dtype=torch.bool),
         torch.zeros(4, dtype=torch.bool)),
        (torch.zeros(8, 2, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
         torch.zeros(4, dtype=torch.bool)),
        (torch.zeros(8, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
         torch.zeros(3, dtype=torch.bool)),
        (torch.zeros(8, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
         torch.zeros(4, dtype=torch.uint8)),
    ],
)
def test_locate_sorted_rejects_what_the_kernel_does_not_take(build, probe, nomatch):
    with pytest.raises((TypeError, ValueError)):
        ls.locate_sorted(build, 1, probe, nomatch, cap_b=8)


def test_probe_kernel_eligible_matches_jax():
    i = np.arange(8, dtype=np.int64)
    i32 = np.arange(8, dtype=np.int32)
    i8 = np.arange(8, dtype=np.int8)
    f = np.arange(8, dtype=np.float64)
    cases = [
        ([i], [i]), ([i, i], [i, i]), ([f], [f]), ([i], [f]), ([f], [i]),
        ([i32], [i]), ([i8], [i8]), ([i], [i, i]), ([i.reshape(4, 2)], [i]),
    ]
    for b, p in cases:
        want = jax_probe_kernel_eligible(
            [jnp.asarray(x) for x in b], [jnp.asarray(x) for x in p]
        )
        got = ls.probe_kernel_eligible(
            [torch.from_numpy(x) for x in b], [torch.from_numpy(x) for x in p]
        )
        assert got == want, (b, p)


@pytest.mark.parametrize(
    "cap_b",
    [1, 2, 7, 8, 9, 100, 4096, 65536, 98296, 98304, 98305, 1 << 17, 1 << 20,
     1 << 22, (1 << 22) + 3, 1 << 24],
)
def test_locate_sorted_launch_plan(cap_b):
    plan = ls.launch_plan(cap_b, 1 << 20, sm_count=132)
    s, log_s = plan["s"], plan["log_s"]
    # S a power of two >= 8, the smallest whose splitters fit the budget
    assert s == 1 << log_s and s >= 8
    n_max = -(-cap_b // s)  # the splitters of n_match = cap_b
    assert 8 * (n_max + (n_max & 1)) <= ls._SPLITTER_BUDGET
    if s > 8:
        half = -(-cap_b // (s // 2))
        assert 8 * (half + (half & 1)) > ls._SPLITTER_BUDGET
    # every n_match <= cap_b has its splitters staged: the scratch and the
    # shared memory hold ceil(n_match / S) keys, rounded up to an even
    # count (16-byte copies)
    for n_match in {0, 1, s - 1, s, s + 1, cap_b - 1, cap_b}:
        if 0 <= n_match <= cap_b:
            n_spl = -(-n_match // s)
            assert n_spl + (n_spl & 1) <= plan["smem"] // 8 <= plan["splitters"]
    assert plan["splitters"] >= ls._MIN_SPLITTERS and plan["splitters"] % 2 == 0
    assert plan["smem"] <= ls._SPLITTER_BUDGET <= ls._SM_SMEM - 1024
    assert plan["rows"] == ls._ROWS.get(s, 1)
    assert 1 <= plan["grid"] <= ls._BLOCKS_PER_SM * 132
    assert 1 <= plan["gather_grid"]


def test_locate_sorted_launch_plan_main_shape():
    """The mesh Q3's largest launch: a 65,536-row build plane takes S = 8
    (8,192 splitters, 64 KB), three blocks per SM; 2^20 probe rows in
    1024-row chunks leave none of the 396 blocks idle."""
    plan = ls.launch_plan(65536, 1 << 20, sm_count=132)
    assert (plan["s"], plan["smem"], plan["grid"]) == (8, 65536, 396)
    assert ls.launch_plan(65536, 1000, sm_count=132)["grid"] == 1


def test_locate_sorted_alignment_check_raises():
    """The kernel reads 16-byte windows of the build plane: the wrapper's
    check refuses a plane that does not start on a 16-byte boundary."""
    plane = torch.zeros(64, dtype=torch.int64)
    assert plane.data_ptr() % 16 == 0
    ls.check_aligned(plane)
    ls.check_aligned(plane[2:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        ls.check_aligned(plane[1:])

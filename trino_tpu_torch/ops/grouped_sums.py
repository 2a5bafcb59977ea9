"""Masked grouped sums: the aggregation kernel of the Q1 shape.

Counterpart of trino_tpu/ops/pallas_agg.py::grouped_sums_pallas (the
Pallas TPU kernel `_agg_kernel`).  Computes, for gids int32 [N] in [0, G),
mask bool [N] and values float32 [N, K], the float32 [G, K] sums of
values[r, :] over the rows r whose mask is set, grouped by gids[r].

On the card `grouped_sums` launches the CUDA C++ kernel in
`csrc/grouped_sums.cu` (built for sm_90a by kernels/build.py):

  * Design: the TPU kernel carries one [G, K] accumulator across its
    sequential grid.  H100 blocks run in parallel, so a persistent grid of
    blocks each walks a grid-stride share of row tiles.  In each block one
    producer thread keeps a ring of `stages` tiles (values, group ids and
    masks) in flight into shared memory with Hopper's 1-D bulk copy,
    completing on an mbarrier per stage, while sixteen consumer warps
    accumulate the tiles that have landed into [G, K] copies in shared
    memory — one private copy per warp row slot when they fit (no
    contention at Q1's G = 12, where every thread would otherwise hit the
    same 12 * K addresses; each slot reads four rows ahead of their adds),
    shared copies through shared-memory atomics when they do not — and
    release each stage to the producer.  The rows past the last full tile
    take plain loads.  Each block writes one [G, K]
    partial to a scratch tensor; a second launch sums the partials, one
    block per output cell, in a fixed order.  K wider than the
    shared-memory budget is tiled over grid.y and read in place, as are
    inputs that are not 16-byte aligned.  No tensor cores: TF32 would
    round the values.  `launch_plan` sizes the tiles, the ring and the
    grid.
  * Bound: memory.  It must read N * (4 + 1) bytes of group ids and masks
    and 4K bytes per live row; at N = 2^20, K = 11 and 78% live rows that
    is ~41 MB, ~12.3 us at 3.35 TB/s (the staged tiles also read the dead
    rows' values, ~51 MB in all).

On a CPU tensor it runs `grouped_sums_reference`, the plain PyTorch
version (`index_add_` of the masked rows, accumulated in float64 and
rounded once to float32, so it is the exactly-rounded oracle the kernel is
held to).  A CUDA tensor launches the kernel or raises: there is no
fallback.  `grouped_sums.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: consumer warps per block, rows in flight per row slot of the in-place
#: path, and the most ring stages (csrc/grouped_sums.cu kConsumerWarps,
#: kUnroll, kMaxStages); a block is the consumer warps and one producer
#: warp.  Sixteen consumer warps, two blocks per SM: the accumulation is a
#: chain of shared-memory reads and adds per row, and the card measured it
#: faster with more warps in flight than with fewer warps and larger rings
#: (PERF.md).
_WARPS = 16
_THREADS = (_WARPS + 1) * 32
_UNROLL = 4
_MAX_STAGES = 8
#: the staged ring: rows per tile (at most; a multiple of 16 so every bulk
#: copy is a multiple of 16 bytes) and stages
_TILE_ROWS = 512
_STAGES = 3
#: shared-memory layout: the mbarriers (kBarrierBytes), then the
#: accumulator copies and each stage rounded up to kAlign bytes
_BARRIER_BYTES = 2 * _MAX_STAGES * 8
_ALIGN = 128
#: dynamic shared memory a block may use for its accumulator copies
_SMEM_BUDGET = 96 * 1024
#: shared memory of one SM (H100: 227 KB usable by blocks, less 1 KB that
#: the runtime reserves per resident block)
_SM_SMEM = 227 * 1024
#: resident blocks per SM of pass 1 when shared memory allows
_BLOCKS_PER_SM = 2


def grouped_sums_reference(gids, mask, values, n_groups: int) -> torch.Tensor:
    """Plain PyTorch grouped sums: float32 [G, K]."""
    grouped_sums_reference.launches += 1
    keep = torch.logical_and(mask, (gids >= 0) & (gids < n_groups))
    out = torch.zeros(
        (n_groups, values.shape[1]), dtype=torch.float64, device=values.device
    )
    out.index_add_(0, gids[keep].to(torch.int64), values[keep].to(torch.float64))
    return out.to(torch.float32)


grouped_sums_reference.launches = 0


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def launch_plan(n: int, n_groups: int, k: int, sm_count: int,
                aligned: bool = True, tile_rows: int = _TILE_ROWS,
                stages: int = _STAGES,
                blocks_per_sm: int = _BLOCKS_PER_SM) -> dict:
    """Launch geometry of pass 1: the column tile kt that fits one [G, kt]
    f32 accumulator copy in the shared-memory budget (grid.y tiles K), the
    number of copies per block, the staged ring (rows per tile, a multiple
    of 16, or 0 for the in-place path; stages; bytes per stage), the
    dynamic shared memory and grid.x.  Tiles are staged when kt == K and
    the inputs are 16-byte aligned, with as many rows (at most
    `tile_rows`) as let the ring and the copies fit one SM."""
    kt = max(1, min(k, _SMEM_BUDGET // (4 * n_groups)))
    rows_per_step = 32 // kt if kt <= 32 else 1
    slots = _WARPS * rows_per_step
    copies = max(1, min(slots, _SMEM_BUDGET // (4 * n_groups * kt)))
    acc = _round_up(copies * n_groups * kt * 4, _ALIGN)
    row_bytes = 4 * k + 4 + 1  # values, group id, mask
    rows = 0
    if aligned and kt == k:
        room = (_SM_SMEM - 1024 - _BARRIER_BYTES - acc) // stages
        rows = min(tile_rows, room // row_bytes) // 16 * 16
        while rows > 0 and _round_up(rows * row_bytes, _ALIGN) > room:
            rows -= 16
    stage_bytes = rows * row_bytes
    smem = _BARRIER_BYTES + acc + (stages * _round_up(stage_bytes, _ALIGN) if rows else 0)
    per_sm = max(1, min(blocks_per_sm, _SM_SMEM // (smem + 1024)))
    # no more blocks than there are row tiles (staged) or full unrolled
    # steps of every row slot (in place)
    work = -(-n // (rows if rows else slots * _UNROLL))
    grid_x = max(1, min(per_sm * sm_count, work))
    return {
        "grid_x": grid_x, "kt": kt, "copies": copies, "smem": smem,
        "tile_rows": rows, "stages": stages, "stage_bytes": stage_bytes,
    }


def _check_inputs(gids, mask, values, n_groups: int) -> None:
    if gids.dtype != torch.int32 or gids.ndim != 1:
        raise TypeError(f"gids must be int32 [N], got {gids.dtype} {tuple(gids.shape)}")
    if mask.dtype != torch.bool or mask.shape != gids.shape:
        raise TypeError(f"mask must be bool [N], got {mask.dtype} {tuple(mask.shape)}")
    if values.dtype != torch.float32 or values.ndim != 2:
        raise TypeError(
            f"values must be float32 [N, K], got {values.dtype} {tuple(values.shape)}"
        )
    if values.shape[0] != gids.shape[0]:
        raise ValueError("gids and values disagree on N")
    if not 0 < n_groups <= _SMEM_BUDGET // 4:
        # one [G, 1] f32 accumulator column must fit in shared memory
        raise ValueError(f"n_groups out of range: {n_groups}")
    if not (gids.device == mask.device == values.device):
        raise ValueError("gids, mask and values must share one device")


def grouped_sums(gids, mask, values, n_groups: int) -> torch.Tensor:
    """sum of values[:, k] per group over the masked rows: float32 [G, K]."""
    _check_inputs(gids, mask, values, n_groups)
    dev = values.device
    if dev.type == "cpu":
        return grouped_sums_reference(gids, mask, values, n_groups)
    if dev.type != "cuda":
        raise ValueError(f"grouped_sums: unsupported device {dev}")
    if not (gids.is_contiguous() and mask.is_contiguous() and values.is_contiguous()):
        raise ValueError("grouped_sums needs contiguous inputs")
    n, k = values.shape
    if n == 0 or k == 0:
        return torch.zeros((n_groups, k), dtype=torch.float32, device=dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in (gids, mask, values))
    plan = launch_plan(
        n, n_groups, k, torch.cuda.get_device_properties(dev).multi_processor_count,
        aligned=aligned,
    )
    return _launch(gids, mask, values, n_groups, plan)


def _launch(gids, mask, values, n_groups: int, plan: dict) -> torch.Tensor:
    """Both passes on the current stream, for checked inputs and a launch
    plan."""
    dev = values.device
    n, k = values.shape
    out = torch.empty((n_groups, k), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (plan["grid_x"], n_groups, k), dtype=torch.float32, device=dev
    )
    fn = _library().grouped_sums_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            gids.data_ptr(), mask.data_ptr(), values.data_ptr(),
            n, k, n_groups, plan["grid_x"], plan["kt"], plan["copies"],
            plan["tile_rows"], plan["stages"], plan["smem"],
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_sums kernel launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:  # dispatcher lanes launch from several threads
        grouped_sums.launches += 1
    return out


grouped_sums.launches = 0
_LAUNCHES_LOCK = threading.Lock()


def _library():
    from trino_tpu_torch.kernels.build import load

    lib = load("grouped_sums")
    fn = lib.grouped_sums_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib

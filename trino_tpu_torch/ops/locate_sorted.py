"""Sorted-build probe: the join's lower/upper-bound search kernel.

Counterpart of trino_tpu/ops/pallas_probe.py::locate_sorted_pallas (the
Pallas TPU kernel `_probe_kernel`) and its gate `probe_kernel_eligible`.
For a build key plane int64 [cap_b] whose first `n_match` rows are sorted
(a one-element int64 device tensor) and a probe plane int64 [P] with its
`nomatch` flags bool [P], it returns `(start, count)` int64 [P]: the
lower bound of each probe key in build[:n_match] and the length of its
run of equal keys, both 0 where `nomatch`.  Scope: one integer key plane
per side (limb-coded long-decimal and float keys stay on the plain
`ops.join._locate_sorted`); the mesh join gates per join.

On the card `locate_sorted` launches the CUDA C++ kernel in
`csrc/locate_sorted.cu` (built for sm_90a by kernels/build.py):

  * Design: the TPU kernel holds the whole build plane in VMEM for every
    1024-row probe block and runs bit_length(cap_b) fixed iterations.  On
    Hopper a first small kernel gathers every S-th key of the sorted prefix
    (the splitters) into a scratch array; each block of the main kernel
    stages them in shared memory, and each live probe row binary-searches
    the splitters there, then reads the one aligned window of S build keys
    that holds its lower bound (16-byte vector loads at S = 8 or 16) and
    counts the keys below and equal to its own in registers.  A run of
    equal keys that crosses the window's end searches the splitters again
    for its end.  Four probe rows per thread run in lock step over a
    persistent grid.  `n_match` is read on the card: the wrapper never
    synchronises to learn it, so the mesh's deferred chain is not stalled.
    `launch_plan` picks S, the shared memory and the grid from `cap_b`.
  * Bound: memory — P nomatch flags and the keys of the L live rows read
    (P + 8 L bytes: the function need not read a nomatch row's key), P * 16 written,
    plus min(n_match, L) * 8 bytes of build keys once (each live row needs a
    key at its bound; 24.6 MB at the mesh Q3's largest launch: 7.3 us at
    3.35 TB/s).

On a CPU tensor it runs `locate_sorted_reference`, the plain PyTorch
version (the port's `ops.join._locate_sorted` over one plane, the
kernel's bit-exact oracle).  A CUDA tensor launches the kernel or raises:
there is no fallback.  `locate_sorted.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: threads per block of the main kernel and of the splitter gather
#: (csrc/locate_sorted.cu kThreads and its gather launch)
_THREADS = 256
_GATHER_THREADS = 256
#: probe rows per thread of the main kernel, by window S (the kernel's R;
#: 1 for every larger S)
_ROWS = {8: 4, 16: 2}
#: shared memory for the staged splitters: 12,288 keys.  S is the smallest
#: power of two >= 8 whose splitters of a cap_b-row plane fit it.
_SPLITTER_BUDGET = 96 * 1024
#: blocks per SM the persistent grid is sized for (each stages the
#: splitters once).  At 86 registers a thread two are resident at a time;
#: the third splits the probe rows finer, and the card measured it ~5%
#: faster than two (PERF.md).
_BLOCKS_PER_SM = 3
#: the splitter scratch holds at least this many keys: rows without a
#: window read 16 keys there instead of the build plane
_MIN_SPLITTERS = 16
#: shared memory of one SM usable by blocks (H100: 227 KB, less 1 KB the
#: runtime reserves per resident block)
_SM_SMEM = 227 * 1024


def _is_int_plane(t: torch.Tensor) -> bool:
    return (
        t.ndim == 1
        and not t.dtype.is_floating_point
        and not t.dtype.is_complex
        and t.dtype != torch.bool
    )


def probe_kernel_eligible(build_canon, probe_canon) -> bool:
    """Single-plane integer canon on both sides (the kernel's scope)."""
    return (
        len(build_canon) == 1
        and len(probe_canon) == 1
        and _is_int_plane(build_canon[0])
        and _is_int_plane(probe_canon[0])
    )


def locate_sorted_reference(build, n_match, probe, nomatch, cap_b: int):
    """Plain PyTorch version: the port's vectorised lower/upper-bound
    search (ops.join._locate_sorted) over one plane."""
    from trino_tpu_torch.ops.join import _locate_sorted

    locate_sorted_reference.launches += 1
    return _locate_sorted([build], n_match, [probe], nomatch, cap_b=cap_b)


locate_sorted_reference.launches = 0


def _widen(plane: torch.Tensor) -> torch.Tensor:
    """Narrower integer planes compare in int64 (the promotion
    `_canon_probe_device` applies)."""
    return plane if plane.dtype == torch.int64 else plane.to(torch.int64)


def launch_plan(cap_b: int, p: int, sm_count: int,
                splitter_budget: int = _SPLITTER_BUDGET,
                blocks_per_sm: int = _BLOCKS_PER_SM) -> dict:
    """Launch geometry for a build plane of `cap_b` rows and P probe rows:
    the window S = 2**log_s (the smallest power of two >= 8 whose
    ceil(cap_b / S) splitters fit `splitter_budget` bytes), the splitter
    scratch's length (an even count, at least _MIN_SPLITTERS), the main
    kernel's dynamic shared memory, its persistent grid and the gather's
    grid.  Any n_match <= cap_b has at most ceil(cap_b / S) splitters."""
    cap = max(1, int(cap_b))
    log_s = 3
    while True:
        n_spl = -(-cap >> log_s)
        n_even = n_spl + (n_spl & 1)
        if 8 * n_even <= splitter_budget:
            break
        log_s += 1
    s = 1 << log_s
    smem = 8 * n_even
    rows = _ROWS.get(s, 1)
    per_sm = max(1, min(blocks_per_sm, _SM_SMEM // (smem + 1024)))
    chunks = -(-max(1, p) // (_THREADS * rows))
    return {
        "log_s": log_s,
        "s": s,
        "splitters": max(_MIN_SPLITTERS, n_even),
        "smem": smem,
        "rows": rows,
        "grid": max(1, min(per_sm * sm_count, chunks)),
        "gather_grid": max(1, min(-(-n_spl // _GATHER_THREADS), 4 * sm_count)),
    }


def check_aligned(plane: torch.Tensor) -> None:
    """The kernel reads the build plane's windows as 16-byte vectors."""
    if plane.data_ptr() % 16:
        raise ValueError(
            "locate_sorted needs a 16-byte aligned build plane "
            f"(data_ptr {plane.data_ptr():#x})"
        )


def locate_sorted(build, n_match, probe, nomatch, cap_b: int):
    """(start, count) int64 [P] of each probe key's run in build[:n_match]."""
    if not (_is_int_plane(build) and _is_int_plane(probe)):
        raise TypeError(
            f"locate_sorted takes 1-D integer planes, got {build.dtype} "
            f"{tuple(build.shape)} and {probe.dtype} {tuple(probe.shape)}"
        )
    if nomatch.dtype != torch.bool or nomatch.shape != probe.shape:
        raise TypeError(
            f"nomatch must be bool {tuple(probe.shape)}, got {nomatch.dtype} "
            f"{tuple(nomatch.shape)}"
        )
    dev = probe.device
    if not (build.device == dev == nomatch.device):
        raise ValueError("build, probe and nomatch must share one device")
    if dev.type == "cpu":
        return locate_sorted_reference(build, n_match, probe, nomatch, cap_b)
    if dev.type != "cuda":
        raise ValueError(f"locate_sorted: unsupported device {dev}")
    build, probe = _widen(build), _widen(probe)
    if not torch.is_tensor(n_match):
        n_match = torch.tensor(int(n_match), dtype=torch.int64, device=dev)
    nm = n_match.reshape(1)
    if nm.dtype != torch.int64 or nm.device != dev:
        raise TypeError(f"n_match must be an int64 tensor on {dev}")
    if not (build.is_contiguous() and probe.is_contiguous() and nomatch.is_contiguous()):
        raise ValueError("locate_sorted needs contiguous planes")
    check_aligned(build)
    p = probe.shape[0]
    if p == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(max(int(cap_b), build.shape[0]), p, sms)
    return _launch(build, nm, probe, nomatch, plan)


def _launch(build, nm, probe, nomatch, plan: dict):
    """Both kernels on the current stream, for a checked int64 build plane,
    a one-element n_match tensor and a launch plan."""
    dev = probe.device
    p = probe.shape[0]
    start = torch.empty(p, dtype=torch.int64, device=dev)
    count = torch.empty(p, dtype=torch.int64, device=dev)
    splitters = torch.empty(plan["splitters"], dtype=torch.int64, device=dev)
    fn = _library().locate_sorted_i64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            build.data_ptr(), nm.data_ptr(), build.shape[0], plan["log_s"],
            splitters.data_ptr(), plan["gather_grid"], probe.data_ptr(),
            nomatch.data_ptr(), p, plan["grid"], plan["smem"],
            start.data_ptr(), count.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"locate_sorted kernel launch failed: cudaError {err}")
    with _LAUNCHES_LOCK:  # dispatcher lanes launch from several threads
        locate_sorted.launches += 1
    return start, count


locate_sorted.launches = 0
_LAUNCHES_LOCK = threading.Lock()


def _library():
    from trino_tpu_torch.kernels.build import load

    lib = load("locate_sorted")
    fn = lib.locate_sorted_i64
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, ll, i, p, i, p, p, ll, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib

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
    Hopper one thread takes one probe row (grid-stride loop) and runs both
    binary searches as `while (lo < hi)` loops (the same bounds), reading
    the build plane through the read-only cache; a 2^18-row plane (2 MB)
    stays in the 50 MB L2.  `n_match` is read on the card: the wrapper
    never synchronises to learn it, so the mesh's deferred chain is not
    stalled.
  * Bound: memory in principle — P nomatch flags and the keys of the
    L live rows read (P + 8 L bytes; a nomatch row's key is never read),
    P * 16 written, plus n_match * 8 bytes of build keys once (at most
    ~28 MB at P = 2^20, n_match = 2^18: ~8 us at 3.35 TB/s) — but each
    live row makes 2 * log2(n_match) dependent L2 loads, so expect
    latency to bound it.

On a CPU tensor it runs `locate_sorted_reference`, the plain PyTorch
version (the port's `ops.join._locate_sorted` over one plane, the
kernel's bit-exact oracle).  A CUDA tensor launches the kernel or raises:
there is no fallback.  `locate_sorted.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

#: threads per block (csrc/locate_sorted.cu kThreads)
_THREADS = 256
#: resident blocks per SM the grid-stride loop is sized for
_BLOCKS_PER_SM = 8


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
    p = probe.shape[0]
    start = torch.empty(p, dtype=torch.int64, device=dev)
    count = torch.empty(p, dtype=torch.int64, device=dev)
    if p == 0:
        return start, count
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-p // _THREADS), sms * _BLOCKS_PER_SM))
    fn = _library().locate_sorted_i64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            build.data_ptr(), nm.data_ptr(), probe.data_ptr(),
            nomatch.data_ptr(), p, grid, start.data_ptr(), count.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"locate_sorted kernel launch failed: cudaError {err}")
    locate_sorted.launches += 1
    return start, count


locate_sorted.launches = 0


def _library():
    from trino_tpu_torch.kernels.build import load

    lib = load("locate_sorted")
    fn = lib.locate_sorted_i64
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, p, p, p]
        fn.restype = ctypes.c_int
    return lib

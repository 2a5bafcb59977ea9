// Sorted-build probe on Hopper: for every probe row, the run of equal keys
// in the sorted prefix [0, n_match) of a build key plane.
//
//   start[i] = lower_bound(build[0:n_match], probe[i])
//   count[i] = upper_bound(build[0:n_match], probe[i]) - start[i]
//   start[i] = count[i] = 0 where nomatch[i]
//
// Replaces trino_tpu/ops/pallas_probe.py::locate_sorted_pallas (kernel body
// _probe_kernel).  On the TPU each 1024-row grid step holds the whole build
// plane in VMEM and runs bit_length(cap_b) fixed lock-step iterations of both
// searches over its block.  Hopper has no VMEM-sized scratch, so:
//
//   * one thread per probe row, over a grid-stride loop;
//   * the build plane stays in device memory and is read through the
//     read-only data cache (__ldg); a 2^18-row plane is 2 MB and stays in
//     the 50 MB L2, so the searches' dependent loads are L2 hits;
//   * each search is a `while (lo < hi)` loop: it stops as soon as the
//     interval is empty, which gives the same bound as the TPU's fixed
//     bit_length(cap_b) iterations (that count is enough for any
//     n_match <= cap_b, and an empty interval never moves again);
//   * n_match is read from a one-element device tensor, so the caller never
//     synchronises with the card to learn it.
//
// Bound: the function must read P nomatch flags, the probe keys of the L
// live rows (a nomatch row's key is never read) and n_match * 8 bytes of
// build keys once, and write P * 16 bytes: P * 17 + L * 8 + n_match * 8
// bytes, at most ~28 MB (~8 us at 3.35 TB/s) at P = 2^20 and a 2^18-row
// build.  The
// 2 * log2(n_match) dependent L2 loads per row make the kernel latency-bound
// well above that; caching the top levels of the search tree in shared
// memory is later work.
//
// Plain C interface for ctypes: the wrapper (ops/locate_sorted.py) checks
// devices, dtypes and contiguity and allocates start/count with torch.empty;
// the function launches on the given stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
locate_sorted_kernel(const int64_t* __restrict__ build,
                     const int64_t* __restrict__ n_match_ptr,
                     const int64_t* __restrict__ probe,
                     const uint8_t* __restrict__ nomatch, int64_t p,
                     int64_t* __restrict__ start, int64_t* __restrict__ count) {
  const int64_t nm = __ldg(n_match_ptr);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    if (nomatch[i]) {
      start[i] = 0;
      count[i] = 0;
      continue;
    }
    const int64_t key = probe[i];
    // lower bound: first row with build[row] >= key
    int64_t lo = 0, hi = nm;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(build + mid) < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t first = lo;
    // upper bound: first row with build[row] > key, searched from the
    // lower bound on
    hi = nm;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(build + mid) <= key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    start[i] = first;
    count[i] = lo - first;
  }
}

}  // namespace

extern "C" int locate_sorted_i64(const void* build, const void* n_match,
                                 const void* probe, const void* nomatch,
                                 long long p, int grid, void* start,
                                 void* count, void* stream) {
  locate_sorted_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)build, (const int64_t*)n_match, (const int64_t*)probe,
      (const uint8_t*)nomatch, (int64_t)p, (int64_t*)start, (int64_t*)count);
  return (int)cudaGetLastError();
}

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
// searches over its block.  Hopper has no VMEM-sized scratch, and a plain
// binary search over the plane in device memory makes ~2 log2(n_match)
// dependent L2 round trips per row.  This design replaces most of them with
// shared-memory reads:
//
//   * splitter tier: every S-th key of the sorted prefix, splitter[j] =
//     build[S j] (S a power of two >= 8, chosen on the host from cap_b so the
//     splitters of any n_match <= cap_b fit the block's shared memory).  A
//     small first kernel (gather_splitters) writes them once into a compact
//     scratch array; every block of the main kernel copies that array into
//     shared memory with coalesced 16-byte loads.
//   * lower bound: a branchless binary search over the splitters in shared
//     memory (ceil(log2(n_splitters)) steps, the same for every lane) finds
//     the one aligned window of S keys that holds the bound; at S = 8 or 16
//     the window is read as 16-byte vectors and counted in registers (keys
//     < probe, and keys <= probe, both cut at n_match so the INT64_MAX
//     padding never counts); for larger S the window is binary-searched in
//     device memory.
//   * upper bound: the same window's count of keys <= probe.  Only when the
//     whole window is <= probe and the next splitter equals the probe (a run
//     of equal keys that reaches the window's end) does the row search the
//     splitters again, from there, for the first one > probe, and count one
//     more window.  A unique build key (both Q3 joins are FK -> PK) costs no
//     load beyond its window.
//   * every thread carries four probe rows (two at S = 16, one above)
//     through the searches in lock step and issues all their window reads
//     at once, so their shared-memory and L2 latencies overlap; the grid is
//     persistent (a few blocks per SM walk the probe rows grid-stride after
//     staging the splitters once).  A nomatch row reads no build window.
//   * n_match is read from a one-element device tensor by both kernels, so
//     the caller never synchronises with the card to learn it.
//
// Bound: the function must read P nomatch flags, the probe keys of the L
// live rows and min(n_match, L) build keys (each live row needs a key at
// its bound, none twice) once, and write P * 16 bytes:
// P * 17 + L * 8 + min(n_match, L) * 8 bytes, ~24.6 MB (7.3 us at
// 3.35 TB/s) at the mesh Q3's largest launch.  A live row now costs ~13 shared-memory
// loads and one or two L2 sector loads, against ~32 dependent L2 loads
// before, so the kernel is meant to be bound by its streams of probe keys
// and results, not by search latency.
//
// Plain C interface for ctypes: the wrapper (ops/locate_sorted.py) checks
// devices, dtypes, contiguity and 16-byte alignment, allocates start, count
// and the splitter scratch with torch.empty and passes the launch plan; the
// function launches both kernels on the given stream, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp_n_match(const int64_t* nm_ptr, int64_t len) {
  const int64_t nm = __ldg(nm_ptr);
  return nm < 0 ? 0 : (nm > len ? len : nm);
}

__global__ void gather_splitters(const int64_t* __restrict__ build,
                                 const int64_t* __restrict__ nm_ptr,
                                 int64_t len, int log_s,
                                 int64_t* __restrict__ splitters) {
  const int64_t nm = clamp_n_match(nm_ptr, len);
  const int64_t n_spl = (nm + (1 << log_s) - 1) >> log_s;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n_spl;
       j += (int64_t)gridDim.x * blockDim.x) {
    splitters[j] = __ldg(build + (j << log_s));
  }
}

// lo + the number of splitters in sp[lo, n) that are < key (LE: <= key):
// a branchless binary search whose step count depends only on n - lo.
template <bool LE>
__device__ __forceinline__ int splitter_bound(const int64_t* sp, int lo, int n,
                                              int64_t key) {
  if (lo >= n) return lo;
  int base = lo, len = n - lo;
  while (len > 1) {
    const int half = len >> 1;
    const int64_t v = sp[base + half];
    base = (LE ? v <= key : v < key) ? base + half : base;
    len -= half;
  }
  const int64_t v = sp[base];
  return base + (LE ? v <= key : v < key);
}

// Keys < key (lt) and <= key (le) among build[w, min(w + S, nm)), w < nm:
// the 16-byte vector read of the whole window where the plane holds it,
// else scalar reads (VS > 0); a binary search inside the window (VS == 0).
// Inlined: the counts land in the callers' register arrays.
template <int VS>
__device__ __forceinline__ void window_counts(const int64_t* __restrict__ build, int64_t len,
                              int64_t nm, int log_s, int64_t w, int64_t key,
                              int& lt, int& le) {
  lt = 0;
  le = 0;
  if constexpr (VS > 0) {
    if (w + VS <= len) {
      const longlong2* src = reinterpret_cast<const longlong2*>(build + w);
#pragma unroll
      for (int j = 0; j < VS / 2; ++j) {
        const longlong2 v = __ldg(src + j);
        const bool in0 = w + 2 * j < nm, in1 = w + 2 * j + 1 < nm;
        lt += (in0 && v.x < key) + (in1 && v.y < key);
        le += (in0 && v.x <= key) + (in1 && v.y <= key);
      }
    } else {
      for (int64_t i = w; i < nm && i < w + VS; ++i) {
        const int64_t b = __ldg(build + i);
        lt += b < key;
        le += b <= key;
      }
    }
  } else {
    const int64_t wend = w + ((int64_t)1 << log_s);
    const int64_t end = wend < nm ? wend : nm;
    int64_t lo = w, hi = end;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(build + mid) < key) lo = mid + 1; else hi = mid;
    }
    lt = (int)(lo - w);
    hi = end;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(build + mid) <= key) lo = mid + 1; else hi = mid;
    }
    le = (int)(lo - w);
  }
}

template <int VS>
__global__ void __launch_bounds__(kThreads)
locate_sorted_kernel(const int64_t* __restrict__ build,
                     const int64_t* __restrict__ nm_ptr, int64_t len, int log_s,
                     const int64_t* __restrict__ splitters,
                     const int64_t* __restrict__ probe,
                     const uint8_t* __restrict__ nomatch, int64_t p,
                     int64_t* __restrict__ start, int64_t* __restrict__ count) {
  // probe rows in flight per thread: a window of 16 keys takes twice the
  // registers of one of 8; a window searched in device memory takes one
  constexpr int R = VS == 8 ? 4 : (VS == 16 ? 2 : 1);
  extern __shared__ longlong2 smem[];
  const int64_t* sp = reinterpret_cast<const int64_t*>(smem);
  const int64_t nm = clamp_n_match(nm_ptr, len);
  const int S = 1 << log_s;
  const int n_spl = (int)((nm + S - 1) >> log_s);
  // stage the splitters with 16-byte loads (the scratch holds an even
  // count, at least 16)
  const longlong2* spl2 = reinterpret_cast<const longlong2*>(splitters);
  for (int i = threadIdx.x; i < (n_spl + 1) >> 1; i += kThreads) smem[i] = __ldg(spl2 + i);
  __syncthreads();

  const int64_t chunk = (int64_t)kThreads * R;
  for (int64_t base = blockIdx.x * chunk; base < p; base += gridDim.x * chunk) {
    int64_t key[R];
    bool live[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      // the key is read whatever the flag says, so the two loads overlap;
      // a nomatch row's key shares its 32-byte sectors with live rows'
      const int64_t r = base + u * kThreads + threadIdx.x;
      const int64_t rc = r < p ? r : p - 1;
      live[u] = r < p && !nomatch[rc];
      key[u] = probe[rc];
    }
    // lower bound among the splitters, every row in lock step: pos = the
    // number of splitters < key, so the bound lies in the window of S keys
    // that starts at S * max(pos - 1, 0)
    int pos[R];
#pragma unroll
    for (int u = 0; u < R; ++u) pos[u] = 0;
    if (n_spl > 0) {
      int len_s = n_spl;
      while (len_s > 1) {
        const int half = len_s >> 1;
#pragma unroll
        for (int u = 0; u < R; ++u) {
          pos[u] = sp[pos[u] + half] < key[u] ? pos[u] + half : pos[u];
        }
        len_s -= half;
      }
#pragma unroll
      for (int u = 0; u < R; ++u) pos[u] += sp[pos[u]] < key[u];
    }
    int64_t w[R];
    int lt[R], le[R];
    if constexpr (VS > 0) {
      // every row's window read at once: rows without a window (nomatch,
      // n_match = 0, the plane's ragged end) read the splitter scratch
      // instead, and their counts are dropped
      longlong2 v[R][VS / 2];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        w[u] = (int64_t)max(pos[u] - 1, 0) << log_s;
        const bool vec = live[u] && w[u] < nm && w[u] + VS <= len;
        const longlong2* src =
            vec ? reinterpret_cast<const longlong2*>(build + w[u]) : spl2;
#pragma unroll
        for (int j = 0; j < VS / 2; ++j) v[u][j] = __ldg(src + j);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        lt[u] = le[u] = 0;
        if (w[u] + VS <= nm) {  // the whole window lies below n_match
#pragma unroll
          for (int j = 0; j < VS / 2; ++j) {
            lt[u] += (v[u][j].x < key[u]) + (v[u][j].y < key[u]);
            le[u] += (v[u][j].x <= key[u]) + (v[u][j].y <= key[u]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VS / 2; ++j) {
            const bool in0 = w[u] + 2 * j < nm, in1 = w[u] + 2 * j + 1 < nm;
            lt[u] += (in0 && v[u][j].x < key[u]) + (in1 && v[u][j].y < key[u]);
            le[u] += (in0 && v[u][j].x <= key[u]) + (in1 && v[u][j].y <= key[u]);
          }
        }
        if (live[u] && w[u] < nm && w[u] + VS > len) {
          window_counts<VS>(build, len, nm, log_s, w[u], key[u], lt[u], le[u]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        w[u] = (int64_t)max(pos[u] - 1, 0) << log_s;
        lt[u] = le[u] = 0;
        if (live[u] && w[u] < nm) {
          window_counts<VS>(build, len, nm, log_s, w[u], key[u], lt[u], le[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int64_t r = base + u * kThreads + threadIdx.x;
      if (r >= p) continue;
      if (!live[u]) {
        start[r] = 0;
        count[r] = 0;
        continue;
      }
      const int64_t lb = w[u] + lt[u];
      int64_t ub = w[u] + le[u];
      if (le[u] == S && ub < nm) {
        // the whole window is <= key and keys follow it: if the next
        // splitter equals key, a run of equal keys crosses the window's
        // end; the first splitter > key bounds it, and one more window
        // finds its end
        const int j0 = (int)(w[u] >> log_s) + 1;
        if (sp[j0] <= key[u]) {
          const int c2 = splitter_bound<true>(sp, j0, n_spl, key[u]);
          const int64_t w2 = (int64_t)(c2 - 1) << log_s;
          int lt2, le2;
          window_counts<VS>(build, len, nm, log_s, w2, key[u], lt2, le2);
          ub = w2 + le2;
        }
      }
      start[r] = lb;
      count[r] = ub - lb;
    }
  }
}

template <int VS>
int launch(const int64_t* build, const int64_t* nm, int64_t len, int log_s,
           int64_t* splitters, int gather_grid, const int64_t* probe,
           const uint8_t* nomatch, int64_t p, int grid, int smem,
           int64_t* start, int64_t* count, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      locate_sorted_kernel<VS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gather_splitters<<<gather_grid, 256, 0, s>>>(build, nm, len, log_s, splitters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  locate_sorted_kernel<VS><<<grid, kThreads, smem, s>>>(
      build, nm, len, log_s, splitters, probe, nomatch, p, start, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int locate_sorted_i64(const void* build, const void* n_match,
                                 long long len, int log_s, void* splitters,
                                 int gather_grid, const void* probe,
                                 const void* nomatch, long long p, int grid,
                                 int smem, void* start, void* count,
                                 void* stream) {
  auto* b = (const int64_t*)build;
  auto* nm = (const int64_t*)n_match;
  auto* spl = (int64_t*)splitters;
  auto* pr = (const int64_t*)probe;
  auto* no = (const uint8_t*)nomatch;
  auto* st = (int64_t*)start;
  auto* ct = (int64_t*)count;
  auto s = (cudaStream_t)stream;
  if (log_s == 3)
    return launch<8>(b, nm, len, log_s, spl, gather_grid, pr, no, p, grid, smem, st, ct, s);
  if (log_s == 4)
    return launch<16>(b, nm, len, log_s, spl, gather_grid, pr, no, p, grid, smem, st, ct, s);
  return launch<0>(b, nm, len, log_s, spl, gather_grid, pr, no, p, grid, smem, st, ct, s);
}

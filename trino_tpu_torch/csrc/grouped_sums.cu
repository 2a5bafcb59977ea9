// Masked grouped sums on Hopper: out[g, k] = sum of values[r, k] over the
// rows r with mask[r] set and gids[r] == g.
//
// Replaces trino_tpu/ops/pallas_agg.py::grouped_sums_pallas (kernel body
// _agg_kernel), which builds a one-hot tile per 2048-row block and carries a
// [G, K] accumulator in VMEM across the TPU's sequential grid.  H100 blocks run
// in parallel and in no order, so nothing carries across blocks here:
//
//   pass 1 (grouped_sums_partial): a persistent grid of a few blocks per
//     SM.  Each block is one producer warp and kConsumerWarps accumulating
//     warps around a ring of `stages` staged tiles in shared memory.  One
//     producer thread fills each stage with Hopper's 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes), three copies per
//     tile: its values, group ids and masks (tile_rows * K * 4, tile_rows * 4
//     and tile_rows bytes; tile_rows is a multiple of 16, so every copy is a
//     multiple of 16 bytes from a 16-byte aligned address).  Each stage has
//     a "full" mbarrier the copies complete and an "empty" mbarrier every
//     consumer warp arrives on once it has accumulated the tile; the
//     producer refills a stage as soon as it is empty, so up to `stages`
//     tiles are in flight while the consumers work.  The block's tiles are
//     the full tiles tile = blockIdx.x + i * gridDim.x.  For the
//     accumulation each consumer warp splits into R = 32 / kt row slots of
//     kt lanes (lane -> one value column), and every row slot adds into its
//     own private [G, kt] f32 accumulator in shared memory when the copies
//     fit (one writer per address: plain adds, no contention and a fixed
//     summation order); when they do not, slots share copies through
//     shared-memory atomics.  A slot reads the group ids, masks and values
//     of kRowBatch rows before it adds any of them, so their shared-memory
//     latencies overlap; each add is still a dependent read-modify-write,
//     so the block carries 16 consumer warps to keep enough of them in
//     flight.  The rows past the last full tile (bytes not a
//     multiple of 16) take plain loads, spread over every block's slots.
//     The block then sums its copies in a fixed order and writes one
//     [G, K] partial to scratch[block].  When K is wider than one
//     accumulator column tile (kt < K, grid.y tiles the columns), or an
//     input is not 16-byte aligned (tile_rows = 0), rows are read in place
//     instead of staged, kUnroll rows in flight per slot.
//   pass 2 (grouped_sums_final): one block per output cell sums the block
//     partials, each thread a fixed stride of them, then a fixed shuffle
//     tree: deterministic.  It stays a second launch.
//
// Bound: memory.  The function must read N * (4 + 1) bytes of group ids and
// masks plus 4K bytes per live row, and write 4 * G * K; at Q1's shape
// (N = 2^20, K = 11, 78% of rows live) that is ~41 MB, 12.3 us at 3.35
// TB/s.  Staged tiles read dead rows' values too (N * (4K + 5) bytes in all,
// ~51 MB), so the kernel's ceiling at that shape is ~0.8 of the bound.
// Before this design each block copied one 256-row tile, waited for all of
// it, then accumulated one row at a time: nothing was in flight while it
// accumulated, and the kernel was latency-bound at ~3x the bound.  On the
// H100 a plain one-pass read of the same values (torch.sum) runs at ~2.1
// TB/s, not 3.35, so a one-pass kernel's floor here is ~1.6x the bound.  Sums stay in f32 on the
// CUDA cores: the tensor cores would round the values to TF32.  Counts
// (value 1.0) are exact below 2^24 per group, the same limit the caller's
// gate enforces.
//
// Plain C interface for ctypes: the wrapper (ops/grouped_sums.py) validates
// shapes, types and alignment, allocates out and scratch with torch.empty,
// and passes the launch plan (grid, column tile, accumulator copies, tile
// rows, stages, shared-memory bytes); the function launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kRowBatch = 4;  // staged rows per slot read ahead of their adds
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;  // full[], empty[]
constexpr int kAlign = 128;

__device__ __forceinline__ int round_up(int x, int a) { return (x + a - 1) / a * a; }

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          shared_addr(bar))
      : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.  A
// wait that never ends is a fault of the protocol: after ~2^28 polls the
// kernel traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// 1-D bulk copy global -> shared that completes `bytes` on the barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// Adds this lane's columns of one row (read from v) into dst.  With a
// private accumulator copy the lane is the only writer of its addresses, so
// a plain add is exact; shared copies take shared-memory atomics.
__device__ __forceinline__ void add_row(float* dst, const float* v, int col0,
                                        int col_step, int kw, bool exclusive) {
  if (exclusive) {
    for (int c = col0; c < kw; c += col_step) dst[c] += v[c];
  } else {
    for (int c = col0; c < kw; c += col_step) atomicAdd(dst + c, v[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_sums_partial(const int32_t* __restrict__ gids,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ values,
                     int64_t n, int k, int g, int kt, int copies,
                     int tile_rows, int stages,
                     float* __restrict__ scratch) {
  // [full[kMaxStages], empty[kMaxStages]] [copies][g][kt] accumulators
  // [stages] x (tile values [tile_rows][k], group ids, masks)
  extern __shared__ __align__(kAlign) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* acc = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int cell = g * kt;
  unsigned char* ring = smem + kBarrierBytes + round_up(copies * cell * 4, kAlign);
  const int stage_bytes = tile_rows * (4 * k + 4 + 1);
  const int stage_stride = round_up(stage_bytes, kAlign);

  const int k0 = blockIdx.y * kt;
  const int kw = min(kt, k - k0);  // width of this block's column tile
  for (int i = threadIdx.x; i < copies * cell; i += blockDim.x) acc[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);                // the producer's expect_tx
      mbar_init(empty + s, kConsumerWarps);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // lanes -> (row slot, column); a tile wider than a warp walks its columns
  // with one row slot per warp
  const int rows_per_step = kw <= 32 ? 32 / kw : 1;
  const int slot = kw <= 32 ? lane / kw : 0;
  const int col0 = kw <= 32 ? lane % kw : lane;
  const int col_step = kw <= 32 ? kw : 32;
  const bool active = slot < rows_per_step;
  const int slots = kConsumerWarps * rows_per_step;
  const int my_slot = warp * rows_per_step + slot;
  const bool exclusive = copies >= slots;
  float* my = acc + (my_slot % copies) * cell;

  if (tile_rows > 0) {
    const int64_t nfull = n / tile_rows;
    if (warp == kConsumerWarps) {
      // the producer: one thread keeps up to `stages` tiles in flight
      if (lane == 0) {
        int it = 0;
        for (int64_t tile = blockIdx.x; tile < nfull; tile += gridDim.x, ++it) {
          const int s = it % stages;
          const int round = it / stages;
          if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
          unsigned char* st = ring + s * stage_stride;
          const int64_t t0 = tile * tile_rows;
          mbar_arrive_expect_tx(full + s, (uint32_t)stage_bytes);
          bulk_copy(st, values + t0 * k, tile_rows * k * 4, full + s);
          bulk_copy(st + tile_rows * k * 4, gids + t0, tile_rows * 4, full + s);
          bulk_copy(st + tile_rows * (k + 1) * 4, mask + t0, tile_rows, full + s);
        }
      }
    } else {
      int it = 0;
      for (int64_t tile = blockIdx.x; tile < nfull; tile += gridDim.x, ++it) {
        const int s = it % stages;
        mbar_wait(full + s, (it / stages) & 1);
        const unsigned char* st = ring + s * stage_stride;
        const float* tile_v = reinterpret_cast<const float*>(st);
        const int32_t* tile_g = reinterpret_cast<const int32_t*>(st + tile_rows * k * 4);
        const uint8_t* tile_m = st + tile_rows * (k + 1) * 4;
        if (active && kw <= 32 && exclusive) {
          // one column per lane, a private copy: kRowBatch rows per slot,
          // every shared-memory read of the batch issued before its adds
          for (int r0 = my_slot; r0 < tile_rows; r0 += slots * kRowBatch) {
            int gi[kRowBatch];
            float v[kRowBatch];
#pragma unroll
            for (int u = 0; u < kRowBatch; ++u) {
              const int r = min(r0 + u * slots, tile_rows - 1);
              const int gg = tile_g[r];
              const bool ok = r0 + u * slots < tile_rows && tile_m[r] &&
                              (unsigned)gg < (unsigned)g;
              v[u] = tile_v[r * k + col0];
              gi[u] = ok ? gg : -1;
            }
#pragma unroll
            for (int u = 0; u < kRowBatch; ++u) {
              if (gi[u] >= 0) my[gi[u] * kt + col0] += v[u];
            }
          }
        } else if (active) {
          for (int r = my_slot; r < tile_rows; r += slots) {
            const int gi = tile_g[r];
            if (tile_m[r] && (unsigned)gi < (unsigned)g) {
              add_row(my + gi * kt, tile_v + r * k, col0, col_step, kw, exclusive);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
      // the rows past the last full tile, read in place
      if (active) {
        for (int64_t row = nfull * tile_rows + (int64_t)blockIdx.x * slots + my_slot;
             row < n; row += (int64_t)gridDim.x * slots) {
          const int gi = gids[row];
          if (mask[row] && (unsigned)gi < (unsigned)g) {
            add_row(my + gi * kt, values + row * k, col0, col_step, kw, exclusive);
          }
        }
      }
    }
  } else if (warp < kConsumerWarps && active) {
    const int64_t stride = (int64_t)gridDim.x * slots;
    for (int64_t base = (int64_t)blockIdx.x * slots + my_slot; base < n;
         base += stride * kUnroll) {
      bool ok[kUnroll];
      int gi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t row = base + u * stride;
        const bool in = row < n;
        ok[u] = in && mask[row] != 0;
        gi[u] = in ? gids[row] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && (unsigned)gi[u] < (unsigned)g) {
          add_row(my + gi[u] * kt, values + (base + u * stride) * k + k0,
                  col0, col_step, kw, exclusive);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < g * kw; i += blockDim.x) {
    const int gi = i / kw;
    const int c = i - gi * kw;
    float s = 0.f;
    for (int cp = 0; cp < copies; ++cp) s += acc[cp * cell + gi * kt + c];
    scratch[((int64_t)blockIdx.x * g + gi) * k + k0 + c] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_sums_final(const float* __restrict__ scratch, int blocks, int gk,
                   float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  const int cell = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    s += scratch[(int64_t)b * gk + cell];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
    out[cell] = t;
  }
}

}  // namespace

extern "C" int grouped_sums_f32(const void* gids, const void* mask,
                                const void* values, long long n, int k, int g,
                                int grid_x, int kt, int copies, int tile_rows,
                                int stages, int smem, void* scratch, void* out,
                                void* stream) {
  if (stages < 1 || stages > kMaxStages) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_sums_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(grid_x, (k + kt - 1) / kt);
  grouped_sums_partial<<<grid, kThreads, smem, s>>>(
      (const int32_t*)gids, (const uint8_t*)mask, (const float*)values,
      (int64_t)n, k, g, kt, copies, tile_rows, stages, (float*)scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grouped_sums_final<<<g * k, kThreads, 0, s>>>((const float*)scratch, grid_x,
                                                g * k, (float*)out);
  return (int)cudaGetLastError();
}

// K6: count-aware scatter-add of overflow gradient rows.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _scatter_overflow_kernel, launched by _scatter_with_plan (the occurrence
// plan's entries beyond its m per-surfel columns) and by
// _reduce_rows_with_ranksum (the real entries spilled past a truncated
// ranksum plan).
//
// dF[ids[e]] += rows[slots[e]] for e < n_ov, into the zeroed pool
// dF [N+1, 16].  The gather of each entry's row from the per-slot rows is
// done here, so no gathered copy of the overflow rows is stored.  n_ov is
// a device scalar, read by the kernel itself, so the host never waits for
// it.
//
// Bound on the H100: bytes.  It reads n_ov entries of a 64-byte row, a
// 4-byte slot and a 4-byte id, and writes the pool once.
//
// Design: the plans list their entries sorted by surfel id, and the
// overflow belongs to the few surfels that cover many tiles, so long runs
// of one id are the rule.  Scalar atomics per entry would serialise each
// run on the same 16 floats in L2.  Instead one thread holds one entry's
// row (four 16-byte loads) and the block sums each run before any atomic:
//   * in a warp, a neighbour compare of ids marks the run heads, and a
//     segmented shuffle scan over the 16 columns, only as deep as the
//     warp's longest run, leaves each run's sum at its last lane;
//   * across the block's 8 warps, each warp's last run sum and its first
//     and last ids go to shared memory; the last lane of a warp's first run
//     adds the sums of the earlier warps that the run spans;
//   * the last lane of each run then issues one float4 atomic per quad
//     (sm_90's vector atomics), unless its run goes on into the next warp
//     of the block.  A run pays one atomic row per block it touches.
// Unsorted ids give the same sums, with more atomics.  Each block reads
// n_ov once and exits whole if it starts past it.  A quad of exact zeros
// is not added: it changes no sum.  The sum order, and so the last bits,
// vary from run to run, as with any float atomics.
#include <cuda_runtime.h>

constexpr int OV_THREADS = 256;
constexpr int OV_WARPS = OV_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void add_quad(float* dst, const float* v) {
  const float4 q = make_float4(v[0], v[1], v[2], v[3]);
  if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(dst), q);
}

__global__ void __launch_bounds__(OV_THREADS)
scatter_overflow_kernel(const float4* __restrict__ rows,
                        const int* __restrict__ slots,
                        const int* __restrict__ ids,
                        const int* __restrict__ n_ov,
                        float* __restrict__ dF) {
  __shared__ int s_n;
  __shared__ int first_id[OV_WARPS], last_id[OV_WARPS];
  __shared__ unsigned heads_of[OV_WARPS];
  __shared__ float tail_sum[OV_WARPS][16];
  if (threadIdx.x == 0) s_n = __ldg(n_ov);
  __syncthreads();
  const int n = s_n;
  const int base = blockIdx.x * OV_THREADS;
  if (base >= n) return;
  const int e = base + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int id = -1;                          // entries past n_ov: no real id
  float v[16];
  if (e < n) {
    id = __ldg(ids + e);
    const float4* r = rows + (size_t)__ldg(slots + e) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = __ldg(r + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = 0.0f;
  }

  // runs of equal id within the warp: heads, each lane's run start, and a
  // segmented inclusive scan as deep as the longest run
  const int id_prev = __shfl_up_sync(FULL, id, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || id != id_prev);
  const int start = 31 - __clz(heads & (FULL >> (31 - lane)));
  const unsigned longest = __reduce_max_sync(FULL, (unsigned)(lane - start));
  for (int d = 1; d <= (int)longest; d <<= 1) {
    const bool take = lane - d >= start;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float o = __shfl_up_sync(FULL, v[c], d);
      if (take) v[c] += o;
    }
  }

  // the block's carry of runs that cross warp edges
  if (lane == 0) {
    first_id[warp] = id;
    heads_of[warp] = heads;
  }
  if (lane == 31) {
    last_id[warp] = id;
#pragma unroll
    for (int c = 0; c < 16; ++c) tail_sum[warp][c] = v[c];
  }
  __syncthreads();
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (!tail || id < 0) return;
  if (lane == 31 && warp + 1 < OV_WARPS && first_id[warp + 1] == id)
    return;                             // the run goes on: carried forward
  if (start == 0) {
    for (int w = warp - 1; w >= 0 && last_id[w] == id; --w) {
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] += tail_sum[w][c];
      if (heads_of[w] != 1u) break;     // warp w holds more than this run
    }
  }
  float* dst = dF + (size_t)id * 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) add_quad(dst + 4 * q, v + 4 * q);
}

// rows [R, 16] 16-byte aligned; slots, ids [n_entries] (the capacity:
// entries at or past *n_ov are never read).
extern "C" int launch_scatter_overflow(const float* rows, const int* slots,
                                       const int* ids, const int* n_ov,
                                       float* dF, int n_entries,
                                       cudaStream_t stream) {
  if (n_entries == 0) return 0;
  const int blocks = (n_entries + OV_THREADS - 1) / OV_THREADS;
  scatter_overflow_kernel<<<blocks, OV_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), slots, ids, n_ov, dF);
  return (int)cudaGetLastError();
}

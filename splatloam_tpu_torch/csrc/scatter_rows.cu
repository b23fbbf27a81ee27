// K4 and K10: scatter-add of per-slot gradient rows by surfel id.
//
// K4 replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _scatter_rows_kernel, K10 its multi-tile variant
// _scatter_rows_kernel_batched (``tps`` tiles per grid step, selected by
// RenderParams.scatter_tps under scatter="rmw").
//
// dF[lists[t, j]] += dFg[t, j] for j < counts[t]; padding slots are
// skipped.  Both compute the same sums with one kernel and one launch.
//
// Bound on the H100: bytes.  It reads each real slot's 64-byte row and
// 4-byte id and writes each touched surfel's 64-byte row.
//
// Design: each block takes one 64-slot slice of one tile, one thread per
// (slot, 16-byte quad): one float4 load of dFg and one float4 atomic add
// (sm_90's vector atomics), 4 atomics per 64-byte row.  Tiles run along
// the grid's x (up to 2^31 - 1 of them) and slices along its y (16 at
// 1024 slots); at 1024 tiles of 768 slots that is 12,288 blocks of 8
// warps, so every SM holds blocks.  A slice past its tile's count exits
// as a whole block, a thread past it issues no load and no atomic, and no
// thread divides.  A quad of exact zeros (a chunk the forward skipped) is
// not added: it changes no sum.  K10's tps names no grid step here: the
// TPU's reason for it, fewer grid steps, has no cost to amortise on the
// card, so K10 is this launch under another name.  The TPU's serial
// read-modify-write over a VMEM-resident pool becomes hardware float
// atomics in L2; the sum order, and so the last bits, vary from run to
// run.
#include <cuda_runtime.h>

// slots per block: 64 slots x 4 quads = 256 threads
constexpr int TILE_SLICE = 64;

__global__ void __launch_bounds__(4 * TILE_SLICE)
scatter_rows_tiles_kernel(const float4* __restrict__ dFg,
                          const int* __restrict__ lists,
                          const int* __restrict__ counts,
                          float* __restrict__ dF, int K) {
  const int t = blockIdx.x;
  const int n = __ldg(counts + t);
  const int slot = blockIdx.y * TILE_SLICE + (threadIdx.x >> 2);
  if (slot >= n) return;
  const int quad = threadIdx.x & 3;
  const size_t s = (size_t)t * K + slot;
  const float4 v = __ldg(dFg + s * 4 + quad);
  if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(dF + (size_t)__ldg(lists + s) * 16)
                  + quad, v);
}

// dFg 16-byte aligned; K at most 65,535 * 64 slots.
extern "C" int launch_scatter_rows(const float* dFg, const int* lists,
                                   const int* counts, float* dF,
                                   int n_tiles, int K, cudaStream_t stream) {
  if (n_tiles == 0 || K == 0) return 0;
  const dim3 grid((unsigned)n_tiles,
                  (unsigned)((K + TILE_SLICE - 1) / TILE_SLICE));
  scatter_rows_tiles_kernel<<<grid, 4 * TILE_SLICE, 0, stream>>>(
      reinterpret_cast<const float4*>(dFg), lists, counts, dF, K);
  return (int)cudaGetLastError();
}

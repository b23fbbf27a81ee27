// K4 and K10: scatter-add of per-slot gradient rows by surfel id.
//
// K4 replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _scatter_rows_kernel, K10 its multi-tile variant
// _scatter_rows_kernel_batched (``tps`` tiles per grid step, selected by
// RenderParams.scatter_tps under scatter="rmw").
//
// dF[lists[t, j]] += dFg[t, j] for j < counts[t]; padding slots are
// skipped.  Both compute the same sums.
//
// Bound on the H100: bytes.  It reads each real slot's 64-byte row and
// 4-byte id and writes each touched surfel's 64-byte row.
//
// Design, K4: one thread per (slot, column) over all T*K slots, so a warp
// reads two whole rows with coalesced loads and its atomic adds land on
// two contiguous 64-byte rows; threads of padding slots exit at once.
// Design, K10: tps is only the tile group a block's y-index covers; the
// TPU's reason for it (fewer grid steps) has no cost to amortise here.
// Each block takes one 64-slot slice of one tile (x-index = tile in the
// group times slices per tile, plus the slice), one thread per (slot,
// 16-byte quad): one float4 load of dFg and one float4 atomic add (sm_90's
// vector atomics), 4 atomics per 64-byte row instead of 16.  At 1024
// tiles of 768 slots that is 12,288 blocks of 8 warps at any tps, so
// every SM holds blocks; a slice past its tile's count exits as a whole
// block, a thread past it issues no load and no atomic, and no thread
// divides by K.  A quad of exact zeros (a chunk the forward skipped) is
// not added: it changes no sum.  In both the TPU's serial
// read-modify-write over a VMEM-resident pool becomes hardware float
// atomics in L2; the sum order, and so the last bits, vary from run to
// run.
#include <cuda_runtime.h>

__global__ void scatter_rows_kernel(const float* __restrict__ dFg,
                                    const int* __restrict__ lists,
                                    const int* __restrict__ counts,
                                    float* __restrict__ dF, int K,
                                    long long n_elems) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_elems) return;
  const long long slot = idx >> 4;
  const int k = (int)(idx & 15);
  const int t = (int)(slot / K);
  const int j = (int)(slot % K);
  if (j >= counts[t]) return;
  atomicAdd(dF + (size_t)lists[slot] * 16 + k, dFg[idx]);
}

// slots per K10 block: 64 slots x 4 quads = 256 threads
constexpr int TILE_SLICE = 64;

__global__ void __launch_bounds__(4 * TILE_SLICE)
scatter_rows_tiles_kernel(const float4* __restrict__ dFg,
                          const int* __restrict__ lists,
                          const int* __restrict__ counts,
                          float* __restrict__ dF, int K, int tps,
                          int slices) {
  const int t = blockIdx.y * tps + blockIdx.x / slices;
  const int n = __ldg(counts + t);
  const int slot = (blockIdx.x % slices) * TILE_SLICE + (threadIdx.x >> 2);
  if (slot >= n) return;
  const int quad = threadIdx.x & 3;
  const size_t s = (size_t)t * K + slot;
  const float4 v = __ldg(dFg + s * 4 + quad);
  if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(dF + (size_t)__ldg(lists + s) * 16)
                  + quad, v);
}

extern "C" int launch_scatter_rows(const float* dFg, const int* lists,
                                   const int* counts, float* dF,
                                   int n_tiles, int K, cudaStream_t stream) {
  const long long n_elems = (long long)n_tiles * K * 16;
  if (n_elems == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_elems + threads - 1) / threads;
  scatter_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      dFg, lists, counts, dF, K, n_elems);
  return (int)cudaGetLastError();
}

// n_tiles must be a multiple of tps, n_tiles / tps at most 65,535, and
// dFg 16-byte aligned.
extern "C" int launch_scatter_rows_tps(const float* dFg, const int* lists,
                                       const int* counts, float* dF,
                                       int n_tiles, int K, int tps,
                                       cudaStream_t stream) {
  if (n_tiles == 0 || K == 0) return 0;
  const int slices = (K + TILE_SLICE - 1) / TILE_SLICE;
  const dim3 grid((unsigned)(tps * slices), (unsigned)(n_tiles / tps));
  scatter_rows_tiles_kernel<<<grid, 4 * TILE_SLICE, 0, stream>>>(
      reinterpret_cast<const float4*>(dFg), lists, counts, dF, K, tps,
      slices);
  return (int)cudaGetLastError();
}

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
// Design, K10: one block per tps consecutive tiles, its threads striding
// over each tile's real (slot, column) pairs in turn, so no thread is
// spent on padding slots.  What carries over from the TPU kernel is the
// block's span of tiles, not its per-grid-step amortisation.  In both the
// TPU's serial read-modify-write over a VMEM-resident pool becomes
// hardware float atomics in L2; the sum order, and so the last bits, vary
// from run to run.
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

__global__ void scatter_rows_tiles_kernel(const float* __restrict__ dFg,
                                          const int* __restrict__ lists,
                                          const int* __restrict__ counts,
                                          float* __restrict__ dF, int K,
                                          int tps) {
  for (int g = 0; g < tps; ++g) {
    const int t = blockIdx.x * tps + g;
    const size_t base = (size_t)t * K;
    const int n = counts[t] * 16;
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
      atomicAdd(dF + (size_t)lists[base + (idx >> 4)] * 16 + (idx & 15),
                dFg[base * 16 + idx]);
  }
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

// n_tiles must be a multiple of tps.
extern "C" int launch_scatter_rows_tps(const float* dFg, const int* lists,
                                       const int* counts, float* dF,
                                       int n_tiles, int K, int tps,
                                       cudaStream_t stream) {
  if (n_tiles == 0) return 0;
  scatter_rows_tiles_kernel<<<n_tiles / tps, 256, 0, stream>>>(
      dFg, lists, counts, dF, K, tps);
  return (int)cudaGetLastError();
}

// K9: scatter-add of every flat slot's gradient row by slot id.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _scatter_rows_kernel_flat (launched by _scatter_rows_flat).
//
// dF[ids[j]] += rows[j] for every flat slot j, into the zeroed pool
// dF [R, 16]; pad slots name a view's dummy row N, which the caller
// discards.  No counts: the flat layout has none.
//
// Bound on the H100: bytes.  It reads every slot's 64-byte row and 4-byte
// id and writes each touched pool row.
//
// Design: one thread per (slot, column), as K4, so a warp reads two whole
// rows with coalesced loads and its atomic adds land on two contiguous
// 64-byte rows.  An add of exactly 0 is skipped: it changes no sum
// (x + 0 = x, and the pool starts at +0), and the rows of pads, of dead
// chunks and of the unused budget are all zero, so the dummy rows, which
// every pad names, see no atomic traffic.  The TPU kernel's serial
// read-modify-write over a VMEM-resident pool becomes hardware float
// atomics in L2; the sum order, and so the last bits, vary from run to
// run.
#include <cuda_runtime.h>

__global__ void scatter_rows_flat_kernel(const float* __restrict__ rows,
                                         const int* __restrict__ ids,
                                         float* __restrict__ dF,
                                         long long n_elems) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_elems) return;
  const float v = rows[idx];
  if (v != 0.0f) atomicAdd(dF + (size_t)ids[idx >> 4] * 16 + (idx & 15), v);
}

extern "C" int launch_scatter_rows_flat(const float* rows, const int* ids,
                                        float* dF, int n_slots,
                                        cudaStream_t stream) {
  const long long n_elems = (long long)n_slots * 16;
  if (n_elems == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_elems + threads - 1) / threads;
  scatter_rows_flat_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      rows, ids, dF, n_elems);
  return (int)cudaGetLastError();
}

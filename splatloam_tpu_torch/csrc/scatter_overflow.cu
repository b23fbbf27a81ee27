// K6: count-aware scatter-add of overflow gradient rows.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _scatter_overflow_kernel, launched by _scatter_with_plan (the occurrence
// plan's entries beyond its m per-surfel columns) and by
// _reduce_rows_with_ranksum (the real entries spilled past a truncated
// ranksum plan).
//
// dF[ids[e]] += rows[e] for e < n_ov, into the zeroed pool dF [N+1, 16].
// n_ov is a device scalar, read by the kernel itself, so the host never
// waits for it.
//
// Bound on the H100: bytes.  It reads n_ov entries of a 64-byte row and a
// 4-byte id and writes each touched surfel's 64-byte row.
//
// Design: one thread per (entry, column) over the whole overflow capacity,
// so a warp reads two whole rows with coalesced loads and its atomic adds
// land on two contiguous 64-byte rows; threads of entries at or past n_ov
// exit at once.  The TPU kernel's serial RMW over a VMEM-resident pool
// becomes hardware float atomics in L2; the sum order, and so the last
// bits, vary from run to run.
#include <cuda_runtime.h>

__global__ void scatter_overflow_kernel(const float* __restrict__ rows,
                                        const int* __restrict__ ids,
                                        const int* __restrict__ n_ov,
                                        float* __restrict__ dF,
                                        long long n_elems) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_elems) return;
  const long long e = idx >> 4;
  if (e >= __ldg(n_ov)) return;
  atomicAdd(dF + (size_t)ids[e] * 16 + (idx & 15), rows[idx]);
}

extern "C" int launch_scatter_overflow(const float* rows, const int* ids,
                                       const int* n_ov, float* dF,
                                       int n_entries, cudaStream_t stream) {
  const long long n_elems = (long long)n_entries * 16;
  if (n_elems == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_elems + threads - 1) / threads;
  scatter_overflow_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      rows, ids, n_ov, dF, n_elems);
  return (int)cudaGetLastError();
}

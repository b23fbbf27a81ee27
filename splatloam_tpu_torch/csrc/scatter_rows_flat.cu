// K9: scatter-add of the flat slots' gradient rows by slot id.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _scatter_rows_kernel_flat (launched by _scatter_rows_flat).
//
// dF[ids[j]] += rows[j] for the flat slots j that some tile owns and that
// are not pads, into the zeroed pool dF [B*R, 16] (R rows per view): slot
// j of view v is owned when j < starts[v, T], and a pad when its id is
// the view's dummy row v*R + R - 1.  No other slot's row is read: K8
// leaves the rows of the budget chunks past starts[v, T] unwritten, and
// the pads' rows, all zero, would only add into the dummy rows, which the
// caller discards; here they stay 0.  K8 writes every other row, zeros
// included, in the same call (raster_bwd_seg.cuh, Out::FLAT), so that the
// wrapper of K8 fills nothing.
//
// Bound on the H100: bytes.  It reads each owned slot's 4-byte id, the
// 64-byte row of each that is not a pad, and writes each touched pool row.
//
// Design: K4's (scatter_rows.cu).  Each block takes one 64-slot slice of
// one view's slots, one thread per (slot, 16-byte quad): one float4 load
// of the row and one float4 atomic add (sm_90's vector atomics), 4
// atomics per 64-byte row.  Slices run along the grid's x, views along
// its y.  A slice past its view's owned slots exits as a whole block, a
// thread past them or on a pad issues no row load and no atomic, and a
// quad of exact zeros (a dead chunk's slot) is not added: it changes no
// sum.  The TPU kernel's serial read-modify-write over a VMEM-resident
// pool becomes hardware float atomics in L2; the sum order, and so the
// last bits, vary from run to run.
#include <cuda_runtime.h>

// slots per block: 64 slots x 4 quads = 256 threads
constexpr int FLAT_SLICE = 64;

__global__ void __launch_bounds__(4 * FLAT_SLICE)
scatter_rows_flat_kernel(const float4* __restrict__ rows,
                         const int* __restrict__ ids,
                         const int* __restrict__ starts,
                         float* __restrict__ dF, int E, int tiles_per_view,
                         int rows_per_view) {
  const int v = blockIdx.y;
  const int owned = __ldg(starts + (size_t)v * (tiles_per_view + 1) +
                          tiles_per_view);
  const int j = blockIdx.x * FLAT_SLICE + (threadIdx.x >> 2);
  if (j >= owned) return;
  const size_t s = (size_t)v * E + j;
  const int id = __ldg(ids + s);
  if (id == (v + 1) * rows_per_view - 1) return;
  const int quad = threadIdx.x & 3;
  const float4 q = __ldg(rows + s * 4 + quad);
  if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f)
    atomicAdd(reinterpret_cast<float4*>(dF + (size_t)id * 16) + quad, q);
}

// rows 16-byte aligned; n_views up to 65,535.
extern "C" int launch_scatter_rows_flat(const float* rows, const int* ids,
                                        const int* starts, float* dF,
                                        int n_views, int E,
                                        int tiles_per_view,
                                        int rows_per_view,
                                        cudaStream_t stream) {
  if (n_views == 0 || E == 0) return 0;
  const dim3 grid((unsigned)((E + FLAT_SLICE - 1) / FLAT_SLICE),
                  (unsigned)n_views);
  scatter_rows_flat_kernel<<<grid, 4 * FLAT_SLICE, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), ids, starts, dF, E,
      tiles_per_view, rows_per_view);
  return (int)cudaGetLastError();
}

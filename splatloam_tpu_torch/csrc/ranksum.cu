// K3: segmented sum of id-sorted gradient rows into dense rank rows.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_ranksum_kernel
// (and the row gather in front of it in _reduce_rows_with_ranksum).
//
// dFc[ranks[e]] += rows[pos[e]] for every entry e with ranks[e] >= 0.  The
// ranks come from the rebin-time plan (ops/rasterizer/binning.py:
// build_ranksum_plan): entries sorted by surfel id, dense ranks over the
// ids that occur, non-decreasing up to a tail of -1 pads.  The caller then
// reads each surfel's row as dFc[rank_of_id].
//
// Bound on the H100: bytes.  Each entry reads one 64-byte row at a random
// slot position plus 8 bytes of plan, and each distinct rank writes one
// 64-byte row.
//
// Design: one thread per entry, loading its whole row with four float4
// loads.  Within a warp, a segmented inclusive scan keyed by rank (five
// shuffle steps; equal neighbouring ranks of a sorted sequence mean the
// same segment) leaves each segment's warp-local sum in its last lane.
// That lane stores the row plainly when the segment lies wholly inside the
// warp (no other thread touches that rank) and adds it atomically only
// when the segment crosses a warp boundary.  The TPU's one-hot matrix
// products over rank windows have no counterpart.
#include <cuda_runtime.h>

__global__ void ranksum_kernel(const float* __restrict__ rows,
                               const int* __restrict__ pos,
                               const int* __restrict__ ranks,
                               float* __restrict__ dFc, int E) {
  const unsigned full = 0xffffffffu;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int r = e < E ? ranks[e] : -1;
  float v[16];
  if (r >= 0) {
    const float4* src =
        reinterpret_cast<const float4*>(rows + (size_t)pos[e] * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 a = src[q];
      v[4 * q + 0] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0.0f;
  }

  // segment ends at this entry (globally)?
  int r_next = __shfl_down_sync(full, r, 1);
  if (lane == 31) r_next = (e + 1 < E) ? ranks[e + 1] : -2;
  const bool ends = r_next != r;
  // does the warp-local part of this segment start a segment globally?
  const int r0 = __shfl_sync(full, r, 0);
  const int first = __shfl_sync(full, e, 0);
  const bool lane0_starts = first == 0 || (first < E && ranks[first - 1] != r0);
  const bool starts_in_warp = (r != r0) || lane0_starts;

#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int r_up = __shfl_up_sync(full, r, off);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float up = __shfl_up_sync(full, v[k], off);
      if (lane >= off && r_up == r) v[k] += up;
    }
  }

  if (r >= 0 && (ends || lane == 31)) {
    float* dst = dFc + (size_t)r * 16;
    if (ends && starts_in_warp) {
#pragma unroll
      for (int k = 0; k < 16; ++k) dst[k] = v[k];
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) atomicAdd(dst + k, v[k]);
    }
  }
}

extern "C" int launch_ranksum_rows(const float* rows, const int* pos,
                                   const int* ranks, float* dFc, int E,
                                   cudaStream_t stream) {
  if (E == 0) return 0;
  const int threads = 256;
  ranksum_kernel<<<(E + threads - 1) / threads, threads, 0, stream>>>(
      rows, pos, ranks, dFc, E);
  return (int)cudaGetLastError();
}

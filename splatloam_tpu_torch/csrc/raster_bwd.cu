// K2: the rasterizer's backward pass (per-slot feature gradients).
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel with
// fused=False.
//
// Writes each slot's gradient row, summed over the tile's pixels, into
// dFg [T, K, 16]; rows of slots the forward did not composite are zeros.
// The reduction to per-surfel rows follows in K3, K4 or the occurrence
// plan (+ K6).
//
// Bound on the H100: operations.  Each (pixel, slot) pair evaluates the
// geometry three times plus ~80 operations of gradient algebra and a
// 16-value warp reduction.
//
// Design: raster_bwd.cuh (one block per tile, one thread per pixel, T_i
// rebuilt per 32-slot sub-chunk); the block owns its tile's rows, so no
// global atomics are needed.
#include "raster_bwd.cuh"

extern "C" int launch_raster_bwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, const float* tbound,
                                 const float* outs, const float* g,
                                 float* dFg, int n_tiles, int K, int C,
                                 int P, float width, float inv_width,
                                 int with_dist, cudaStream_t stream) {
  const splat::SlotLayout L{lists, counts, K, 0};
  return splat::launch_raster_bwd_impl<false, false>(
      F, L, rays, pix, tbound, outs, g, dFg, n_tiles, C, P, width,
      inv_width, with_dist, stream);
}

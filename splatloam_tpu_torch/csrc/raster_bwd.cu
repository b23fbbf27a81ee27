// K2: the rasterizer's backward pass (per-slot feature gradients).
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel with
// fused=False.
//
// Writes each composited slot's gradient row, summed over the tile's
// pixels, into dFg [T, K, 16]; rows of real slots in dead chunks are
// zeros, and rows past each tile's count are left unwritten: the
// reductions that follow (K3, K4, the occurrence plan + K6) read real
// slots only.
//
// Bound on the H100: operations (the geometry once and the gradient
// algebra per composited pixel-slot pair, and the 16-value row sums).
//
// Design: the slot-parallel body of raster_bwd_seg.cuh with Out::ROWS.
#include "raster_bwd_seg.cuh"

// P a multiple of 32 up to 256, C a multiple of 32 dividing K; med_slot
// [T, P] (K1's) is read with the median only.
extern "C" int launch_raster_bwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, const float* tbound,
                                 const float* outs, const float* g,
                                 const int* med_slot, float* dFg,
                                 int n_tiles, int K, int C, int P,
                                 float width, float inv_width,
                                 int with_dist, int with_median,
                                 cudaStream_t stream) {
  const splat::SlotLayout L{lists, counts, K, 0};
  return splat::launch_bwd<splat::Out::ROWS>(
      F, L, rays, pix, tbound, outs, g, med_slot, dFg, n_tiles, C, P,
      width, inv_width, with_dist, with_median, stream);
}

// Resident warps per SM at these shapes, or minus the CUDA error code.
extern "C" int launch_raster_bwd_resident_warps(int P, int C,
                                                int with_dist,
                                                int with_median) {
  return splat::resident_warps<splat::Out::ROWS>(P, C, with_dist,
                                                 with_median);
}

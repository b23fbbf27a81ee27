// K1: the rasterizer's forward pass over the tiled [T, K] slot lists.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel (with
// _splat_geometry and the triangular-matmul scans it uses).
//
// out [T, P, 8] and tbound [T, P, K/C] from the features F [R, 16], the
// lists [T, K] and counts [T], rays [T, P, 3] and pix [T, P, 2]: slot j of
// tile t is lists[t, j], j < counts[t].
//
// Bound on the H100: operations.
//
// Design: the slot-parallel body of raster_fwd_seg.cuh over the tiled
// layout.
#include "raster_fwd_seg.cuh"

// P a multiple of 32 up to 256, C a multiple of 32 dividing K.
extern "C" int launch_raster_fwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, float* out, float* tbound,
                                 int n_tiles, int K, int C, int P,
                                 float width, float inv_width,
                                 int with_median, int with_dist,
                                 cudaStream_t stream) {
  const splat::SlotLayout L{lists, counts, K, 0};
  return splat::launch_fwd<false>(F, L, rays, pix, out, tbound, n_tiles, C,
                                  P, width, inv_width, with_median,
                                  with_dist, stream);
}

// Resident warps per SM at these shapes, or minus the CUDA error code.
extern "C" int launch_raster_fwd_resident_warps(int P, int C,
                                                int with_median,
                                                int with_dist) {
  (void)C;
  return splat::resident_warps<false>(P, with_median, with_dist);
}

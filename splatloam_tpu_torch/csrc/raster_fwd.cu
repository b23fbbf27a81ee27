// K1: the rasterizer's forward pass over the tiled [T, K] slot lists.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel (with
// _splat_geometry and the triangular-matmul scans it uses).
//
// out [T, P, 8] and tbound [T, P, K/C] from F [R, 16], lists [T, K] and
// counts [T]: raster_fwd.cuh with FLAT = false.
//
// Bound on the H100: operations.  Each (pixel, slot) pair costs ~45 fp32
// operations and one exp; the bytes are the tile's slot features, read
// once per tile, and 8 + K/C floats per pixel.
//
// Design: raster_fwd.cuh (one block per tile, one thread per pixel, each
// chunk's features staged in shared memory, a running transmittance per
// thread, __syncthreads_or for the tile-level exit).
#include "raster_fwd.cuh"

extern "C" int launch_raster_fwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, float* out, float* tbound,
                                 int n_tiles, int K, int C, int P,
                                 float width, float inv_width,
                                 int with_median, int with_dist,
                                 cudaStream_t stream) {
  const splat::SlotLayout L{lists, counts, K, 0};
  return splat::launch_raster_fwd_impl<false>(
      F, L, rays, pix, out, tbound, n_tiles, C, P, width, inv_width,
      with_median, with_dist, stream);
}

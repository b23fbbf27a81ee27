// K7: the rasterizer's forward pass over the flat compacted slot pool.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel_flat
// (launched by _forward_flat, whose grid runs over flat chunks with
// scalar-prefetched chunk -> tile routing).
//
// out [B*T, P, 8] and tbound [B*E/C, P] from the pool F [B*(N+1), 16], the
// views' flat slot ids [B, E] (offset into the pool) and their
// chunk-aligned segment starts [B, T+1].  Pad slots point at a view's zero
// row N and composite to nothing, so the kernel has no per-slot count
// logic; chunks past starts[v, T] (the unused budget, which the binning
// routes to the last tile) belong to no block and keep tbound 0.
//
// Bound on the H100: operations, as K1 (the same arithmetic per pixel-slot
// pair, plus the pads inside each tile's last chunk).
//
// Design: raster_fwd.cuh with FLAT = true: one block per (view, tile),
// looping over the tile's chunk range [starts[v, t], starts[v, t+1]) from
// front to back with the transmittance carried in registers, and the
// tile-level chunk exit of K1 (tbound of skipped chunks stays 0).
#include "raster_fwd.cuh"

extern "C" int launch_raster_fwd_flat(const float* F, const int* ids,
                                      const int* starts, const float* rays,
                                      const float* pix, float* out,
                                      float* tbound, int n_tiles, int E,
                                      int tiles_per_view, int C, int P,
                                      float width, float inv_width,
                                      int with_median, int with_dist,
                                      cudaStream_t stream) {
  const splat::SlotLayout L{ids, starts, E, tiles_per_view};
  return splat::launch_raster_fwd_impl<true>(
      F, L, rays, pix, out, tbound, n_tiles, C, P, width, inv_width,
      with_median, with_dist, stream);
}

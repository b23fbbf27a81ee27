// K7: the rasterizer's forward pass over the flat compacted slot pool.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel_flat
// (launched by _forward_flat, whose grid runs over flat chunks with
// scalar-prefetched chunk -> tile routing).
//
// out [B*T, P, 8] and tbound [B*E/C, P] from the pool F [B*(N+1), 16], the
// views' flat slot ids [B, E] (offset into the pool) and their
// chunk-aligned segment starts [B, T+1]: tile t of view v owns the chunks
// [starts[v, t], starts[v, t+1]) of its view's slots.  tbound is 0 for
// chunks a tile skipped and for the budget chunks past starts[v, T]
// (which the binning routes to the last tile and no block owns here); a
// tile that owns no chunk writes the empty state (zeros, T = 1).
//
// Bound on the H100: operations, as K1 (the same arithmetic per
// pixel-slot pair; the trailing pads are not composited).
//
// Design: the slot-parallel body of raster_fwd_seg.cuh over the flat
// layout: one block per (view, tile) walks the tile's chunk range inside
// the block (the TPU's sequential grid over flat chunks carried T from
// chunk to chunk through a revisited output block, which blocks running
// in no order cannot), up to the tile's last slot of non-zero opacity.
#include "raster_fwd_seg.cuh"

extern "C" int launch_raster_fwd_flat(const float* F, const int* ids,
                                      const int* starts, const float* rays,
                                      const float* pix, float* out,
                                      float* tbound, int n_tiles, int E,
                                      int tiles_per_view, int C, int P,
                                      float width, float inv_width,
                                      int with_median, int with_dist,
                                      cudaStream_t stream) {
  const splat::SlotLayout L{ids, starts, E, tiles_per_view};
  return splat::launch_fwd<true>(F, L, rays, pix, out, tbound, n_tiles, C,
                                 P, width, inv_width, with_median, with_dist,
                                 stream);
}

// Resident warps per SM at these shapes, or minus the CUDA error code.
extern "C" int launch_raster_fwd_flat_resident_warps(int P, int C,
                                                     int with_median,
                                                     int with_dist) {
  (void)C;
  return splat::resident_warps<true>(P, with_median, with_dist);
}

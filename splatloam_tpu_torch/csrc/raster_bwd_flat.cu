// K8: the rasterizer's backward pass over the flat compacted slot pool.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel_flat
// (launched by _backward_flat, whose reversed grid over flat chunks
// carries the suffix sums in scratch and resets them at each tile's
// deepest chunk).
//
// rows [B*E, 16] (one per flat slot; rows of dead chunks, of unowned
// budget chunks and of pads are 0) from the pool F [B*(N+1), 16], the
// views' flat slot ids [B, E], their segment starts [B, T+1], K7's tbound
// [B*E/C, P] and out, and the output cotangents g [B*T, P, 8].  K9 then
// sums the rows into the pool by slot id.
//
// Bound on the H100: operations, as K2 (the same arithmetic per pixel-slot
// pair).
//
// Design: raster_bwd.cuh with FLAT = true: one block per (view, tile),
// walking the tile's live chunks in reverse inside the block with the
// suffix carries in registers; the per-pixel sub-chunk T_i rebuild and
// block reduction that K2 had before its redesign.  The wrapper zeroes
// the rows, so the kernel writes only the rows of the chunks it replays.
#include "raster_bwd.cuh"

extern "C" int launch_raster_bwd_flat(const float* F, const int* ids,
                                      const int* starts, const float* rays,
                                      const float* pix, const float* tbound,
                                      const float* outs, const float* g,
                                      float* rows, int n_tiles, int E,
                                      int tiles_per_view, int C, int P,
                                      float width, float inv_width,
                                      int with_dist, cudaStream_t stream) {
  const splat::SlotLayout L{ids, starts, E, tiles_per_view};
  return splat::launch_raster_bwd_impl<false, true>(
      F, L, rays, pix, tbound, outs, g, rows, n_tiles, C, P, width,
      inv_width, with_dist, stream);
}

// K8: the rasterizer's backward pass over the flat compacted slot pool.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel_flat
// (launched by _backward_flat, whose reversed grid over flat chunks
// carries the suffix sums in scratch and resets them at each tile's
// deepest chunk).
//
// rows [B*E, 16] (one per owned flat slot; rows of dead chunks and of
// pads are 0; the rows of budget chunks past starts[v, T], which no tile
// owns, are left unwritten) from the pool F [B*(N+1), 16], the
// views' flat slot ids [B, E], their segment starts [B, T+1], K7's tbound
// [B*E/C, P] and out, and the output cotangents g [B*T, P, 8].  K9 then
// sums the rows into the pool by slot id.
//
// Bound on the H100: operations, as K2 (the same arithmetic per pixel-slot
// pair).
//
// Design: the slot-parallel body of raster_bwd_seg.cuh with Out::FLAT:
// blocks per (view, tile) walk the tile's chunk range [starts[v, t],
// starts[v, t+1]) in reverse inside the block (the TPU's reversed
// sequential grid carried the suffix sums from chunk to chunk in scratch,
// which blocks running in no order cannot), up to the tile's last slot of
// non-zero opacity: its trailing pads are skipped.  A 64- or 32-pixel
// tile (one block) writes zeros for the owned slots it does not walk, so
// every row K9 reads is written in the same call and the wrapper fills
// nothing; a larger tile's blocks add into rows the launcher zeroes.
#include "raster_bwd_seg.cuh"

extern "C" int launch_raster_bwd_flat(const float* F, const int* ids,
                                      const int* starts, const float* rays,
                                      const float* pix, const float* tbound,
                                      const float* outs, const float* g,
                                      const int* med_slot, float* rows,
                                      int n_tiles, int E,
                                      int tiles_per_view, int C, int P,
                                      float width, float inv_width,
                                      int with_dist, int with_median,
                                      cudaStream_t stream) {
  const splat::SlotLayout L{ids, starts, E, tiles_per_view};
  return splat::launch_bwd<splat::Out::FLAT>(
      F, L, rays, pix, tbound, outs, g, med_slot, rows, n_tiles, C, P,
      width, inv_width, with_dist, with_median, stream);
}

// Resident warps per SM at these shapes, or minus the CUDA error code.
extern "C" int launch_raster_bwd_flat_resident_warps(int P, int C,
                                                     int with_dist,
                                                     int with_median) {
  return splat::resident_warps<splat::Out::FLAT>(P, C, with_dist,
                                                 with_median);
}

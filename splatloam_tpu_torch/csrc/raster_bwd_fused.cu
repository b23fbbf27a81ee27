// K5: the rasterizer's backward pass fused with the gradient reduction.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel with
// fused=True (launched by _bwd_call_fused), whose per-tile rows are
// read-modify-written into a VMEM-resident pool after the chunk loop.
//
// dF[lists[t, j]] += (K2's row of slot j of tile t) for every slot the
// forward composited (j < counts[t], in a live chunk), into the zeroed
// pool dF [B*(N+1), 16].  The per-slot rows dFg [T, K, 16] never reach
// device memory.
//
// Bound on the H100: operations, as K2 (the same arithmetic per pixel-slot
// pair); the bytes are K2's inputs plus one 64-byte atomic row per
// composited slot and the touched pool rows.
//
// Design: the slot-parallel body of raster_bwd_seg.cuh with Out::FUSED.
// The TPU kernel's serial RMW over a pool that stays in VMEM for the whole
// grid has no counterpart: blocks run in parallel on 132 SMs, so after
// each slot's warp reduction its 16 column sums go out as float atomics
// from lanes 2c, one contiguous 64-byte row per slot and pixel group.
// The sum order, and so the last bits, vary from run to run.
#include "raster_bwd_seg.cuh"

extern "C" int launch_raster_bwd_fused(const float* F, const int* lists,
                                       const int* counts, const float* rays,
                                       const float* pix, const float* tbound,
                                       const float* outs, const float* g,
                                       float* dF, int n_tiles, int K, int C,
                                       int P, float width, float inv_width,
                                       int with_dist, cudaStream_t stream) {
  const splat::SlotLayout L{lists, counts, K, 0};
  return splat::launch_bwd<splat::Out::FUSED>(
      F, L, rays, pix, tbound, outs, g, dF, n_tiles, C, P, width,
      inv_width, with_dist, stream);
}

// Resident warps per SM at these shapes, or minus the CUDA error code.
extern "C" int launch_raster_bwd_fused_resident_warps(int P, int C,
                                                      int with_dist) {
  return splat::resident_warps<splat::Out::FUSED>(P, C, with_dist);
}

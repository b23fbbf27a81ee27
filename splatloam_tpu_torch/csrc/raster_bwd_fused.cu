// K5: the rasterizer's backward pass fused with the gradient reduction.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel with
// fused=True (launched by _bwd_call_fused), whose per-tile rows are
// read-modify-written into a VMEM-resident pool after the chunk loop.
//
// dF[lists[t, j]] += (K2's row of slot j of tile t) for every slot the
// forward composited (j < counts[t], in a live chunk), into the zeroed
// pool dF [N+1, 16].  The per-slot rows dFg [T, K, 16] never reach device
// memory.
//
// Bound on the H100: operations, as K2 (the same arithmetic per pixel-slot
// pair); the bytes are K2's inputs plus one 64-byte atomic row per
// composited slot and the touched pool rows.
//
// Design: raster_bwd.cuh with FUSED = true.  The TPU kernel's serial RMW
// over a pool that stays in VMEM for the whole grid has no counterpart:
// blocks run in parallel on 132 SMs, so after each 32-slot sub-chunk's
// block reduction the 16 sums of each slot go out as float atomics, one
// thread per (slot, column), i.e. contiguous 64-byte rows per slot.  The
// sum order, and so the last bits, vary from run to run.
#include "raster_bwd.cuh"

extern "C" int launch_raster_bwd_fused(const float* F, const int* lists,
                                       const int* counts, const float* rays,
                                       const float* pix, const float* tbound,
                                       const float* outs, const float* g,
                                       float* dF, int n_tiles, int K, int C,
                                       int P, float width, float inv_width,
                                       int with_dist, cudaStream_t stream) {
  const splat::SlotLayout L{lists, counts, K, 0};
  return splat::launch_raster_bwd_impl<true, false>(
      F, L, rays, pix, tbound, outs, g, dF, n_tiles, C, P, width,
      inv_width, with_dist, stream);
}

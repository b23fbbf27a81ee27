// K7: the rasterizer's forward pass over the flat compacted slot pool.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel_flat
// (launched by _forward_flat, whose grid runs over flat chunks with
// scalar-prefetched chunk -> tile routing).
//
// out [B*T, P, 8] and tbound [B*E/C, P] from the pool F [B*(N+1), 16], the
// views' flat slot ids [B, E] (offset into the pool) and their
// chunk-aligned segment starts [B, T+1].  Per tile of P pixels, composite
// the tile's depth-sorted slots front to back, chunk by chunk, into out =
// (depth_sum, alpha, normal_sum (3), median, dist, final T), and save each
// chunk's start transmittance into tbound (0 for chunks the tile skipped,
// as K1 does).  A tile stops at the end of its chunk range or, at a chunk
// boundary, once every pixel's T <= 1e-4.  Pad slots point at a view's
// zero row N and composite to nothing, so the kernel has no per-slot count
// logic; chunks past starts[v, T] (the unused budget, which the binning
// routes to the last tile) belong to no block and keep tbound 0; a tile
// that owns no chunk writes the empty state (zeros, T = 1).
//
// Bound on the H100: operations, as K1 (the same arithmetic per pixel-slot
// pair, plus the pads inside each tile's last chunk).
//
// Design: one block per (view, tile), one thread per pixel.  The block
// gathers each chunk's [C, 16] feature rows straight from F by the slot
// ids into shared memory (20 floats per slot with n.p, p.gu, p.gv
// precomputed), and every thread composites them sequentially with a
// running transmittance (the TPU's exclusive log-space prefix scan over
// the chunk becomes a plain running product).  The loop over the tile's
// chunk range lives inside the block (the TPU's sequential grid over
// flat chunks carried T from chunk to chunk through a revisited output
// block, which blocks running in no order cannot); __syncthreads_or
// implements the tile-level exit.  It is also K1's independent oracle on
// the card.
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace splat {
namespace {

__global__ void raster_fwd_flat_kernel(const float* __restrict__ F,
                                       SlotLayout L,
                                       const float* __restrict__ rays,
                                       const float* __restrict__ pix,
                                       float* __restrict__ out,
                                       float* __restrict__ tbound, int C,
                                       float width, float inv_width,
                                       int with_median, int with_dist) {
  extern __shared__ float s_feat[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const TileSlots ts = tile_slots<true>(L, t, C);
  const int count = ts.count;
  const int n_act = (count + C - 1) / C;
  const size_t px_idx = (size_t)t * P + p;
  const float rx = rays[px_idx * 3 + 0];
  const float ry = rays[px_idx * 3 + 1];
  const float rz = rays[px_idx * 3 + 2];
  const float pu = pix[px_idx * 2 + 0];
  const float pv = pix[px_idx * 2 + 1];
  // chunk i's start T: [NC, P], flat chunk slot0 / C + i
  float* tb = tbound + (ts.slot0 / C) * P + p;

  float T = 1.0f, d_sum = 0.0f, a_sum = 0.0f, med = 0.0f, dist = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  for (int i = 0; i < n_act; ++i) {
    // also the barrier that protects s_feat before it is restaged
    if (!__syncthreads_or(T > T_EPS)) break;
    tb[(size_t)i * P] = T;
    const int n_c = min(C, count - i * C);
    stage_chunk(s_feat, F, ts.list, i * C, n_c, p, P);
    __syncthreads();
    for (int c = 0; c < n_c; ++c) {
      const float* f = s_feat + c * FS;
      const Geo g = splat_geometry(f, rx, ry, rz, pu, pv, width, inv_width);
      const float w = g.alpha * T;
      const float wm = w * g.m;
      if (with_dist) dist += w * (g.m * a_sum - d_sum);
      if (with_median && med == 0.0f && T > 0.5f &&
          T * (1.0f - g.alpha) <= 0.5f && g.alpha > 0.0f)
        med = g.m;
      d_sum += wm;
      a_sum += w;
      n0 += w * f[9];
      n1 += w * f[10];
      n2 += w * f[11];
      T *= 1.0f - g.alpha;
    }
  }
  float* o = out + px_idx * 8;
  o[0] = d_sum;
  o[1] = a_sum;
  o[2] = n0;
  o[3] = n1;
  o[4] = n2;
  o[5] = med;
  o[6] = dist;
  o[7] = T;
}

// its shared memory allowed; returns the CUDA error code
int prepare(int C, size_t* smem) {
  *smem = (size_t)C * FS * sizeof(float);
  return (int)cudaFuncSetAttribute(raster_fwd_flat_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

}  // namespace
}  // namespace splat

extern "C" int launch_raster_fwd_flat(const float* F, const int* ids,
                                      const int* starts, const float* rays,
                                      const float* pix, float* out,
                                      float* tbound, int n_tiles, int E,
                                      int tiles_per_view, int C, int P,
                                      float width, float inv_width,
                                      int with_median, int with_dist,
                                      cudaStream_t stream) {
  size_t smem;
  const int err = splat::prepare(C, &smem);
  if (err != 0) return err;
  if (n_tiles == 0) return 0;
  const splat::SlotLayout L{ids, starts, E, tiles_per_view};
  splat::raster_fwd_flat_kernel<<<n_tiles, P, smem, stream>>>(
      F, L, rays, pix, out, tbound, C, width, inv_width, with_median,
      with_dist);
  return (int)cudaGetLastError();
}

// Resident warps per SM at these shapes (one warp per 32 pixels), or
// minus the CUDA error code; the flags do not change its resources.
extern "C" int launch_raster_fwd_flat_resident_warps(int P, int C,
                                                     int with_median,
                                                     int with_dist) {
  (void)with_median;
  (void)with_dist;
  size_t smem;
  int err = splat::prepare(C, &smem);
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, splat::raster_fwd_flat_kernel, P, smem);
  return err != 0 ? -err : blocks * (P / 32);
}

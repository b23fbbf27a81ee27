// The rasterizer's forward pass, shared by K1 (raster_fwd.cu: the tiled
// [T, K] slot lists) and K7 (raster_fwd_flat.cu: the flat compacted slot
// pool), so the two compositing loops cannot drift apart.
//
// Per tile of P pixels, composite the tile's depth-sorted slots front to
// back in chunks of C slots, accumulating per pixel depth_sum, alpha,
// normal_sum (3), median, distortion and the final transmittance into
// out [T, P, 8], and saving each chunk's start transmittance into tbound
// (0 for chunks the tile skipped).  A tile stops at its slot count or, at a
// chunk boundary, once every pixel's T <= 1e-4: the backward's liveness
// test depends on exactly this tile-level, chunk-granular rule and on the
// zero-initialised tbound.
//
// Design: one block per tile, one thread per pixel.  The block gathers
// each chunk's [C, 16] feature rows straight from F by the tile's slot ids
// into shared memory (20 floats per slot with n.p, p.gu, p.gv
// precomputed), and every thread composites them sequentially with a
// running transmittance (the TPU's exclusive log-space prefix scan over
// the chunk becomes a plain running product).  __syncthreads_or implements
// the tile-level exit.
//
// FLAT = false (K1): tbound is [T, P, K/C] and the block zero-fills its
// row; padding slots past the tile's count are not visited (their zero
// feature row contributes exactly nothing).
// FLAT = true (K7): tbound is [NC, P] over the flat chunks and arrives
// zeroed; the loop over the tile's chunk range lives inside the block (the
// TPU's sequential grid over flat chunks carried T from chunk to chunk
// through a revisited output block, which blocks running in no order
// cannot), and a tile that owns no chunk writes the empty state (zeros,
// T = 1).
#pragma once

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace splat {

template <bool FLAT>
__global__ void raster_fwd_kernel(const float* __restrict__ F, SlotLayout L,
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
  const TileSlots ts = tile_slots<FLAT>(L, t, C);
  const int count = ts.count;
  const int n_act = (count + C - 1) / C;
  const size_t px_idx = (size_t)t * P + p;
  const float rx = rays[px_idx * 3 + 0];
  const float ry = rays[px_idx * 3 + 1];
  const float rz = rays[px_idx * 3 + 2];
  const float pu = pix[px_idx * 2 + 0];
  const float pv = pix[px_idx * 2 + 1];
  // chunk i's start T: K1 [T, P, K/C]; K7 [NC, P], chunk0 + i
  const int nc = L.slots_per_view / C;
  float* tb = FLAT ? tbound + (ts.slot0 / C) * P + p : tbound + px_idx * nc;
  const size_t tb_step = FLAT ? (size_t)P : 1;
  if (!FLAT)
    for (int i = 0; i < nc; ++i) tb[i] = 0.0f;

  float T = 1.0f, d_sum = 0.0f, a_sum = 0.0f, med = 0.0f, dist = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  for (int i = 0; i < n_act; ++i) {
    // also the barrier that protects s_feat before it is restaged
    if (!__syncthreads_or(T > T_EPS)) break;
    tb[i * tb_step] = T;
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

// Launch over n_tiles blocks of P threads; returns the CUDA error code.
template <bool FLAT>
int launch_raster_fwd_impl(const float* F, SlotLayout L, const float* rays,
                           const float* pix, float* out, float* tbound,
                           int n_tiles, int C, int P, float width,
                           float inv_width, int with_median, int with_dist,
                           cudaStream_t stream) {
  const size_t smem = (size_t)C * FS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      raster_fwd_kernel<FLAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  raster_fwd_kernel<FLAT><<<n_tiles, P, smem, stream>>>(
      F, L, rays, pix, out, tbound, C, width, inv_width, with_median,
      with_dist);
  return (int)cudaGetLastError();
}

}  // namespace splat

// K1: the rasterizer's forward pass.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel (with
// _splat_geometry and the triangular-matmul scans it uses).
//
// Per tile of P pixels, composite the tile's depth-sorted surfel list front
// to back in chunks of C slots, accumulating per pixel depth_sum, alpha,
// normal_sum (3), median, distortion and the final transmittance into
// out [T, P, 8], and saving each chunk's start transmittance into
// tbound [T, P, K/C] (0 for chunks the tile skipped).  A tile stops at its
// slot count or, at a chunk boundary, once every pixel's T <= 1e-4: the
// backward's liveness test depends on exactly this tile-level, chunk-
// granular rule and on the zero-initialised tbound.
//
// Bound on the H100: operations.  Each (pixel, slot) pair costs ~45 fp32
// operations and one exp; the bytes are the tile's slot features, read
// once per tile, and 8 + K/C floats per pixel.
//
// Design: one block per tile, one thread per pixel.  The block gathers
// each chunk's [C, 16] feature rows straight from F by the tile list into
// shared memory (20 floats per slot with n.p, p.gu, p.gv precomputed), and
// every thread composites them sequentially with a running transmittance
// (the TPU's exclusive log-space prefix scan over the chunk becomes a
// plain running product).  __syncthreads_or implements the tile-level
// exit.  Padding slots past the tile's count are not visited: their zero
// feature row contributes exactly nothing.
#include <cuda_runtime.h>

#include "raster_common.cuh"

using namespace splat;

__global__ void raster_fwd_kernel(const float* __restrict__ F,
                                  const int* __restrict__ lists,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ rays,
                                  const float* __restrict__ pix,
                                  float* __restrict__ out,
                                  float* __restrict__ tbound, int K, int C,
                                  float width, float inv_width,
                                  int with_median, int with_dist) {
  extern __shared__ float s_feat[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int nc = K / C;
  const int count = counts[t];
  const int n_act = (count + C - 1) / C;
  const size_t px_idx = (size_t)t * P + p;
  const float rx = rays[px_idx * 3 + 0];
  const float ry = rays[px_idx * 3 + 1];
  const float rz = rays[px_idx * 3 + 2];
  const float pu = pix[px_idx * 2 + 0];
  const float pv = pix[px_idx * 2 + 1];
  float* tb = tbound + px_idx * nc;
  for (int i = 0; i < nc; ++i) tb[i] = 0.0f;

  float T = 1.0f, d_sum = 0.0f, a_sum = 0.0f, med = 0.0f, dist = 0.0f;
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  const int* list = lists + (size_t)t * K;
  for (int i = 0; i < n_act; ++i) {
    // also the barrier that protects s_feat before it is restaged
    if (!__syncthreads_or(T > T_EPS)) break;
    tb[i] = T;
    const int n_c = min(C, count - i * C);
    stage_chunk(s_feat, F, list, i * C, n_c, p, P);
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

extern "C" int launch_raster_fwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, float* out, float* tbound,
                                 int n_tiles, int K, int C, int P,
                                 float width, float inv_width,
                                 int with_median, int with_dist,
                                 cudaStream_t stream) {
  const size_t smem = (size_t)C * FS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      raster_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  raster_fwd_kernel<<<n_tiles, P, smem, stream>>>(
      F, lists, counts, rays, pix, out, tbound, K, C, width, inv_width,
      with_median, with_dist);
  return (int)cudaGetLastError();
}

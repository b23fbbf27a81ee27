// K2: the rasterizer's backward pass (per-slot feature gradients).
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_bwd_kernel with
// fused=False.
//
// Writes each slot's gradient row, summed over the tile's pixels, into
// dFg [T, K, 16]: p, gu, gv, n (3 each), opacity, centre depth, cx, cy;
// the median channel is not differentiated and no gradient flows where
// alpha is capped at 0.999.  Only the slots the forward composited
// contribute (live chunks, whose chunk-start T exceeds 1e-4 for some
// pixel, and slots below the tile's count); rows of every other slot are
// zeros.  The reductions read the rows of real slots only (K3 skips the
// padding id's entries), so the zeros past each tile's count are written
// for nothing.  The reduction to per-surfel rows follows in K3, K4 or the
// occurrence plan (+ K6).
//
// Bound on the H100: operations (the geometry once and the gradient
// algebra per composited pixel-slot pair, and the 16-value row sums).
//
// Design: slot-parallel, as the TPU kernel is.  A block of 8 warps takes
// one group of 64 pixels of a tile (two per lane; 32 pixels, one per lane,
// where P is not a multiple of 64; larger tiles get one block per group,
// whose rows add with float atomics into rows the launcher zeroed).  It
// cuts the tile's composited slots into segments of 32, one per warp, and
// walks them in windows of 8 segments (256 slots: a whole chunk on the
// main path), last window first, in three steps per window:
//   1. pass 1 (geometry #1): each warp walks its segment forward from
//      T = 1, keeping the local prefix products Tl in shared memory, and
//      reduces the segment per pixel to its product of (1 - alpha), a =
//      sum wl (base + gdist (m A_total - D_total)) with wl = alpha Tl and
//      base = gD m + gA + gN.n, and, with the distortion term, sum wl, sum
//      wl m and b = sum wl (m Wl_pre - MDl_pre) (prefix sums inside the
//      segment);
//   2. a per-pixel scan over the window's segments: forward, T0 of each
//      segment from the forward's chunk-start T in tbound (so K1 and K2
//      agree on T), then last first, the strict-suffix carries S (sum w
//      phi), W (sum w) and MD (sum w m) continued from the later windows
//      and chunks: a segment passes on W += T0 sum wl, MD += T0 sum wl m
//      and S += T0 a + 2 gdist T0 (MD sum wl - W sum wl m) + 2 gdist T0^2 b;
//   3. pass 2 (geometry #2): each warp walks its segment in reverse with
//      T_i = T0 Tl_i and exact suffix carries (the arithmetic of the TPU
//      kernel per pair), folds the lane's pixels in registers and reduces
//      each slot's 16 terms over the warp with a reduce-scatter butterfly
//      (8 + 4 + 2 + 1 + 1 shuffles), after which lane 2c holds column c.
// T is never recovered by dividing by (1 - alpha): alpha reaches 0.999.
// A chunk longer than 256 slots first gets each window's start T from a
// products-only walk over its earlier windows (a third geometry
// evaluation for those slots, off the main path).
// Occupancy and balance: the per-pixel cotangents sit in shared memory
// and the features are read by all lanes at once from L1/L2, so a
// 64-pixel block takes ~70 KB (Tl is 64 KB of it) and 3 blocks (24 warps)
// stay resident on an SM without the distortion term, 2 with it; a
// 768-slot tile is 24 segments over 8 warps, and smaller tiles leave the
// SM to other blocks.
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace splat {
namespace {

constexpr int SEG = 32;      // slots per segment
constexpr int NWARP = 8;     // warps per block
constexpr int NPX = 8;       // staged per-pixel values
constexpr unsigned FULL = 0xffffffffu;

constexpr int WSL = NWARP * SEG;   // slots per window

struct Shape {
  int pg, npg, nwin;
  size_t floats;   // dynamic shared memory
};

inline Shape shape_of(int P, int C, bool dist) {
  Shape s;
  s.pg = P % 64 == 0 ? 64 : 32;               // pixels per block
  s.npg = P / s.pg;                            // blocks per tile
  s.nwin = (C + WSL - 1) / WSL;                // windows per chunk
  s.floats = (size_t)(NPX + NWARP * SEG + NWARP * (dist ? 5 : 2) + s.nwin) *
             s.pg;
  return s;
}

// F row of a slot, with n.p, p.gu and p.gv (the staged layout of
// raster_common.cuh), read by every lane of the warp at once
__device__ __forceinline__ void load_row(const float* F, int id,
                                         float (&f)[FS]) {
  const float4* src = reinterpret_cast<const float4*>(F + (size_t)id * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(src + q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
  f[16] = f[9] * f[0] + f[10] * f[1] + f[11] * f[2];
  f[17] = f[0] * f[3] + f[1] * f[4] + f[2] * f[5];
  f[18] = f[0] * f[6] + f[1] * f[7] + f[2] * f[8];
  f[19] = 0.0f;
}

// Sum 16 values over the warp; lanes 2c and 2c + 1 return the sum of
// value c.  Each step sends the half of the live values the lane gives
// up and keeps the other half: 8 + 4 + 2 + 1 shuffles, then one more.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
#pragma unroll
  for (int h = 8, off = 16; h >= 1; h >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

template <int PPL, bool DIST>
__global__ void __launch_bounds__(NWARP * 32, DIST ? 2 : 3)
raster_bwd_seg_kernel(const float* __restrict__ F,
                      const int* __restrict__ lists,
                      const int* __restrict__ counts,
                      const float* __restrict__ rays,
                      const float* __restrict__ pix,
                      const float* __restrict__ tbound,
                      const float* __restrict__ outs,
                      const float* __restrict__ gout,
                      float* __restrict__ dFg, int K, int C, int P,
                      float width, float inv_width) {
  constexpr int PG = 32 * PPL;
  constexpr int NCO = DIST ? 5 : 2;
  extern __shared__ float smem[];
  const int npg = P / PG;
  const int t = blockIdx.x / npg;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* s_px = smem;                          // [NPX, PG] per pixel:
  // gD, gA, gN (3), gdist, D_total, A_total
  float* s_tl = s_px + NPX * PG;               // [NWARP, SEG, PG] Tl
  float* s_co = s_tl + NWARP * SEG * PG;       // [NWARP, NCO, PG]
  float* s_tw = s_co + NWARP * NCO * PG;       // [nwin, PG] window-start T

  const int count = counts[t];
  const int n_act = (count + C - 1) / C;
  const int nc = K / C;
  const float* tb = tbound + (size_t)t * P * nc;   // [P, nc]
  int n_live = 0;   // over all the tile's pixels, as the forward decided
  for (int i = 0; i < n_act; ++i)
    n_live += __syncthreads_or(tid < P && tb[tid * nc + i] > T_EPS) ? 1 : 0;
  const int n_slots = n_live > 0 ? min(count, n_live * C) : 0;

  // a tile of one pixel group owns its rows: zero those no unit stores
  // (with more groups the launcher zeroes dFg and the groups add)
  float* rows = dFg + (size_t)t * K * 16;
  if (npg == 1) {
    float4* rows4 = reinterpret_cast<float4*>(rows);
    for (int i = n_slots * 4 + tid; i < K * 4; i += NWARP * 32)
      rows4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (n_slots == 0) return;

  // this block's pixels: tile pixels [g * PG, (g + 1) * PG)
  const size_t px0 = (size_t)t * P + (blockIdx.x % npg) * PG;
  tb += (blockIdx.x % npg) * PG * nc;
  if (tid < PG) {
    const float* gp = gout + (px0 + tid) * 8;
    const float* op = outs + (px0 + tid) * 8;
    s_px[0 * PG + tid] = gp[0];
    s_px[1 * PG + tid] = gp[1];
    s_px[2 * PG + tid] = gp[2];
    s_px[3 * PG + tid] = gp[3];
    s_px[4 * PG + tid] = gp[4];
    s_px[5 * PG + tid] = gp[6];
    s_px[6 * PG + tid] = op[0];
    s_px[7 * PG + tid] = op[1];
  }
  float rx[PPL], ry[PPL], rz[PPL], pu[PPL], pv[PPL];
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const size_t q = px0 + k * 32 + lane;
    rx[k] = rays[q * 3];
    ry[k] = rays[q * 3 + 1];
    rz[k] = rays[q * 3 + 2];
    pu[k] = pix[q * 2];
    pv[k] = pix[q * 2 + 1];
  }
  float* tl = s_tl + warp * SEG * PG;
  float* co = s_co + warp * NCO * PG + lane;   // this warp's segment
  const int* list = lists + (size_t)t * K;

  float S = 0.0f, W = 0.0f, MD = 0.0f;   // scan thread tid's carries
  for (int i = (n_slots - 1) / C; i >= 0; --i) {
    const int c0 = i * C;
    const int c1 = min(c0 + C, n_slots);
    const int nwin = (c1 - c0 + WSL - 1) / WSL;
    __syncthreads();   // s_tl, s_co of the previous window are consumed
    if (nwin > 1) {
      // start T of each window of a chunk longer than one: products over
      // the earlier windows' (full) segments into s_tl as [segment, PG]
      for (int s = warp; s < (nwin - 1) * NWARP; s += NWARP) {
        float pr[PPL];
#pragma unroll
        for (int k = 0; k < PPL; ++k) pr[k] = 1.0f;
        for (int j = c0 + s * SEG; j < c0 + (s + 1) * SEG; ++j) {
          float f[FS];
          load_row(F, __ldg(list + j), f);
#pragma unroll
          for (int k = 0; k < PPL; ++k)
            pr[k] *= 1.0f - splat_geometry(f, rx[k], ry[k], rz[k], pu[k],
                                           pv[k], width, inv_width).alpha;
        }
#pragma unroll
        for (int k = 0; k < PPL; ++k) s_tl[s * PG + k * 32 + lane] = pr[k];
      }
      __syncthreads();
      if (tid < PG) {
        float T = tb[tid * nc + i];
        for (int w = 0; w < nwin; ++w) {
          s_tw[w * PG + tid] = T;
          if (w + 1 < nwin)
            for (int s = w * NWARP; s < (w + 1) * NWARP; ++s)
              T *= s_tl[s * PG + tid];
        }
      }
    } else if (tid < PG) {
      s_tw[tid] = tb[tid * nc + i];
    }

    for (int w = nwin - 1; w >= 0; --w) {
      const int w0 = c0 + w * WSL;
      const int w1 = min(w0 + WSL, c1);
      const int nseg = (w1 - w0 + SEG - 1) / SEG;
      const int a0 = w0 + warp * SEG;          // this warp's slots
      const int a1 = min(a0 + SEG, w1);
      __syncthreads();   // s_tw is written; s_tl, s_co are free

      // pass 1: the segment's product and coefficients per pixel
      if (warp < nseg) {
        float Tl[PPL], ca[PPL], sw[PPL], swm[PPL], cb[PPL];
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          Tl[k] = 1.0f;
          ca[k] = sw[k] = swm[k] = cb[k] = 0.0f;
        }
        // two slots per trip: their loads and chains overlap
#pragma unroll 2
        for (int j = a0; j < a1; ++j) {
          float f[FS];
          load_row(F, __ldg(list + j), f);
#pragma unroll
          for (int k = 0; k < PPL; ++k) {
            const int p = k * 32 + lane;
            tl[(j - a0) * PG + p] = Tl[k];
            const Geo g = splat_geometry(f, rx[k], ry[k], rz[k], pu[k],
                                         pv[k], width, inv_width);
            const float wl = g.alpha * Tl[k];
            float u1 = s_px[0 * PG + p];
            float u0 = s_px[1 * PG + p];
            if (DIST) {
              const float gdist = s_px[5 * PG + p];
              u1 += gdist * s_px[7 * PG + p];
              u0 -= gdist * s_px[6 * PG + p];
            }
            const float q = g.m * u1 + u0 + s_px[2 * PG + p] * f[9] +
                            s_px[3 * PG + p] * f[10] +
                            s_px[4 * PG + p] * f[11];
            ca[k] += wl * q;
            if (DIST) {
              cb[k] += wl * (g.m * sw[k] - swm[k]);
              sw[k] += wl;
              swm[k] += wl * g.m;
            }
            Tl[k] *= 1.0f - g.alpha;
          }
        }
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          co[k * 32] = Tl[k];
          co[PG + k * 32] = ca[k];
          if (DIST) {
            co[2 * PG + k * 32] = sw[k];
            co[3 * PG + k * 32] = swm[k];
            co[4 * PG + k * 32] = cb[k];
          }
        }
      }
      __syncthreads();

      // the scan: each segment's T0 and after-carries, in place of its
      // product and coefficients
      if (tid < PG) {
        float T = s_tw[w * PG + tid];
        for (int s = 0; s < nseg; ++s) {
          float* c = s_co + s * NCO * PG + tid;
          const float pr = c[0];
          c[0] = T;
          T *= pr;
        }
        const float gdist = s_px[5 * PG + tid];
        for (int s = nseg - 1; s >= 0; --s) {
          float* c = s_co + s * NCO * PG + tid;
          const float T0 = c[0];
          const float a = c[PG];
          c[PG] = S;
          if (DIST) {
            const float sw = c[2 * PG], swm = c[3 * PG], b = c[4 * PG];
            c[2 * PG] = W;
            c[3 * PG] = MD;
            S += T0 * a + 2.0f * gdist * T0 * (MD * sw - W * swm) +
                 2.0f * gdist * T0 * T0 * b;
            W += T0 * sw;
            MD += T0 * swm;
          } else {
            S += T0 * a;
          }
        }
      }
      __syncthreads();

      // pass 2: the segment in reverse with exact suffix carries
      if (warp < nseg) {
        float T0[PPL], Sc[PPL], Wc[PPL], MDc[PPL];
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          T0[k] = co[k * 32];
          Sc[k] = co[PG + k * 32];
          Wc[k] = DIST ? co[2 * PG + k * 32] : 0.0f;
          MDc[k] = DIST ? co[3 * PG + k * 32] : 0.0f;
        }
#pragma unroll 2
        for (int j = a1 - 1; j >= a0; --j) {
          float f[FS];
          load_row(F, __ldg(list + j), f);
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) v[e] = 0.0f;
#pragma unroll
          for (int k = 0; k < PPL; ++k) {
            const int p = k * 32 + lane;
            const Geo g = splat_geometry(f, rx[k], ry[k], rz[k], pu[k],
                                         pv[k], width, inv_width);
            const float gD = s_px[0 * PG + p];
            const float gN0 = s_px[2 * PG + p];
            const float gN1 = s_px[3 * PG + p];
            const float gN2 = s_px[4 * PG + p];
            const float Ti = T0[k] * tl[(j - a0) * PG + p];
            const float alpha = g.alpha;
            const float w = alpha * Ti;
            const float wm = w * g.m;
            float phi = gD * g.m + s_px[1 * PG + p] +
                        (gN0 * f[9] + gN1 * f[10] + gN2 * f[11]);
            float gm = w * gD;
            if (DIST) {
              const float gdist = s_px[5 * PG + p];
              const float A_prev = s_px[7 * PG + p] - w - Wc[k];
              const float D_prev = s_px[6 * PG + p] - wm - MDc[k];
              phi += gdist * (g.m * A_prev - D_prev + MDc[k] - g.m * Wc[k]);
              gm += w * gdist * (A_prev - Wc[k]);
            }
            const float one_m_a = fmaxf(1.0f - alpha, 1e-3f);
            const float galpha =
                alpha > 0.0f ? Ti * phi - Sc[k] / one_m_a : 0.0f;
            const bool live = g.ok && (g.alpha_raw < ALPHA_MAX);
            const float g_opa = live ? galpha * g.g_exp : 0.0f;
            const float g_rho = live ? galpha * (-0.5f) * g.alpha_raw : 0.0f;
            const bool u3 = !g.use2;
            const float g_u = u3 ? g_rho * 2.0f * g.uu : 0.0f;
            const float g_v = u3 ? g_rho * 2.0f * g.vv : 0.0f;
            const float g_t = g_u * g.A1 + g_v * g.A2 + (u3 ? gm : 0.0f);
            const float g_np = g_t / g.A3;
            const float g_A3 = -g_np * g.tstar;
            const float g_A1 = g_u * g.tstar;
            const float g_A2 = g_v * g.tstar;
            const float g_dx =
                g.use2 ? g_rho * 2.0f * FILTER_INV_SQUARE * g.dx : 0.0f;
            const float g_dy =
                g.use2 ? g_rho * 2.0f * FILTER_INV_SQUARE * g.dy : 0.0f;

            v[0] += g_np * f[9] - g_u * f[3] - g_v * f[6];
            v[1] += g_np * f[10] - g_u * f[4] - g_v * f[7];
            v[2] += g_np * f[11] - g_u * f[5] - g_v * f[8];
            v[3] += rx[k] * g_A1 - g_u * f[0];
            v[4] += ry[k] * g_A1 - g_u * f[1];
            v[5] += rz[k] * g_A1 - g_u * f[2];
            v[6] += rx[k] * g_A2 - g_v * f[0];
            v[7] += ry[k] * g_A2 - g_v * f[1];
            v[8] += rz[k] * g_A2 - g_v * f[2];
            v[9] += rx[k] * g_A3 + g_np * f[0] + gN0 * w;
            v[10] += ry[k] * g_A3 + g_np * f[1] + gN1 * w;
            v[11] += rz[k] * g_A3 + g_np * f[2] + gN2 * w;
            v[12] += g_opa;
            v[13] += g.use2 ? gm : 0.0f;
            v[14] -= g_dx;
            v[15] -= g_dy;

            Sc[k] += w * phi;
            Wc[k] += w;
            MDc[k] += wm;
          }
          const float col = reduce_scatter16(v, lane);
          if (!(lane & 1)) {
            float* r = rows + (size_t)j * 16 + (lane >> 1);
            if (npg == 1)
              *r = col;
            else
              atomicAdd(r, col);
          }
        }
      }
    }
  }
}

using BwdKernel = void (*)(const float*, const int*, const int*,
                           const float*, const float*, const float*,
                           const float*, const float*, float*, int, int, int,
                           float, float);

BwdKernel pick(int P, int with_dist) {
  if (P % 64 == 0)
    return with_dist ? raster_bwd_seg_kernel<2, true>
                     : raster_bwd_seg_kernel<2, false>;
  return with_dist ? raster_bwd_seg_kernel<1, true>
                   : raster_bwd_seg_kernel<1, false>;
}

// the kernel for (P, with_dist), its shared memory allowed; returns the
// CUDA error code
int prepare(int P, int C, int with_dist, BwdKernel* fn, size_t* smem) {
  *fn = pick(P, with_dist);
  *smem = shape_of(P, C, with_dist != 0).floats * sizeof(float);
  return (int)cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace
}  // namespace splat

// P a multiple of 32 up to 256, C a multiple of 32 dividing K.
extern "C" int launch_raster_bwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, const float* tbound,
                                 const float* outs, const float* g,
                                 float* dFg, int n_tiles, int K, int C,
                                 int P, float width, float inv_width,
                                 int with_dist, cudaStream_t stream) {
  splat::BwdKernel fn;
  size_t smem;
  const int err = splat::prepare(P, C, with_dist, &fn, &smem);
  if (err != 0) return err;
  if (n_tiles == 0) return 0;
  const int npg = splat::shape_of(P, C, with_dist != 0).npg;
  if (npg > 1) {
    const cudaError_t e = cudaMemsetAsync(
        dFg, 0, (size_t)n_tiles * K * 16 * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<n_tiles * npg, splat::NWARP * 32, smem, stream>>>(
      F, lists, counts, rays, pix, tbound, outs, g, dFg, K, C, P, width,
      inv_width);
  return (int)cudaGetLastError();
}

// Resident warps per SM at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times warps per block),
// or minus the CUDA error code.
extern "C" int launch_raster_bwd_resident_warps(int P, int C,
                                                int with_dist) {
  splat::BwdKernel fn;
  size_t smem;
  int err = splat::prepare(P, C, with_dist, &fn, &smem);
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, splat::NWARP * 32, smem);
  return err != 0 ? -err : blocks * splat::NWARP;
}

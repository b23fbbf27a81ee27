// K1: the rasterizer's forward pass over the tiled [T, K] slot lists.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_fwd_kernel (with
// _splat_geometry and the triangular-matmul scans it uses).
//
// Per tile of P pixels, composite the tile's depth-sorted slots front to
// back in chunks of C slots into out [T, P, 8] = (depth_sum, alpha,
// normal_sum (3), median, dist, final T), and save each chunk's start
// transmittance into tbound [T, P, K/C] (0 for chunks the tile skipped).
// A tile stops at its slot count or, at a chunk boundary, once every one
// of its pixels has T <= 1e-4: K2's liveness test depends on exactly this
// tile-level, chunk-granular rule and on the zeroed tbound.
//
// Bound on the H100: operations.  Each (pixel, slot) pair costs ~45 fp32
// operations and one exp; the bytes are the tile's slot features, read
// once per tile, and 8 + K/C floats per pixel.
//
// Design: slot-parallel, the forward half of K2's (raster_bwd.cu).  One
// block per tile, so that one block decides the tile's exit.  The tile's
// slots go through in windows of 256 (a whole chunk on the main path),
// staged in shared memory (20 floats a slot, stage_chunk), each window
// cut into 32-slot segments.  The pixels form groups of 64 (two per lane;
// 32, one per lane, where P is not a multiple of 64), and each group has
// 8 warps, one per segment: a block runs up to 4 groups side by side (8
// warps on the main path's 64-pixel tiles, 32 on 256-pixel tiles) and
// loops over the rest.  For each group:
//   1. pass 1: each warp walks its segment from T = 1 and reduces it per
//      pixel to its product P of (1 - alpha), A = sum wl, D = sum wl m,
//      N = sum wl n and, with the distortion term, B = sum wl (m Al_pre -
//      Dl_pre), wl = alpha Tl (Al_pre, Dl_pre: the sums over the
//      segment's earlier slots);
//   2. the combine: one thread per pixel runs over the window's segments
//      in order from the carried state (T, a_sum, d_sum, n, dist); with
//      T0 = T, dist += T0 (a_sum D - d_sum A) + T0^2 B, d_sum += T0 D,
//      a_sum += T0 A, n += T0 N, T = T0 P.  Every output is associative
//      over segments this way;
//   3. the median (with_median): the segment where T crosses 0.5 (T0 >
//      0.5 >= T0 P, at most one per pixel: T only falls) is walked again
//      by its warp for the pixels crossing there, to the first slot with
//      T0 Tl (1 - alpha) <= 0.5 (the segment's last slot if rounding
//      leaves none), whose depth m is the median; a pixel whose median
//      is set (nonzero) takes no other, as in the per-pixel body.
// T is a product of segment products, where the per-pixel body (K7)
// keeps one running product and the TPU kernel and the plain version sum
// logs: the same transmittance, rounded in another order, so a pixel
// whose T sits within rounding of 0.5 (the median's slot) or of 1e-4 at
// a chunk boundary (the tile's exit) may go either way.
// A mean tile (265 slots) is one full window and a 9-slot one, where one
// warp works and seven wait; the per-pixel body (K7) walks every slot of
// a tile in one chain of up to K steps per thread, 2 warps a block.
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace splat {
namespace {

constexpr int SEG = 32;      // slots per segment
constexpr int NWARP = 8;     // warps per pixel group: segments per window
constexpr int WSL = NWARP * SEG;   // slots per window
constexpr int MAX_GROUPS = 4;      // pixel groups side by side in a block
constexpr unsigned FULL = 0xffffffffu;

// the carried per-pixel state, [NST, P] in shared memory, in out's order
enum { ST_D, ST_A, ST_N0, ST_N1, ST_N2, ST_MED, ST_DIST, ST_T, NST };
// a segment's summary per pixel, [groups, NWARP, NSS, PG]
enum { SS_P, SS_A, SS_D, SS_N0, SS_N1, SS_N2, SS_B, NSS };

struct Shape {
  int pg, groups;   // pixels per group; groups side by side in a block
  size_t smem;      // dynamic shared memory, bytes
};

Shape shape_of(int P) {
  Shape s;
  s.pg = P % 64 == 0 ? 64 : 32;
  const int n = P / s.pg;
  s.groups = 1;
  for (int d = MAX_GROUPS; d > 1; --d)
    if (n % d == 0) {
      s.groups = d;
      break;
    }
  s.smem = ((size_t)WSL * FS + (size_t)NST * P +
            (size_t)s.groups * (NWARP * NSS + 2) * s.pg) * sizeof(float);
  return s;
}

template <int PPL>
__device__ __forceinline__ void load_pixels(const float* rays,
                                            const float* pix, size_t px0,
                                            int lane, float (&rx)[PPL],
                                            float (&ry)[PPL], float (&rz)[PPL],
                                            float (&pu)[PPL],
                                            float (&pv)[PPL]) {
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const size_t q = px0 + k * 32 + lane;
    rx[k] = rays[q * 3];
    ry[k] = rays[q * 3 + 1];
    rz[k] = rays[q * 3 + 2];
    pu[k] = pix[q * 2];
    pv[k] = pix[q * 2 + 1];
  }
}

template <int PPL, bool MED, bool DIST>
__global__ void __launch_bounds__(MAX_GROUPS * NWARP * 32)
raster_fwd_seg_kernel(const float* __restrict__ F,
                      const int* __restrict__ lists,
                      const int* __restrict__ counts,
                      const float* __restrict__ rays,
                      const float* __restrict__ pix,
                      float* __restrict__ out, float* __restrict__ tbound,
                      int K, int C, int P, float width, float inv_width) {
  constexpr int PG = 32 * PPL;
  const int nthr = blockDim.x;
  const int groups = nthr / (NWARP * 32);
  extern __shared__ float smem[];
  float* s_feat = smem;                         // [WSL, FS] window's slots
  float* s_st = s_feat + WSL * FS;              // [NST, P] carried state
  float* s_seg = s_st + NST * P;                // [groups, NWARP, NSS, PG]
  float* s_xt = s_seg + groups * NWARP * NSS * PG;   // [groups, PG]: the
  int* s_xs = reinterpret_cast<int*>(s_xt + groups * PG);   // crossing
  // segment's T0 and its index (or -1)

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lg = tid / (NWARP * 32);            // this warp's group
  const int warp = (tid >> 5) % NWARP;          // and segment in the window
  const int count = counts[t];
  const int n_act = (count + C - 1) / C;
  const int nc = K / C;
  const int* list = lists + (size_t)t * K;
  float* tb = tbound + (size_t)t * P * nc;      // [P, nc]
  for (int i = tid; i < P * nc; i += nthr) tb[i] = 0.0f;
  for (int p = tid; p < P; p += nthr) {
#pragma unroll
    for (int k = 0; k < NST; ++k) s_st[k * P + p] = k == ST_T ? 1.0f : 0.0f;
  }

  for (int i = 0; i < n_act; ++i) {
    // the tile goes on while one of its pixels has T > T_EPS (also the
    // barrier after the state's last update and the last use of s_feat)
    bool live = false;
    for (int p = tid; p < P; p += nthr) live |= s_st[ST_T * P + p] > T_EPS;
    if (!__syncthreads_or(live)) break;
    for (int p = tid; p < P; p += nthr) tb[p * nc + i] = s_st[ST_T * P + p];
    const int c1 = min((i + 1) * C, count);
    for (int w0 = i * C; w0 < c1; w0 += WSL) {
      const int n_w = min(WSL, c1 - w0);
      const int nseg = (n_w + SEG - 1) / SEG;
      const int a0 = warp * SEG;                // this warp's window slots
      const int a1 = min(a0 + SEG, n_w);
      stage_chunk(s_feat, F, list, w0, n_w, tid, nthr);
      __syncthreads();
      for (int g0 = 0; g0 < P / PG; g0 += groups) {
        const int g = g0 + lg;
        const size_t px0 = (size_t)t * P + g * PG;
        float rx[PPL], ry[PPL], rz[PPL], pu[PPL], pv[PPL];
        // pass 1: the segment's product and sums per pixel
        if (warp < nseg) {
          load_pixels<PPL>(rays, pix, px0, lane, rx, ry, rz, pu, pv);
          float Tl[PPL], A[PPL], D[PPL], N0[PPL], N1[PPL], N2[PPL], B[PPL];
#pragma unroll
          for (int k = 0; k < PPL; ++k) {
            Tl[k] = 1.0f;
            A[k] = D[k] = N0[k] = N1[k] = N2[k] = B[k] = 0.0f;
          }
          for (int j = a0; j < a1; ++j) {
            const float* f = s_feat + j * FS;
#pragma unroll
            for (int k = 0; k < PPL; ++k) {
              const Geo geo = splat_geometry(f, rx[k], ry[k], rz[k], pu[k],
                                             pv[k], width, inv_width);
              const float wl = geo.alpha * Tl[k];
              if (DIST) B[k] += wl * (geo.m * A[k] - D[k]);
              A[k] += wl;
              D[k] += wl * geo.m;
              N0[k] += wl * f[9];
              N1[k] += wl * f[10];
              N2[k] += wl * f[11];
              Tl[k] *= 1.0f - geo.alpha;
            }
          }
          float* ss = s_seg + (lg * NWARP + warp) * NSS * PG + lane;
#pragma unroll
          for (int k = 0; k < PPL; ++k) {
            ss[SS_P * PG + k * 32] = Tl[k];
            ss[SS_A * PG + k * 32] = A[k];
            ss[SS_D * PG + k * 32] = D[k];
            ss[SS_N0 * PG + k * 32] = N0[k];
            ss[SS_N1 * PG + k * 32] = N1[k];
            ss[SS_N2 * PG + k * 32] = N2[k];
            if (DIST) ss[SS_B * PG + k * 32] = B[k];
          }
        }
        __syncthreads();

        // the combine, in segment order from the carried state
        if (tid < groups * PG) {
          const int cg = tid / PG, cp = tid % PG;   // group, pixel in it
          float* st = s_st + (g0 + cg) * PG + cp;
          float T = st[ST_T * P], a = st[ST_A * P], d = st[ST_D * P];
          float n0 = st[ST_N0 * P], n1 = st[ST_N1 * P], n2 = st[ST_N2 * P];
          float dist = st[ST_DIST * P];
          const bool no_med = st[ST_MED * P] == 0.0f;
          int xs = -1;
          float xt = 0.0f;
          for (int s = 0; s < nseg; ++s) {
            const float* ss = s_seg + (cg * NWARP + s) * NSS * PG + cp;
            const float T0 = T;
            const float sa = ss[SS_A * PG], sd = ss[SS_D * PG];
            if (DIST) dist += T0 * (a * sd - d * sa) + T0 * T0 * ss[SS_B * PG];
            d += T0 * sd;
            a += T0 * sa;
            n0 += T0 * ss[SS_N0 * PG];
            n1 += T0 * ss[SS_N1 * PG];
            n2 += T0 * ss[SS_N2 * PG];
            T = T0 * ss[SS_P * PG];
            if (MED && no_med && xs < 0 && T0 > 0.5f && T <= 0.5f) {
              xs = s;
              xt = T0;
            }
          }
          st[ST_T * P] = T;
          st[ST_A * P] = a;
          st[ST_D * P] = d;
          st[ST_N0 * P] = n0;
          st[ST_N1 * P] = n1;
          st[ST_N2 * P] = n2;
          st[ST_DIST * P] = dist;
          if (MED) {
            s_xs[tid] = xs;
            s_xt[tid] = xt;
          }
        }

        // the median: the crossing segment's warp walks it again
        if (MED) {
          __syncthreads();
          if (warp < nseg) {
            bool todo[PPL], any = false;
            float T0[PPL], Tl[PPL];
#pragma unroll
            for (int k = 0; k < PPL; ++k) {
              todo[k] = s_xs[lg * PG + k * 32 + lane] == warp;
              T0[k] = s_xt[lg * PG + k * 32 + lane];
              Tl[k] = 1.0f;
              any |= todo[k];
            }
            if (__any_sync(FULL, any)) {
              for (int j = a0; j < a1; ++j) {
                const float* f = s_feat + j * FS;
                bool more = false;
#pragma unroll
                for (int k = 0; k < PPL; ++k) {
                  if (!todo[k]) continue;
                  const Geo geo = splat_geometry(f, rx[k], ry[k], rz[k],
                                                 pu[k], pv[k], width,
                                                 inv_width);
                  Tl[k] *= 1.0f - geo.alpha;
                  if (T0[k] * Tl[k] <= 0.5f || j == a1 - 1) {
                    s_st[ST_MED * P + g * PG + k * 32 + lane] = geo.m;
                    todo[k] = false;
                  }
                  more |= todo[k];
                }
                if (!__any_sync(FULL, more)) break;
              }
            }
          }
        }
        // s_seg (and s_xs) are consumed before the next groups' pass 1
        __syncthreads();
      }
    }
  }

  for (int p = tid; p < P; p += nthr) {
    float4* o = reinterpret_cast<float4*>(out + ((size_t)t * P + p) * 8);
    o[0] = make_float4(s_st[0 * P + p], s_st[1 * P + p], s_st[2 * P + p],
                       s_st[3 * P + p]);
    o[1] = make_float4(s_st[4 * P + p], s_st[5 * P + p], s_st[6 * P + p],
                       s_st[7 * P + p]);
  }
}

using FwdKernel = void (*)(const float*, const int*, const int*,
                           const float*, const float*, float*, float*, int,
                           int, int, float, float);

template <int PPL>
FwdKernel pick_flags(int with_median, int with_dist) {
  if (with_median)
    return with_dist ? raster_fwd_seg_kernel<PPL, true, true>
                     : raster_fwd_seg_kernel<PPL, true, false>;
  return with_dist ? raster_fwd_seg_kernel<PPL, false, true>
                   : raster_fwd_seg_kernel<PPL, false, false>;
}

// the kernel for (P, flags), its shared memory allowed; returns the CUDA
// error code
int prepare(int P, int with_median, int with_dist, FwdKernel* fn,
            Shape* s) {
  *fn = P % 64 == 0 ? pick_flags<2>(with_median, with_dist)
                    : pick_flags<1>(with_median, with_dist);
  *s = shape_of(P);
  return (int)cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s->smem);
}

}  // namespace
}  // namespace splat

// P a multiple of 32 up to 256, C a multiple of 32 dividing K.
extern "C" int launch_raster_fwd(const float* F, const int* lists,
                                 const int* counts, const float* rays,
                                 const float* pix, float* out, float* tbound,
                                 int n_tiles, int K, int C, int P,
                                 float width, float inv_width,
                                 int with_median, int with_dist,
                                 cudaStream_t stream) {
  splat::FwdKernel fn;
  splat::Shape s;
  const int err = splat::prepare(P, with_median, with_dist, &fn, &s);
  if (err != 0) return err;
  if (n_tiles == 0) return 0;
  fn<<<n_tiles, s.groups * splat::NWARP * 32, s.smem, stream>>>(
      F, lists, counts, rays, pix, out, tbound, K, C, P, width, inv_width);
  return (int)cudaGetLastError();
}

// Resident warps per SM at these shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times warps per block),
// or minus the CUDA error code.
extern "C" int launch_raster_fwd_resident_warps(int P, int C,
                                                int with_median,
                                                int with_dist) {
  splat::FwdKernel fn;
  splat::Shape s;
  int err = splat::prepare(P, with_median, with_dist, &fn, &s);
  const int warps = s.groups * splat::NWARP;
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, warps * 32, s.smem);
  return err != 0 ? -err : blocks * warps;
}

// The rasterizer's backward pass per pixel, shared by K5
// (raster_bwd_fused.cu: K2's rows accumulated into the surfel pool inside
// the kernel) and K8 (raster_bwd_flat.cu: K2 over the flat compacted slot
// pool).  K2 itself (raster_bwd.cu) has a slot-parallel body of its own;
// the two compute the same rows, so each holds the other on the card.
//
// Per tile, replay the live chunks (those the forward ran: chunk-start T
// above 1e-4 for some pixel, within the tile's slots) in reverse with O(P)
// suffix carries (sum of w*phi, w and w*m over later surfels), and reduce
// each slot's gradient over the tile's pixels into one 16-value row: p, gu,
// gv, n (3 each), opacity, centre depth, cx, cy.  The median channel is not
// differentiated; no gradient flows where alpha is capped at 0.999.
//
// Design: one block per tile, one thread per pixel.  A chunk's features
// are staged in shared memory as in the forward.  Each pixel needs T_i,
// the transmittance in front of surfel i, while walking the chunk
// backwards; T_i is rebuilt forward from the chunk-start T saved by the
// forward (dividing the final T by (1 - alpha) loses precision at alpha up
// to 0.999).  A [P, C] buffer of T_i does not fit in shared memory at
// 256-pixel tiles, so the chunk is cut into sub-chunks of 32 slots: one
// forward pass stores T at every sub-chunk start, then each sub-chunk,
// last first, rebuilds its 32 T_i into shared memory and walks them
// backwards.  Every slot's 16 per-pixel terms are reduced over a warp with
// shuffles and over the block's warps through shared memory.
//
// FUSED = true (K5): each composited slot's row is added with float atomics
// into dF[lists[t, j]] of the zeroed pool dF [N+1, 16]; dead chunks and
// padding slots add nothing, and dFg never reaches device memory.
// FLAT = true (K8): the block owns the rows [NC*C, 16] of its tile's flat
// chunk range and walks that range in reverse inside the block (the TPU's
// reversed sequential grid carried the suffix sums from chunk to chunk in
// scratch, which blocks running in no order cannot); the rows arrive
// zeroed, so dead chunks and unowned budget chunks stay zero.
#pragma once

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace splat {

constexpr int BWD_SUB = 32;

template <bool FUSED, bool FLAT>
__global__ void raster_bwd_kernel(
    const float* __restrict__ F, SlotLayout L,
    const float* __restrict__ rays, const float* __restrict__ pix,
    const float* __restrict__ tbound, const float* __restrict__ outs,
    const float* __restrict__ gout, float* __restrict__ dst, int C,
    float width, float inv_width, int with_dist) {
  constexpr int SUB = BWD_SUB;
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int NW = P >> 5;
  float* s_feat = smem;                      // [C, FS]
  float* s_tck = s_feat + C * FS;            // [C/SUB, P] T at sub-chunk starts
  float* s_ti = s_tck + (C / SUB) * P;       // [SUB, P] T_i of one sub-chunk
  float* s_red = s_ti + SUB * P;             // [SUB, NW, 16] warp partials

  const TileSlots ts = tile_slots<FLAT>(L, t, C);
  const int count = ts.count;
  const int n_act = (count + C - 1) / C;
  const size_t px_idx = (size_t)t * P + p;
  // chunk i's start T: K5 [T, P, K/C]; K8 [NC, P], chunk0 + i
  const int nc = L.slots_per_view / C;
  const float* tb =
      FLAT ? tbound + (ts.slot0 / C) * P + p : tbound + px_idx * nc;
  const size_t tb_step = FLAT ? (size_t)P : 1;
  int n_live = 0;
  for (int i = 0; i < n_act; ++i)
    n_live += __syncthreads_or(tb[i * tb_step] > T_EPS) ? 1 : 0;

  // K8: this tile's rows; K5: the pool
  float* rows = FUSED ? dst : dst + ts.slot0 * 16;
  if (n_live == 0) return;

  const float rx = rays[px_idx * 3 + 0];
  const float ry = rays[px_idx * 3 + 1];
  const float rz = rays[px_idx * 3 + 2];
  const float pu = pix[px_idx * 2 + 0];
  const float pv = pix[px_idx * 2 + 1];
  const float* gp = gout + px_idx * 8;
  const float gD = gp[0], gA = gp[1], gN0 = gp[2], gN1 = gp[3], gN2 = gp[4];
  const float gdist = gp[6];
  const float D_total = outs[px_idx * 8 + 0];
  const float A_total = outs[px_idx * 8 + 1];
  const int* list = ts.list;

  float S_c = 0.0f, W_c = 0.0f, MD_c = 0.0f;   // strict-suffix carries
  for (int i = n_live - 1; i >= 0; --i) {
    __syncthreads();   // s_feat / s_red of the previous chunk are consumed
    const int n_c = min(C, count - i * C);
    stage_chunk(s_feat, F, list, i * C, n_c, p, P);
    __syncthreads();

    float T = tb[i * tb_step];
    for (int c = 0; c < n_c; ++c) {
      if (c % SUB == 0) s_tck[(c / SUB) * P + p] = T;
      const Geo g = splat_geometry(s_feat + c * FS, rx, ry, rz, pu, pv,
                                   width, inv_width);
      T *= 1.0f - g.alpha;
    }

    const int n_sub = (n_c + SUB - 1) / SUB;
    for (int s = n_sub - 1; s >= 0; --s) {
      const int c0 = s * SUB;
      const int c1 = min(c0 + SUB, n_c);
      T = s_tck[s * P + p];
      for (int c = c0; c < c1; ++c) {
        s_ti[(c - c0) * P + p] = T;
        const Geo g = splat_geometry(s_feat + c * FS, rx, ry, rz, pu, pv,
                                     width, inv_width);
        T *= 1.0f - g.alpha;
      }
      for (int c = c1 - 1; c >= c0; --c) {
        const float* f = s_feat + c * FS;
        const Geo g = splat_geometry(f, rx, ry, rz, pu, pv, width,
                                     inv_width);
        const float Ti = s_ti[(c - c0) * P + p];
        const float alpha = g.alpha;
        const float w = alpha * Ti;
        const float wm = w * g.m;
        float phi = gD * g.m + gA + (gN0 * f[9] + gN1 * f[10] + gN2 * f[11]);
        float A_prev = 0.0f, W_suf = 0.0f;
        if (with_dist) {
          W_suf = W_c;
          const float MD_suf = MD_c;
          A_prev = A_total - w - W_suf;
          const float D_prev = D_total - wm - MD_suf;
          phi += gdist * (g.m * A_prev - D_prev + MD_suf - g.m * W_suf);
        }
        const float one_m_a = fmaxf(1.0f - alpha, 1e-3f);
        const float galpha = alpha > 0.0f ? Ti * phi - S_c / one_m_a : 0.0f;
        float gm = w * gD;
        if (with_dist) gm += w * gdist * (A_prev - W_suf);
        const bool live = g.ok && (g.alpha_raw < ALPHA_MAX);
        const float g_opa = live ? galpha * g.g_exp : 0.0f;
        const float g_rho = live ? galpha * (-0.5f) * g.alpha_raw : 0.0f;
        const bool u3 = !g.use2;
        const float g_u = u3 ? g_rho * 2.0f * g.uu : 0.0f;
        const float g_v = u3 ? g_rho * 2.0f * g.vv : 0.0f;
        const float g_t = g_u * g.A1 + g_v * g.A2 + (u3 ? gm : 0.0f);
        const float g_np = g_t / g.A3;
        const float g_A3 = -g_t * g.tstar / g.A3;
        const float g_A1 = g_u * g.tstar;
        const float g_A2 = g_v * g.tstar;
        const float g_dx =
            g.use2 ? g_rho * 2.0f * FILTER_INV_SQUARE * g.dx : 0.0f;
        const float g_dy =
            g.use2 ? g_rho * 2.0f * FILTER_INV_SQUARE * g.dy : 0.0f;

        float v[16];
        v[0] = g_np * f[9] - g_u * f[3] - g_v * f[6];
        v[1] = g_np * f[10] - g_u * f[4] - g_v * f[7];
        v[2] = g_np * f[11] - g_u * f[5] - g_v * f[8];
        v[3] = rx * g_A1 - g_u * f[0];
        v[4] = ry * g_A1 - g_u * f[1];
        v[5] = rz * g_A1 - g_u * f[2];
        v[6] = rx * g_A2 - g_v * f[0];
        v[7] = ry * g_A2 - g_v * f[1];
        v[8] = rz * g_A2 - g_v * f[2];
        v[9] = rx * g_A3 + g_np * f[0] + gN0 * w;
        v[10] = ry * g_A3 + g_np * f[1] + gN1 * w;
        v[11] = rz * g_A3 + g_np * f[2] + gN2 * w;
        v[12] = g_opa;
        v[13] = g.use2 ? gm : 0.0f;
        v[14] = -g_dx;
        v[15] = -g_dy;

        S_c += w * phi;
        W_c += w;
        MD_c += wm;

#pragma unroll
        for (int k = 0; k < 16; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        }
        if (lane == 0) {
          float* r = s_red + ((c - c0) * NW + warp) * 16;
#pragma unroll
          for (int k = 0; k < 16; ++k) r[k] = v[k];
        }
      }
      __syncthreads();
      // every slot here is composited: c < n_c <= count - i * C
      for (int idx = p; idx < (c1 - c0) * 16; idx += P) {
        const int jj = idx >> 4;
        const int k = idx & 15;
        float acc = 0.0f;
        for (int wi = 0; wi < NW; ++wi) acc += s_red[(jj * NW + wi) * 16 + k];
        const int slot = i * C + c0 + jj;
        if (FUSED)
          atomicAdd(rows + (size_t)list[slot] * 16 + k, acc);
        else
          rows[(size_t)slot * 16 + k] = acc;
      }
      __syncthreads();
    }
  }
}

inline size_t raster_bwd_smem(int C, int P) {
  return (size_t)(C * FS + (C / BWD_SUB) * P + BWD_SUB * P +
                  BWD_SUB * (P / 32) * 16) *
         sizeof(float);
}

// Launch over n_tiles blocks of P threads; returns the CUDA error code.
template <bool FUSED, bool FLAT>
int launch_raster_bwd_impl(const float* F, SlotLayout L, const float* rays,
                           const float* pix, const float* tbound,
                           const float* outs, const float* g, float* dst,
                           int n_tiles, int C, int P, float width,
                           float inv_width, int with_dist,
                           cudaStream_t stream) {
  const size_t smem = raster_bwd_smem(C, P);
  cudaError_t err = cudaFuncSetAttribute(
      raster_bwd_kernel<FUSED, FLAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  raster_bwd_kernel<FUSED, FLAT><<<n_tiles, P, smem, stream>>>(
      F, L, rays, pix, tbound, outs, g, dst, C, width, inv_width, with_dist);
  return (int)cudaGetLastError();
}

// Resident warps per SM of a P-thread block at chunk C, or minus the CUDA
// error code.
template <bool FUSED, bool FLAT>
int raster_bwd_resident_warps(int C, int P) {
  const size_t smem = raster_bwd_smem(C, P);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      raster_bwd_kernel<FUSED, FLAT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, raster_bwd_kernel<FUSED, FLAT>, P, smem);
  return err != cudaSuccess ? -(int)err : blocks * (P / 32);
}

}  // namespace splat

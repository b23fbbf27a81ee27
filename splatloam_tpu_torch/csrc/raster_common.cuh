// Shared per-(pixel, surfel) geometry of the rasterizer kernels.
//
// Same arithmetic as splatloam_tpu/ops/rasterizer/pallas_raster.py:
// _splat_geometry and the plain versions in ops/rasterizer/kernels.py:
// the ray-plane hit t*, the local ellipse coordinates, the azimuth-
// wrapped screen-space filter, rho = min(rho3, rho2) and
// alpha = min(0.999, opacity * exp(-rho / 2)), zeroed below 1/255 or for
// t* <= NEAR.
#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.999f;
constexpr float NEAR = 0.05f;
constexpr float T_EPS = 1e-4f;
constexpr float FILTER_INV_SQUARE = 2.0f;

// a staged surfel: its F row (0:3 p | 3:6 gu | 6:9 gv | 9:12 n |
// 12 opacity | 13 depth | 14 cx | 15 cy), then n.p, p.gu, p.gv
constexpr int FS = 20;

// Copy the features of slots [c0, c0 + n_c) of one tile's list into shared
// memory (F rows are 64-byte aligned: four float4 loads each).
__device__ __forceinline__ void stage_chunk(float* s, const float* F,
                                            const int* list, int c0,
                                            int n_c, int tid, int nthr) {
  for (int c = tid; c < n_c; c += nthr) {
    const float4* src =
        reinterpret_cast<const float4*>(F + (size_t)list[c0 + c] * 16);
    float4 q[4] = {src[0], src[1], src[2], src[3]};
    float* d = s + c * FS;
    const float* f = reinterpret_cast<const float*>(q);
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = f[k];
    d[16] = f[9] * f[0] + f[10] * f[1] + f[11] * f[2];   // n.p
    d[17] = f[0] * f[3] + f[1] * f[4] + f[2] * f[5];     // p.gu
    d[18] = f[0] * f[6] + f[1] * f[7] + f[2] * f[8];     // p.gv
    d[19] = 0.0f;
  }
}

// How a block finds its tile's slots.  Tiled layout (K1, K2, K5): ids are
// the lists [T, K] and meta the counts [T]; slot j of tile t is
// ids[t * K + j], j < counts[t].  Flat layout (K7, K8): ids are the views'
// flat slot pools [B, E] (E = slots_per_view) and meta their chunk-aligned
// segment starts [B, T_view + 1]; tile t of view v owns the whole chunks
// [starts[v, t], starts[v, t + 1]) of its view's pool, pads included
// (they point at a zero feature row and composite to nothing).  Budget
// chunks past starts[v, T_view] belong to no block.
struct SlotLayout {
  const int* ids;
  const int* meta;
  int slots_per_view;   // tiled: K; flat: E
  int tiles_per_view;   // flat only
};

struct TileSlots {
  const int* list;   // the tile's first slot id
  int count;         // slots to composite
  size_t slot0;      // the tile's first slot in the layout's slot space
};

template <bool FLAT>
__device__ __forceinline__ TileSlots tile_slots(const SlotLayout& L, int t,
                                                int C) {
  if (FLAT) {
    const int v = t / L.tiles_per_view;
    const int* st = L.meta + v * (L.tiles_per_view + 1) + t % L.tiles_per_view;
    const size_t slot0 = (size_t)v * L.slots_per_view + st[0];
    return {L.ids + slot0, st[1] - st[0], slot0};
  }
  const size_t slot0 = (size_t)t * L.slots_per_view;
  return {L.ids + slot0, L.meta[t], slot0};
}

// Chunk i's start T at tile pixel px: tiled [T, P, K/C] (pixel-major per
// tile), flat [B*E/C, P] (chunk-major over the flat chunks).  The forward
// writes it (Float = float), the backward reads it (const float).
template <typename Float>
struct TBoundOf {
  Float* base;
  int px_step, chunk_step;
  __device__ __forceinline__ Float& at(int px, int i) const {
    return base[px * px_step + i * chunk_step];
  }
};
using TBound = TBoundOf<const float>;

template <bool FLAT, typename Float>
__device__ __forceinline__ TBoundOf<Float> tbound_of(Float* tbound,
                                                     const SlotLayout& L,
                                                     const TileSlots& ts,
                                                     int t, int C, int P) {
  if (FLAT) return {tbound + ts.slot0 / C * P, 1, P};
  const int nc = L.slots_per_view / C;
  return {tbound + (size_t)t * P * nc, nc, 1};
}

struct Geo {
  float A1, A2, A3, tstar, uu, vv, m, g_exp, alpha_raw, alpha, dx, dy;
  bool use2, ok;
};

__device__ __forceinline__ Geo splat_geometry(const float* f, float rx,
                                              float ry, float rz, float px,
                                              float py, float width,
                                              float inv_width) {
  Geo g;
  g.A1 = rx * f[3] + ry * f[4] + rz * f[5];
  g.A2 = rx * f[6] + ry * f[7] + rz * f[8];
  const float a3 = rx * f[9] + ry * f[10] + rz * f[11];
  // the guard replaces |A3| < 1e-8 by +1e-8, dropping the sign
  g.A3 = fabsf(a3) < 1e-8f ? 1e-8f : a3;
  g.tstar = f[16] / g.A3;
  g.uu = g.tstar * g.A1 - f[17];
  g.vv = g.tstar * g.A2 - f[18];
  const float rho3 = g.uu * g.uu + g.vv * g.vv;
  float dx = px - f[14];
  dx = dx - rintf(dx * inv_width) * width;   // round half to even
  const float dy = py - f[15];
  const float rho2 = FILTER_INV_SQUARE * (dx * dx + dy * dy);
  g.use2 = rho2 < rho3;
  const float rho = g.use2 ? rho2 : rho3;
  g.m = g.use2 ? f[13] : g.tstar;
  g.g_exp = expf(-0.5f * rho);
  g.alpha_raw = f[12] * g.g_exp;
  g.ok = (g.tstar > NEAR) && (g.alpha_raw >= ALPHA_MIN);
  g.alpha = g.ok ? fminf(g.alpha_raw, ALPHA_MAX) : 0.0f;
  g.dx = dx;
  g.dy = dy;
  return g;
}

}  // namespace splat

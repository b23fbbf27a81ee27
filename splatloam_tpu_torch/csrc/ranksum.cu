// K3: segmented sum of id-sorted gradient rows into dense rank rows.
//
// Replaces splatloam_tpu/ops/rasterizer/pallas_raster.py:_ranksum_kernel
// (and the row gather in front of it in _reduce_rows_with_ranksum).
//
// dFc[ranks[e]] = sum of rows[pos[e]] over the entries e of each rank,
// for ranks >= 0 other than the padding id's rank *pad_rank.  The ranks
// come from the rebin-time plan (ops/rasterizer/binning.py:
// build_ranksum_plan): entries sorted by surfel id, dense ranks over the
// ids that occur, non-decreasing up to a tail of -1 pads.  The padding id
// N is the largest, so its entries form one segment at the end of the
// real ranks; the caller drops its row (F's pad row N is a constant, so
// nothing reads its gradient) and reads each surfel's row as
// dFc[rank_of_id].  Rows no entry writes (the pad rank's, those past the
// last rank, the dummy row of absent ids) keep the caller's zero fill.
//
// Bound on the H100: bytes.  Each real entry reads one 64-byte row at a
// random slot position plus 8 bytes of plan, and each real rank writes
// one 64-byte row.
//
// Design: one thread per entry, no atomics, deterministic.  The entry
// that starts a segment (e == 0 or ranks[e - 1] != ranks[e]) owns it:
// it finds the segment's length among the next SHORT ranks, sums the
// rows with float4 loads and stores the rank row with four float4 stores,
// wherever the segment ends.  A segment longer than SHORT entries (a
// surfel binned to many tiles: up to 832 entries on the mapper's plans)
// is summed by the owner's whole warp instead, 128 entries a step (lane
// l takes entries l, l + 32, ...), and reduced over the warp with a
// reduce-scatter butterfly.  Every walk starts its loads together
// (unrolled, unconditional where a predicate would wait on a load): a
// block takes as long as its longest walk's chain of dependent loads.
// A block whose first entry has the pad rank or -1 holds nothing else
// (ranks never decrease before the -1 tail) and returns at once, so the
// pad segment (65% of the entries at the main path's shapes) costs one
// load per block; atomics on its one row would serialize ~16,000 warps.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SHORT = 16;   // longest segment one thread walks alone
constexpr int LONG_STEP = 4;   // 32-entry rows a warp loads at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void add_row(float4 (&acc)[4], const float* rows,
                                        int slot) {
  const float4* src = reinterpret_cast<const float4*>(rows + (size_t)slot * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = __ldg(src + q);
    acc[q].x += a.x;
    acc[q].y += a.y;
    acc[q].z += a.z;
    acc[q].w += a.w;
  }
}

// Sum 16 values over the warp; lanes 2c and 2c + 1 return the sum of
// value c (raster_bwd.cu's butterfly).
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

__global__ void __launch_bounds__(THREADS)
ranksum_kernel(const float* __restrict__ rows, const int* __restrict__ pos,
               const int* __restrict__ ranks,
               const int* __restrict__ pad_rank, float* __restrict__ dFc,
               int E) {
  const int pad = *pad_rank;
  const int e0 = blockIdx.x * THREADS;
  const int r0 = ranks[e0];
  if (r0 < 0 || r0 == pad) return;   // the whole block is pad entries
  const int e = e0 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int r = e < E ? ranks[e] : -1;
  const bool owner =
      r >= 0 && r != pad && (e == 0 || __ldg(ranks + e - 1) != r);

  float4 acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool is_long = false;
  if (owner) {
    // the segment's length, up to SHORT + 1, from the next SHORT ranks
    // (loaded at once: the loads do not wait on each other)
    int n = 1;
#pragma unroll
    for (int k = 1; k <= SHORT; ++k) {
      const int rk = __ldg(ranks + min(e + k, E - 1));
      if (n == k && e + k < E && rk == r) ++n;
    }
    is_long = n > SHORT;
    if (!is_long) {
#pragma unroll
      for (int k = 0; k < SHORT; ++k)
        if (k < n) add_row(acc, rows, __ldg(pos + e + k));
      float4* dst = reinterpret_cast<float4*>(dFc + (size_t)r * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = acc[q];
    }
  }

  // long segments: the owner's warp sums each one
  unsigned longs = __ballot_sync(FULL, is_long);
  while (longs) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1;
    const int es = __shfl_sync(FULL, e, src);
    const int rs = __shfl_sync(FULL, r, src);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = es;; base += LONG_STEP * 32) {
      // a step's ranks, slots and rows load unconditionally (entries past
      // the segment read valid rows and add nothing), so its loads are
      // two dependent rounds, not three per entry
      bool in[LONG_STEP];
      int slot[LONG_STEP];
#pragma unroll
      for (int u = 0; u < LONG_STEP; ++u) {
        const int k = base + u * 32 + lane;
        in[u] = k < E && __ldg(ranks + min(k, E - 1)) == rs;
        slot[u] = __ldg(pos + min(k, E - 1));
      }
#pragma unroll
      for (int u = 0; u < LONG_STEP; ++u) {
        float4 row[4] = {};
        add_row(row, rows, slot[u]);
        if (in[u]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q].x += row[q].x;
            acc[q].y += row[q].y;
            acc[q].z += row[q].z;
            acc[q].w += row[q].w;
          }
        }
      }
      // the segment is contiguous: it ends inside this step unless the
      // step's last entry is still in it
      if (!__shfl_sync(FULL, in[LONG_STEP - 1], 31)) break;
    }
    float v[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[4 * q] = acc[q].x;
      v[4 * q + 1] = acc[q].y;
      v[4 * q + 2] = acc[q].z;
      v[4 * q + 3] = acc[q].w;
    }
    const float col = reduce_scatter16(v, lane);
    if (!(lane & 1)) dFc[(size_t)rs * 16 + (lane >> 1)] = col;
  }
}

}  // namespace

// dFc [R, 16] arrives zeroed; pad_rank is one int on the device.
extern "C" int launch_ranksum_rows(const float* rows, const int* pos,
                                   const int* ranks, const int* pad_rank,
                                   float* dFc, int E, cudaStream_t stream) {
  if (E == 0) return 0;
  ranksum_kernel<<<(E + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      rows, pos, ranks, pad_rank, dFc, E);
  return (int)cudaGetLastError();
}

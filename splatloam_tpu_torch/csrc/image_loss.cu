// K11: the mapper's image losses of each view and their cotangent, from
// the forward's tiled output.
//
// Replaces no TPU kernel: the JAX package leaves this part of each Adam
// iteration to XLA (splatloam_tpu/ops/rasterizer/api.py:_decode and the
// losses of splatloam_tpu/slam/mapper.py:_loss), where the port ran it as
// ~190 small PyTorch kernels (the decode, the three losses, their
// autograd) between K1 and K2.
//
// Per view b, over the H x W pixels of K1's output out [B*T, P, 8]
// (tiles row-major, pixels row-major within a tile; channels depth_sum
// D, alpha A, normal_sum N[3], median M, distortion, final T):
//   surf depth  sd = (A > 0 ? D / A : 0) (1 - r) + M r     (r = depth_ratio)
//   rend normal rn = A > 0 ? N / A : 0
//   surf normal sn = A n(sd), n the unit normal of the central
//               differences of the back-projected points sd * ray (zero
//               on the 1-pixel border and where |n| <= 1e-12)
//   loss = sum |w (sd - gt)| / (H W)
//        + lambda_a sum -log(clamp(A, 1e-7, 1 - 1e-7)) w / n_valid
//        + lambda_n sum (1 - rn . sn) w / n_valid
// with w the keyframe's valid mask and n_valid = max(sum w, 1): exactly
// api._decode followed by the mapper's image losses.  The kernel writes
// the loss [B] and its cotangent g [B*T, P, 8] in K2's layout: depth_sum,
// alpha (final T's cotangent is 0, so nothing is folded into it), the
// normal sum, the median (only with depth_ratio > 0), 0 for the
// distortion and final T.
//
// Frames: the decode turns both normals into the world frame with the
// keyframe's R_wc, and the back-projected points by R_wc and t_wc.  The
// translation cancels in the differences, a rotation commutes with the
// cross product, and neither a dot product of two rotated vectors nor a
// norm changes under it, so the loss and its cotangent do not depend on
// the pose: the kernel works in the camera frame and takes only K.
//
// Bound on the H100: bytes (a few dozen operations a pixel).  It reads
// out, the keyframe's depth and mask once and writes g once: ~9 MB at
// 128 x 1024, about 2.7 us at 3.35 TB/s.
//
// Design: two grids of 256-pixel blocks in tile order, one launch
// sequence.  The normal term ties each pixel's depth to its neighbours'
// (a pixel's point enters the normals of its 4 neighbours), so the first
// grid computes each pixel's own terms: its normal n, and the adjoints of
// its two point differences (the cotangent of the normal through the
// normalisation and the cross product), written to a [B, 9, H, W]
// scratch, and each block's partial sums of the three loss terms and of
// the valid count.  The second grid sums a view's partials in a fixed
// order (every block the valid count, the view's first block the loss),
// so the sums are deterministic and need no atomics, gathers the
// neighbours' adjoints into each pixel's depth cotangent, and writes g.
// A pixel's neighbours' surface depths are recomputed from out (L2
// resident), and the rays from K, not read.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // pixels a block (kernels.py: LOSS_BLOCK)
constexpr int WARPS = THREADS / 32;
constexpr int NSCR = 9;        // scratch channels: n, the dx and dy adjoints
constexpr float A_LO = 1e-7f;
constexpr float A_HI = (float)(1.0 - 1e-7);
constexpr float DEGENERATE = 1e-24f;
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int H, W, th, tw, txn, T, P;
  float lambda_n, lambda_a, r, one_m_r;
  int med;
};

struct Cam {
  float fx, cx, fy, cy;
};

__device__ __forceinline__ float3 operator+(float3 a, float3 b) {
  return make_float3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 operator-(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 operator*(float s, float3 a) {
  return make_float3(s * a.x, s * a.y, s * a.z);
}
__device__ __forceinline__ float dot(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ Cam cam_of(const float* K, int b) {
  const float* k = K + b * 9;
  return {k[0], k[2], k[4], k[5]};
}

// geometry/spherical.py:pixel_rays for pixel (i, j)
__device__ __forceinline__ float3 ray(const Cam& c, int i, int j) {
  const float theta = ((float)j - 0.5f - c.cx) / c.fx;
  const float phi = ((float)i - 0.5f - c.cy) / c.fy;
  float s0, c0, s1, c1;
  sincosf(theta, &s0, &c0);
  sincosf(phi, &s1, &c1);
  return make_float3(c0 * c1, s0 * c1, s1);
}

// offset of pixel (i, j) of view b in the tiled [B*T, P, 8] layout
__device__ __forceinline__ size_t tiled(const Geo& g, int b, int i, int j) {
  const int t = (i / g.th) * g.txn + j / g.tw;
  const int p = (i % g.th) * g.tw + j % g.tw;
  return ((size_t)b * g.T * g.P + (size_t)t * g.P + p) * 8;
}

__device__ __forceinline__ float surf_depth(const Geo& g, float D, float A,
                                            float M) {
  const float de = A > 0.0f ? D / A : 0.0f;
  return g.med ? de * g.one_m_r + M * g.r : de;
}

__device__ __forceinline__ float3 point_at(const float* out, const Geo& g,
                                           const Cam& c, int b, int i,
                                           int j) {
  const float* o = out + tiled(g, b, i, j);
  const float2 da = *reinterpret_cast<const float2*>(o);
  const float sd = surf_depth(g, da.x, da.y, g.med ? o[5] : 0.0f);
  return sd * ray(c, i, j);
}

// One pixel's channels.
struct Pixel {
  int i, j;
  float D, A, M, gt, w, sd;
  float3 N, rn;
};

__device__ __forceinline__ Pixel load_pixel(const float* out,
                                            const float* depth,
                                            const unsigned char* valid,
                                            const Geo& g, int b, int idx) {
  Pixel q;
  const int t = idx / g.P, p = idx % g.P;
  q.i = (t / g.txn) * g.th + p / g.tw;
  q.j = (t % g.txn) * g.tw + p % g.tw;
  const float* o = out + ((size_t)b * g.T * g.P + idx) * 8;
  const float4 o0 = *reinterpret_cast<const float4*>(o);
  const float4 o1 = *reinterpret_cast<const float4*>(o + 4);
  q.D = o0.x;
  q.A = o0.y;
  q.N = make_float3(o0.z, o0.w, o1.x);
  q.M = g.med ? o1.y : 0.0f;
  const float sa = q.A > 0.0f ? q.A : 1.0f;
  q.rn = q.A > 0.0f ? make_float3(q.N.x / sa, q.N.y / sa, q.N.z / sa)
                    : make_float3(0.0f, 0.0f, 0.0f);
  q.sd = surf_depth(g, q.D, q.A, q.M);
  const size_t px = (size_t)b * g.H * g.W + (size_t)q.i * g.W + q.j;
  q.gt = depth[px];
  q.w = valid[px] ? 1.0f : 0.0f;
  return q;
}

__device__ __forceinline__ float* scratch_at(float* scratch, const Geo& g,
                                             int b, int ch, int i, int j) {
  return scratch + (((size_t)b * NSCR + ch) * g.H + i) * g.W + j;
}

__device__ __forceinline__ float3 load3(const float* scratch, const Geo& g,
                                        int b, int ch, int i, int j) {
  const size_t hw = (size_t)g.H * g.W;
  const float* s = scratch + (((size_t)b * NSCR + ch) * g.H + i) * g.W + j;
  return make_float3(s[0], s[hw], s[2 * hw]);
}

// v[k] summed over the block: each warp's in a fixed shuffle order, then
// the warps' in order; every thread returns the sums
__device__ __forceinline__ void block_sum4(float (&v)[4],
                                           float (*sh)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int off = 16; off; off >>= 1)
      v[k] += __shfl_down_sync(FULL, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 4; ++k) sh[k][warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sh[k][w];
    v[k] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
image_loss_pixels(const float* __restrict__ out,
                  const float* __restrict__ depth,
                  const unsigned char* __restrict__ valid,
                  const float* __restrict__ K, float* __restrict__ scratch,
                  float* __restrict__ partials, Geo g) {
  __shared__ float sh[4][WARPS];
  const int b = blockIdx.y;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (idx < g.H * g.W) {
    const Pixel q = load_pixel(out, depth, valid, g, b, idx);
    float3 n = make_float3(0.0f, 0.0f, 0.0f);
    float3 gdx = n, gdy = n;
    if (q.i >= 1 && q.i <= g.H - 2 && q.j >= 1 && q.j <= g.W - 2) {
      const Cam c = cam_of(K, b);
      const float3 dx = point_at(out, g, c, b, q.i + 1, q.j) -
                        point_at(out, g, c, b, q.i - 1, q.j);
      const float3 dy = point_at(out, g, c, b, q.i, q.j + 1) -
                        point_at(out, g, c, b, q.i, q.j - 1);
      const float3 nr = cross(dy, dx);
      const float n2 = dot(nr, nr);
      if (n2 > DEGENERATE) {
        const float s = sqrtf(n2);
        n = make_float3(nr.x / s, nr.y / s, nr.z / s);
        // the normal term's cotangent of n (before the 1 / n_valid the
        // second grid applies), through the normalisation and the cross
        // product onto the two differences
        const float3 gn = (-g.lambda_n * q.w * q.A) * q.rn;
        const float3 gr = (1.0f / s) * (gn - dot(n, gn) * n);
        gdx = cross(gr, dy);
        gdy = cross(dx, gr);
      }
    }
    const float3 sn = q.A * n;
    const float a = q.A < A_LO ? A_LO : (q.A > A_HI ? A_HI : q.A);
    part[0] = fabsf(q.w * (q.sd - q.gt));
    part[1] = -logf(a) * q.w;
    part[2] = (1.0f - dot(q.rn, sn)) * q.w;
    part[3] = q.w;
    const float vals[NSCR] = {n.x, n.y, n.z, gdx.x, gdx.y, gdx.z,
                              gdy.x, gdy.y, gdy.z};
#pragma unroll
    for (int ch = 0; ch < NSCR; ++ch)
      *scratch_at(scratch, g, b, ch, q.i, q.j) = vals[ch];
  }
  block_sum4(part, sh);
  if (threadIdx.x < 4)
    partials[((size_t)b * gridDim.x + blockIdx.x) * 4 + threadIdx.x] =
        part[threadIdx.x];
}

__global__ void __launch_bounds__(THREADS)
image_loss_grad(const float* __restrict__ out,
                const float* __restrict__ depth,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ K,
                const float* __restrict__ scratch,
                const float* __restrict__ partials,
                float* __restrict__ loss, float* __restrict__ gout, Geo g) {
  __shared__ float sh[4][WARPS];
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const bool first = blockIdx.x == 0;
  // the view's sums over the first grid's blocks, in a fixed order
  float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* pv = partials + (size_t)b * nblk * 4;
  for (int k = threadIdx.x; k < nblk; k += THREADS) {
    tot[3] += pv[k * 4 + 3];
    if (first) {
      tot[0] += pv[k * 4];
      tot[1] += pv[k * 4 + 1];
      tot[2] += pv[k * 4 + 2];
    }
  }
  block_sum4(tot, sh);
  const float hw = (float)(g.H * g.W);
  const float nv = fmaxf(tot[3], 1.0f);
  if (first && threadIdx.x == 0)
    loss[b] = tot[0] / hw + tot[1] / nv * g.lambda_a +
              tot[2] / nv * g.lambda_n;

  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= g.H * g.W) return;
  const Pixel q = load_pixel(out, depth, valid, g, b, idx);
  const int i = q.i, j = q.j;
  const float3 n = load3(scratch, g, b, 0, i, j);
  // the adjoints of the differences this pixel's point enters: +dx of the
  // pixel above, -dx of the one below, +dy of the left, -dy of the right
  float3 gp = make_float3(0.0f, 0.0f, 0.0f);
  if (i >= 1) gp = gp + load3(scratch, g, b, 3, i - 1, j);
  if (i <= g.H - 2) gp = gp - load3(scratch, g, b, 3, i + 1, j);
  if (j >= 1) gp = gp + load3(scratch, g, b, 6, i, j - 1);
  if (j <= g.W - 2) gp = gp - load3(scratch, g, b, 6, i, j + 1);
  const float inv = 1.0f / nv;
  const float x = q.w * (q.sd - q.gt);
  const float sgn = (float)(x > 0.0f) - (float)(x < 0.0f);
  const float g_sd = dot(ray(cam_of(K, b), i, j), gp) * inv +
                     q.w * sgn / hw;
  // the normal term at this pixel: d(rn . A n)
  const float c = -g.lambda_n * inv * q.w;
  const float3 g_rn = c * (q.A * n);
  float g_A = c * dot(q.rn, n);
  if (q.A >= A_LO && q.A <= A_HI) g_A -= g.lambda_a * inv * q.w / q.A;
  const float g_de = g.med ? g.one_m_r * g_sd : g_sd;
  float g_D = 0.0f;
  float3 g_N = make_float3(0.0f, 0.0f, 0.0f);
  if (q.A > 0.0f) {
    g_D = g_de / q.A;
    g_N = make_float3(g_rn.x / q.A, g_rn.y / q.A, g_rn.z / q.A);
    g_A -= (g_de * q.D + dot(g_rn, q.N)) / (q.A * q.A);
  }
  float* o = gout + ((size_t)b * g.T * g.P + idx) * 8;
  *reinterpret_cast<float4*>(o) = make_float4(g_D, g_A, g_N.x, g_N.y);
  *reinterpret_cast<float4*>(o + 4) =
      make_float4(g_N.z, g.med ? g.r * g_sd : 0.0f, 0.0f, 0.0f);
}

}  // namespace

// out [B*T, P, 8], depth [B, H, W] float, valid [B, H, W] bool, K
// [B, 3, 3]; scratch [B, 9, H, W] and partials [B, ceil(H*W / 256), 4]
// are the sequence's own (written before they are read); writes loss [B]
// and gout [B*T, P, 8].
extern "C" int launch_image_loss(const float* out, const float* depth,
                                 const unsigned char* valid, const float* K,
                                 float* scratch, float* partials, float* loss,
                                 float* gout, int B, int H, int W,
                                 int tile_h, int tile_w, float lambda_n,
                                 float lambda_a, float depth_ratio,
                                 float one_m_r, cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  Geo g;
  g.H = H;
  g.W = W;
  g.th = tile_h;
  g.tw = tile_w;
  g.txn = W / tile_w;
  g.T = (H / tile_h) * g.txn;
  g.P = tile_h * tile_w;
  g.lambda_n = lambda_n;
  g.lambda_a = lambda_a;
  g.r = depth_ratio;
  g.one_m_r = one_m_r;
  g.med = depth_ratio > 0.0f;
  const dim3 grid((H * W + THREADS - 1) / THREADS, B);
  image_loss_pixels<<<grid, THREADS, 0, stream>>>(out, depth, valid, K,
                                                  scratch, partials, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  image_loss_grad<<<grid, THREADS, 0, stream>>>(out, depth, valid, K, scratch,
                                                partials, loss, gout, g);
  return (int)cudaGetLastError();
}

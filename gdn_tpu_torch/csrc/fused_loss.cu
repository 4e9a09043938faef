// Fused depth loss (masked L1 + scale-0 gradient L1 + SSIM) for Hopper
// (sm_90a): a forward that reduces each image to its 8 partial sums, and
// the analytic backward that gives dL/dpred.  Plain C interface for ctypes.
//
// Replaces the TPU kernels of gdn_tpu/kernels/fused_loss.py:
//   _call_fwd (the pl.pallas_call at line 187): per image
//     [S|p-g|m, Sm, S|dx p - dx g|m_dx, Sm_dx, S|dy p - dy g|m_dy, Sm_dy,
//      S SSIM(p/max, g/max), H*W]
//   _call_bwd (line 220): dL/dpred for per-image cotangents
//     (ct_l1, ct_gx, ct_gy, ct_ssim): the L1 sign field, the scatter of the
//     forward-difference signs, and the closed-form SSIM adjoint
//     ct_ssim/max * [Wt(a1 - 2 mu_x a3 - mu_y a5) + 2 pn Wt(a3) + gn Wt(a5)]
//     with Wt the transposed blur.
// SSIM: 11x11 separable Gaussian (sigma 1.5) window, reflect-101 edges,
// C1 = 1e-4, C2 = 9e-4 on inputs normalized by 1/max_depth; all in fp32
// (the JAX package's ssim_precision="highest").
//
// What bounds it: operations.  The TPU kernel applies the window as two
// dense band-matrix matmuls on the MXU (~544 multiply-adds a pixel per blur
// at 128x416); here each blur is the 11-tap stencil (22 multiply-adds a
// pixel, ~25x less arithmetic).  Per pixel the forward then does ~260 fp32
// operations against 12 bytes read (pred, gt, mask), the backward ~420
// against 16 bytes (3 read, 1 written): both sit near the card's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 operations a byte), the arithmetic
// slightly above it.
//
// Design.
//   forward  (16 x 32 tiles, 5-pixel halo)
//            1. loss_tile: a block stages its tile of pred/max and gt/max
//               with the halo in shared memory (each input pixel read from
//               device memory ~1.6 times), runs the horizontal pass (5
//               moments over the halo rows), the vertical pass and the SSIM
//               map; the L1 and gradient terms from the raw maps (each
//               forward difference is owned by its left/top pixel).  It
//               reduces its 7 sums in a fixed order into (B, tiles, 8).
//            2. fold_partials: one block per image adds its tiles in order
//               -> (B, 8); column 7 is H*W.  No atomics: deterministic.
//   backward (one launch, loss_backward): a block owns a 32 x 64 output
//            tile.  It stages raw pred and gt for the tile plus a 10-pixel
//            halo (5 for the moments' blur, 5 for the adjoint maps' blur)
//            and the mask for the tile plus 1 (4-byte cp.async copies, all
//            in flight at once), the reflect index computed once a row and once a
//            column; takes the L1 and difference terms and pred/max, gt/max
//            of its outputs into registers; normalizes the staged maps; then
//            computes the moments and the three adjoint maps (a1 - 2 mu_x
//            a3 - mu_y a5, a3, a5) for the tile plus 5, zero outside the
//            image, in shared memory only; applies the transposed blur, rows
//            then columns, and stores dpred.  Nothing but dpred goes to
//            device memory.  Every stencil pass gives a thread 4 outputs
//            along its line, so an 11-tap pass loads 14 values for 4 outputs
//            (not 44), the taps unrolled (the half-window is a template
//            parameter); rows are laid out with an odd stride where a warp
//            walks down columns, so its 32 lanes meet 32 banks.  The tile is
//            32 x 64 rather than the forward's 16 x 32 so that the 10-pixel
//            halo costs 1.9x the tile's staging, not 3.5x, at two blocks an
//            SM (114,760 bytes of shared memory each: the moments' buffer is
//            reused for the row pass of the transposed blur, the staged
//            inputs' for the adjoint maps).  A tile within `half` of an
//            image edge along x (y) adds the folded reflect taps in the row
//            (column) pass; the others run the plain 11-tap stencil, chosen
//            once a tile (template).
// The transposed blur is not the forward stencil again: under reflect-101
// the band matrix is not symmetric near an edge (M[0,5] = g0 + g10,
// M[5,0] = g0).  Wt x = (zero-padded stencil of x) + (the reflected taps
// folded back onto their source pixels): output j in [1, half] also takes
// sum_{i=0}^{half-j} g[half-i-j] x[i], and j in [n-1-half, n-2] takes
// sum_{i=2n-2-j-half}^{n-1} g[2n-2-j+half-i] x[i].  Every such i lies
// within `half` of j, so the halo holds it.
//
// Because the adjoint maps are zero outside the image, the zero-padded
// stencil needs no edge test: only the folded taps do.
//
// Layout: pred, gt, mask (B, H, W) fp32 contiguous; weights the 2*half+1
// fp32 taps; cts (B, 4) fp32.  H, W >= 6 and half <= 5 (checked).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 32;    // tile width (one warp across)
constexpr int kTH = 16;    // tile height
constexpr int kHalo = 5;   // largest half-window
constexpr int kRows = kTH + 2 * kHalo;
constexpr int kCols = kTW + 2 * kHalo;
constexpr int kThreads = 256;  // blockDim (32, 8)
constexpr int kSums = 7;

// reflect-101 (exact for -n < j < 2n-1), then clamped so that a halo
// position no output needs still reads inside the image
__device__ __forceinline__ int reflect(int j, int n) {
  j = j < 0 ? -j : j;
  j = j >= n ? 2 * n - 2 - j : j;
  return min(max(j, 0), n - 1);
}

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Forward: the block's 7 partial sums into partials.
__global__ void __launch_bounds__(kThreads)
loss_tile(const float* __restrict__ pred, const float* __restrict__ gt,
          const float* __restrict__ mask, const float* __restrict__ weights,
          int H, int W, int half, float inv_max, float c1, float c2,
          float* __restrict__ partials) {
  __shared__ float wt[2 * kHalo + 1];
  __shared__ float sp[kRows][kCols + 1];  // pred / max
  __shared__ float sg[kRows][kCols + 1];  // gt / max
  __shared__ float hm[5][kRows][kTW + 1];  // row-blurred x, y, xx, yy, xy
  __shared__ float red[kThreads / 32][kSums];
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * kTW, r0 = blockIdx.y * kTH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTW + tx;
  const size_t img = (size_t)b * H * W;
  if (tid <= 2 * half) wt[tid] = weights[tid];
  for (int i = tid; i < kRows * kCols; i += kThreads) {
    const int rr = i / kCols, cc = i % kCols;
    const size_t off = img + (size_t)reflect(r0 + rr - kHalo, H) * W +
                       reflect(c0 + cc - kHalo, W);
    sp[rr][cc] = pred[off] * inv_max;
    sg[rr][cc] = gt[off] * inv_max;
  }
  __syncthreads();
  const int t0 = kHalo - half;
  for (int i = tid; i < kRows * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i % kTW;
    float x = 0.f, y = 0.f, xx = 0.f, yy = 0.f, xy = 0.f;
    for (int t = 0; t <= 2 * half; ++t) {
      const float w = wt[t], a = sp[rr][cc + t0 + t], g = sg[rr][cc + t0 + t];
      x += w * a;
      y += w * g;
      xx += w * (a * a);
      yy += w * (g * g);
      xy += w * (a * g);
    }
    hm[0][rr][cc] = x;
    hm[1][rr][cc] = y;
    hm[2][rr][cc] = xx;
    hm[3][rr][cc] = yy;
    hm[4][rr][cc] = xy;
  }
  __syncthreads();
  float acc[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int c = c0 + tx;
  for (int rr = ty; rr < kTH; rr += kThreads / kTW) {
    const int r = r0 + rr;
    if (r >= H || c >= W) continue;
    float mx = 0.f, my = 0.f, mxx = 0.f, myy = 0.f, mxy = 0.f;
    for (int t = 0; t <= 2 * half; ++t) {
      const float w = wt[t];
      const int row = rr + t0 + t;
      mx += w * hm[0][row][tx];
      my += w * hm[1][row][tx];
      mxx += w * hm[2][row][tx];
      myy += w * hm[3][row][tx];
      mxy += w * hm[4][row][tx];
    }
    // clamped: non-negative in exact math
    const float sxx = fmaxf(mxx - mx * mx, 0.f);
    const float syy = fmaxf(myy - my * my, 0.f);
    const float sxy = mxy - mx * my;
    const float n1 = 2.f * mx * my + c1;
    const float n2 = 2.f * sxy + c2;
    const float d1 = mx * mx + my * my + c1;
    const float d2 = sxx + syy + c2;
    const float s = (n1 * n2) / (d1 * d2);
    const size_t px = img + (size_t)r * W + c;
    const float p = pred[px], g = gt[px], m = mask[px];
    acc[0] += fabsf(p - g) * m;
    acc[1] += m;
    if (c + 1 < W) {
      const float mdx = m * mask[px + 1];
      acc[2] += fabsf((pred[px + 1] - p) - (gt[px + 1] - g)) * mdx;
      acc[3] += mdx;
    }
    if (r + 1 < H) {
      const float mdy = m * mask[px + W];
      acc[4] += fabsf((pred[px + W] - p) - (gt[px + W] - g)) * mdy;
      acc[5] += mdy;
    }
    acc[6] += s;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    float v = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) v += red[w][tid];
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    partials[((size_t)b * tiles + tile) * 8 + tid] = v;
  }
}

// (B, tiles, 8) -> (B, 8): warp k adds column k over the tiles in a fixed
// order; column 7 is H*W.
__global__ void fold_partials(const float* __restrict__ partials, int tiles,
                              float hw, float* __restrict__ out) {
  const int b = blockIdx.x, lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  if (k < kSums) {
    const float* src = partials + (size_t)b * tiles * 8 + k;
    float v = 0.f;
    for (int t = lane; t < tiles; t += 32) v += src[(size_t)t * 8];
    v = warp_sum(v);
    if (lane == 0) out[b * 8 + k] = v;
  } else if (lane == 0) {
    out[b * 8 + kSums] = hw;
  }
}

// ----------------------------------------------------------------- backward

constexpr int kBH = 32, kBW = 64;            // output tile
constexpr int kSR = kBH + 4 * kHalo;         // staged rows: tile + 10
constexpr int kSC = kBW + 4 * kHalo;         // staged columns
constexpr int kSS = kSC + 1;                 // staged row stride (odd: a warp down a column
                                             // meets 32 banks)
constexpr int kMR = kBH + 2 * kHalo;         // moment and map rows: tile + 5
constexpr int kMC = kBW + 2 * kHalo;         // moment and map columns
constexpr int kAS = kMC + 1;                 // the maps' row stride (odd)
constexpr int kTS = kBW + 1;                 // the row pass's row stride (odd)
constexpr int kKR = kBH + 2, kKC = kBW + 2;  // staged mask: tile + 1
constexpr int kRB = 4;                       // outputs a thread takes along a line
constexpr int kBwdThreads = 256;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// Region A: the reflect indices and the mask, then the row-blurred moments
// (5, kSR, kMC), then the row pass of the transposed blur (3, kMR, kTS).
// Region B: the staged pred and gt (2, kSR, kSS), then the adjoint maps (3,
// kMR, kAS).  Each buffer is dead before the next one in its region is
// written.
constexpr int kRegionA = cmax(cmax(kSR + kSC + kKR * kKC, 5 * kSR * kMC), 3 * kMR * kTS);
constexpr int kRegionB = cmax(2 * kSR * kSS, 3 * kMR * kAS);
constexpr int kBwdSmem = 4 * (kRegionA + kRegionB);  // 114,760 bytes: two blocks an SM
static_assert(kBH * kBW == 2 * kRB * kBwdThreads, "the last pass: two items a thread");

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// The folded reflect-101 taps of the transposed 1-D blur at output j of a
// line of n pixels (the zero-padded stencil is added by the caller); x(i)
// reads the adjoint map at pixel i, always within HALF of j.
template <int HALF, typename F>
__device__ __forceinline__ float fold_taps(const float* wt, int j, int n, F x) {
  float v = 0.f;
  if (j >= 1 && j <= HALF)
    for (int i = 0; i <= HALF - j; ++i) v += wt[HALF - i - j] * x(i);
  if (j >= n - 1 - HALF && j <= n - 2)
    for (int i = max(2 * n - 2 - j - HALF, 0); i < n; ++i) v += wt[2 * n - 2 - j + HALF - i] * x(i);
  return v;
}

// kRB outputs of the transposed blur along a line: v[j] = sum_d w[HALF - d]
// line[j + kHalo + d], from the kRB + 2 HALF values at line[kHalo - HALF
// + t * stride], taps in the order of the old per-pixel loop.
template <int HALF>
__device__ __forceinline__ void stencil_t(const float* wt, const float* line, int stride,
                                          float (&v)[kRB]) {
  constexpr int NT = 2 * HALF + 1;
#pragma unroll
  for (int j = 0; j < kRB; ++j) v[j] = 0.f;
#pragma unroll
  for (int t = 0; t < kRB + 2 * HALF; ++t) {
    const float s = line[(kHalo - HALF + t) * stride];
#pragma unroll
    for (int j = 0; j < kRB; ++j)
      if (t - j >= 0 && t - j < NT) v[j] += wt[2 * HALF - (t - j)] * s;
  }
}

// Row pass of the transposed blur: ht (3, kMR, kTS) from the maps sa (3,
// kMR, kAS); a thread takes kRB columns of one row, a warp 32 rows.  FX:
// the tile lies within HALF of a left or right edge.
template <int HALF, bool FX>
__device__ __forceinline__ void transposed_rows(const float* wt, int c0, int W,
                                                const float* sa, float* ht) {
  for (int it = threadIdx.x; it < kMR * (kBW / kRB); it += kBwdThreads) {
    const int mr = it % kMR, tc0 = it / kMR * kRB;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* row = sa + (k * kMR + mr) * kAS;
      float v[kRB];
      stencil_t<HALF>(wt, row + tc0, 1, v);
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        if (FX)
          v[j] += fold_taps<HALF>(wt, c0 + tc0 + j, W,
                                  [&](int ii) { return row[ii - c0 + kHalo]; });
        ht[(k * kMR + mr) * kTS + tc0 + j] = v[j];
      }
    }
  }
}

// Column pass of the transposed blur and the sum: dpred for the tile; a
// thread takes kRB rows of one column (item it: column it % kBW, rows
// from it / kBW * kRB), a warp 32 columns.  lin, pn, gn: the thread's
// L1 and difference terms and pred/max, gt/max, kRB a item.  FY: the
// tile lies within HALF of the top or bottom edge.
template <int HALF, bool FY>
__device__ __forceinline__ void finish(const float* wt, int r0, int c0, int H, int W,
                                       const float* ht, const float (&lin)[2 * kRB],
                                       const float (&pn)[2 * kRB], const float (&gn)[2 * kRB],
                                       float ct_s, size_t img, float* __restrict__ dpred) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int it = threadIdx.x + q * kBwdThreads;
    const int tc = it % kBW, tr0 = it / kBW * kRB, c = c0 + tc;
    float tk[3][kRB];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* col = ht + k * kMR * kTS + tc;
      stencil_t<HALF>(wt, col + tr0 * kTS, kTS, tk[k]);
      if (FY) {
#pragma unroll
        for (int j = 0; j < kRB; ++j)
          tk[k][j] += fold_taps<HALF>(wt, r0 + tr0 + j, H,
                                      [&](int ii) { return col[(ii - r0 + kHalo) * kTS]; });
      }
    }
#pragma unroll
    for (int j = 0; j < kRB; ++j) {
      const int r = r0 + tr0 + j, e = q * kRB + j;
      if (r < H && c < W)
        dpred[img + (size_t)r * W + c] =
            lin[e] + ct_s * (tk[0][j] + 2.f * pn[e] * tk[1][j] + gn[e] * tk[2][j]);
    }
  }
}

template <int HALF>
__global__ void __launch_bounds__(kBwdThreads, 2)
loss_backward(const float* __restrict__ pred, const float* __restrict__ gt,
              const float* __restrict__ mask, const float* __restrict__ weights,
              const float* __restrict__ cts, int H, int W, float inv_max, float c1,
              float c2, float* __restrict__ dpred) {
  constexpr int NT = 2 * HALF + 1, T0 = kHalo - HALF;
  extern __shared__ __align__(16) float smem[];
  __shared__ float wt[NT];
  float* const ra = smem;
  float* const rb = smem + kRegionA;
  int* const rix = reinterpret_cast<int*>(ra);  // staged row -> image row * W
  int* const cix = rix + kSR;                   // staged column -> image column
  float* const sm = ra + kSR + kSC;             // mask (kKR, kKC)
  float* const hm = ra;                         // (5, kSR, kMC)
  float* const ht = ra;                         // (3, kMR, kTS)
  float* const sp = rb;                         // (kSR, kSS)
  float* const sg = rb + kSR * kSS;
  float* const sa = rb;                         // (3, kMR, kAS)
  const int b = blockIdx.z, c0 = blockIdx.x * kBW, r0 = blockIdx.y * kBH;
  const int tid = threadIdx.x;
  const size_t img = (size_t)b * H * W;
  if (tid < NT) wt[tid] = weights[tid];
  for (int i = tid; i < kSR; i += kBwdThreads) rix[i] = reflect(r0 - 2 * kHalo + i, H) * W;
  for (int i = tid; i < kSC; i += kBwdThreads) cix[i] = reflect(c0 - 2 * kHalo + i, W);
  __syncthreads();

  // Stage pred and gt (tile + 10) and the mask (tile + 1): 4-byte cp.async
  // copies, all of a thread's issued before it waits, so the whole tile is
  // in flight at once.
  for (int i = tid; i < kSR * kSC; i += kBwdThreads) {
    const int sr = i / kSC, sc = i - sr * kSC;
    const size_t off = img + rix[sr] + cix[sc];
    cp_async4(sp + sr * kSS + sc, pred + off);
    cp_async4(sg + sr * kSS + sc, gt + off);
  }
  for (int i = tid; i < kKR * kKC; i += kBwdThreads) {
    const int mr = i / kKC, mc = i - mr * kKC;
    cp_async4(sm + i, mask + img + rix[mr + 2 * kHalo - 1] + cix[mc + 2 * kHalo - 1]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The L1 sign field and the scatter of the forward-difference signs, and
  // pred/max, gt/max, at the thread's outputs of the last pass, from the raw
  // staged maps: +s at the right/bottom pixel of a pair, -s at the left/top.
  float lin[2 * kRB], pn[2 * kRB], gn[2 * kRB];
  {
    const float* ct = cts + b * 4;
    const float ct_l1 = ct[0], ct_gx = ct[1], ct_gy = ct[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int it = tid + q * kBwdThreads;
      const int tc = it % kBW, tr0 = it / kBW * kRB, c = c0 + tc;
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        const int tr = tr0 + j, r = r0 + tr, e = q * kRB + j;
        const float* P = sp + (tr + 2 * kHalo) * kSS + tc + 2 * kHalo;
        const float* G = sg + (tr + 2 * kHalo) * kSS + tc + 2 * kHalo;
        const float* M = sm + (tr + 1) * kKC + tc + 1;
        const float p = P[0], g = G[0], m = M[0];
        float v = ct_l1 * sgn(p - g) * m;
        float sx = 0.f, sy = 0.f;
        if (c >= 1) sx += sgn((p - P[-1]) - (g - G[-1])) * (M[-1] * m);
        if (c + 1 < W) sx -= sgn((P[1] - p) - (G[1] - g)) * (m * M[1]);
        if (r >= 1) sy += sgn((p - P[-kSS]) - (g - G[-kSS])) * (M[-kKC] * m);
        if (r + 1 < H) sy -= sgn((P[kSS] - p) - (G[kSS] - g)) * (m * M[kKC]);
        v += ct_gx * sx;
        v += ct_gy * sy;
        lin[e] = v;
        pn[e] = p * inv_max;
        gn[e] = g * inv_max;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kSR * kSS; i += kBwdThreads) {
    sp[i] *= inv_max;
    sg[i] *= inv_max;
  }
  __syncthreads();

  // Row pass of the moments: hm over the staged rows at the map columns; a
  // thread takes kRB columns of one row, a warp 32 rows.
  constexpr int kHP = kSR * kMC;  // one moment plane of hm
  for (int it = tid; it < kSR * ((kMC + kRB - 1) / kRB); it += kBwdThreads) {
    const int sr = it % kSR, mc0 = it / kSR * kRB;
    const float* a = sp + sr * kSS + mc0 + T0;
    const float* g = sg + sr * kSS + mc0 + T0;
    float x[kRB], y[kRB], xx[kRB], yy[kRB], xy[kRB];
#pragma unroll
    for (int j = 0; j < kRB; ++j) x[j] = y[j] = xx[j] = yy[j] = xy[j] = 0.f;
#pragma unroll
    for (int t = 0; t < kRB + 2 * HALF; ++t) {
      const float av = a[t], gv = g[t];
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        if (t - j >= 0 && t - j < NT) {
          const float w = wt[t - j];
          x[j] += w * av;
          y[j] += w * gv;
          xx[j] += w * (av * av);
          yy[j] += w * (gv * gv);
          xy[j] += w * (av * gv);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRB; ++j) {
      if (mc0 + j < kMC) {
        const int o = sr * kMC + mc0 + j;
        hm[o] = x[j];
        hm[kHP + o] = y[j];
        hm[2 * kHP + o] = xx[j];
        hm[3 * kHP + o] = yy[j];
        hm[4 * kHP + o] = xy[j];
      }
    }
  }
  __syncthreads();

  // Column pass of the moments and the three adjoint maps at the tile + 5,
  // zero outside the image; a thread takes kRB rows of one column.
  constexpr int kAP = kMR * kAS;  // one plane of the maps
  for (int it = tid; it < ((kMR + kRB - 1) / kRB) * kMC; it += kBwdThreads) {
    const int mc = it % kMC, mr0 = it / kMC * kRB;
    float mo[5][kRB];
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int j = 0; j < kRB; ++j) mo[k][j] = 0.f;
#pragma unroll
    for (int t = 0; t < kRB + 2 * HALF; ++t) {
      const int row = min(mr0 + T0 + t, kSR - 1);  // past it: rows no map keeps
      float h[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) h[k] = hm[k * kHP + row * kMC + mc];
#pragma unroll
      for (int j = 0; j < kRB; ++j)
        if (t - j >= 0 && t - j < NT) {
#pragma unroll
          for (int k = 0; k < 5; ++k) mo[k][j] += wt[t - j] * h[k];
        }
    }
    const int c = c0 - kHalo + mc;
#pragma unroll
    for (int j = 0; j < kRB; ++j) {
      const int mr = mr0 + j, r = r0 - kHalo + mr;
      if (mr >= kMR) continue;
      float m0 = 0.f, m1 = 0.f, m2 = 0.f;  // the maps are 0 outside the image
      if (r >= 0 && r < H && c >= 0 && c < W) {
        const float mx = mo[0][j], my = mo[1][j];
        // clamped: non-negative in exact math
        const float sxx = fmaxf(mo[2][j] - mx * mx, 0.f);
        const float syy = fmaxf(mo[3][j] - my * my, 0.f);
        const float sxy = mo[4][j] - mx * my;
        const float n1 = 2.f * mx * my + c1;
        const float n2 = 2.f * sxy + c2;
        const float d1 = mx * mx + my * my + c1;
        const float d2 = sxx + syy + c2;
        const float q = 1.f / (d1 * d2);  // one division: 1/d1 = d2 q, 1/d2 = d1 q
        const float s = (n1 * n2) * q;
        const float a1 = 2.f * my * n2 * q - s * 2.f * mx * (d2 * q);  // dS/dmu_x
        const float a3 = -s * (d1 * q);                                // dS/dsxx
        const float a5 = 2.f * n1 * q;                                 // dS/dsxy
        m0 = a1 - 2.f * mx * a3 - my * a5;
        m1 = a3;
        m2 = a5;
      }
      sa[mr * kAS + mc] = m0;
      sa[kAP + mr * kAS + mc] = m1;
      sa[2 * kAP + mr * kAS + mc] = m2;
    }
  }
  __syncthreads();
  if (c0 <= HALF || c0 + kBW + HALF + 1 > W)
    transposed_rows<HALF, true>(wt, c0, W, sa, ht);
  else
    transposed_rows<HALF, false>(wt, c0, W, sa, ht);
  __syncthreads();
  const float ct_s = cts[b * 4 + 3] * inv_max;
  if (r0 <= HALF || r0 + kBH + HALF + 1 > H)
    finish<HALF, true>(wt, r0, c0, H, W, ht, lin, pn, gn, ct_s, img, dpred);
  else
    finish<HALF, false>(wt, r0, c0, H, W, ht, lin, pn, gn, ct_s, img, dpred);
}

bool shape_ok(int B, int H, int W, int half) {
  return B >= 1 && H >= 6 && W >= 6 && half >= 0 && half <= kHalo;
}

// The backward's dynamic shared memory is above 48 KB: set the attribute
// once a device for each instantiation.
template <int HALF>
cudaError_t launch_backward(const float* pred, const float* gt, const float* mask,
                            const float* weights, const float* cts, float* dpred, int B, int H,
                            int W, float inv_max, float c1, float c2, cudaStream_t stream) {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(loss_backward<HALF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBwdSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) done[dev] = true;
  }
  dim3 grid((W + kBW - 1) / kBW, (H + kBH - 1) / kBH, B);
  loss_backward<HALF><<<grid, kBwdThreads, kBwdSmem, stream>>>(pred, gt, mask, weights, cts, H,
                                                                W, inv_max, c1, c2, dpred);
  return cudaGetLastError();
}

}  // namespace

// Forward: partials (B, tiles, 8) scratch, out (B, 8).  Returns a cudaError_t.
extern "C" int fused_loss_forward(const void* pred, const void* gt, const void* mask,
                                  const void* weights, void* partials, void* out,
                                  int B, int H, int W, int half, float inv_max,
                                  float c1, float c2, void* stream) {
  if (!shape_ok(B, H, W, half)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  dim3 block(kTW, kThreads / kTW);
  loss_tile<<<grid, block, 0, st>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<const float*>(mask), static_cast<const float*>(weights), H, W, half,
      inv_max, c1, c2, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_partials<<<B, 256, 0, st>>>(static_cast<const float*>(partials),
                                   (int)(grid.x * grid.y), (float)H * (float)W,
                                   static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Backward: dpred (B, H, W), one launch.  Returns a cudaError_t.
extern "C" int fused_loss_backward(const void* pred, const void* gt, const void* mask,
                                   const void* weights, const void* cts, void* dpred,
                                   int B, int H, int W, int half, float inv_max, float c1,
                                   float c2, void* stream) {
  if (!shape_ok(B, H, W, half)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pred);
  const float* g = static_cast<const float*>(gt);
  const float* m = static_cast<const float*>(mask);
  const float* w = static_cast<const float*>(weights);
  const float* ct = static_cast<const float*>(cts);
  float* d = static_cast<float*>(dpred);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (half) {
    case 0: return (int)launch_backward<0>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
    case 1: return (int)launch_backward<1>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
    case 2: return (int)launch_backward<2>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
    case 3: return (int)launch_backward<3>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
    case 4: return (int)launch_backward<4>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
    default: return (int)launch_backward<5>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
  }
}

// The backward kernel's resources as built (the 11-tap instantiation):
// attrs = [registers a thread, local (spill) bytes a thread, static shared
// bytes, dynamic shared bytes, threads a block].  Returns a cudaError_t.
extern "C" int fused_loss_backward_attrs(int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, loss_backward<kHalo>);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.localSizeBytes;
  attrs[2] = (int)fa.sharedSizeBytes;
  attrs[3] = kBwdSmem;
  attrs[4] = kBwdThreads;
  return 0;
}

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
//   forward  (one cooperative launch, loss_forward): a grid of the blocks
//            the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
//            x SMs; cudaLaunchCooperativeKernel refuses more) walks the
//            (image, 32 x 64 tile) jobs, block k taking jobs k, k + grid,
//            ...  A job's raw pred and gt are staged for the tile plus a
//            halo of max(half, 1) and its mask for the tile plus 1 (4-byte
//            cp.async copies, all in flight at once, the reflect index
//            computed once a row and once a column).  Then, in one phase,
//            the L1 and forward-difference sums from the staged raw values
//            (each difference owned by its left/top pixel) and the row
//            pass (5 moments of pred/max and gt/max over the staged rows,
//            the products rounded as the JAX package's p * inv_max); after
//            a barrier the column pass, whose SSIM map goes straight into
//            the sums.  4 outputs a thread along a line, the taps
//            unrolled (the half-window is a template parameter) and held
//            in registers, odd row strides where a warp walks down
//            columns.  The block reduces its 7 sums in a fixed order into
//            a (B, tiles, 8) scratch; after grid.sync() block k folds
//            images k, k + grid, ... over their tiles in tile order ->
//            (B, 8), column 7 = H*W.  No atomics: two calls on the same
//            inputs give the same bits.  The staging costs (32 + 10)(64 +
//            10) / (32 x 64) = 1.52x the tile, the row pass 42 / 32 =
//            1.31x the least work; 88,848 bytes of dynamic shared memory,
//            two blocks an SM.
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
//            32 x 64 so that the 10-pixel halo costs 1.9x the tile's
//            staging (3.5x at 16 x 32), at two blocks an
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
// fp32 taps; cts (B, 4) fp32; the forward's scratch (B, tiles, 8) fp32
// and out (B, 8) fp32.  H, W >= 6 and half <= 5 (checked).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kHalo = 5;  // largest half-window
constexpr int kSums = 7;
constexpr int kRB = 4;    // outputs a thread takes along a line
constexpr int kMaxDevices = 64;
constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// ------------------------------------------------------------------ forward

constexpr int kFH = 32, kFW = 64;              // a tile's rows and columns
constexpr int kFwdBlocks = 2;                  // blocks an SM (__launch_bounds__)
constexpr int kFR = kFH + 2 * kHalo;           // staged rows at most
constexpr int kFS = (kFW + 2 * kHalo) | 1;     // staged row stride (odd)
constexpr int kFKR = kFH + 1, kFKC = kFW + 1;  // staged mask: tile + 1
constexpr int kFMS = kFW + 1;  // the row-blurred moments' row stride (odd)
constexpr int kFwdThreads = 256;
constexpr int kFwdItems = kFH * kFW / (kRB * kFwdThreads);  // column-pass items a thread
// The row-blurred moments (5, staged rows, kFMS), the staged pred and gt (2,
// kFR, kFS), the mask (kFKR, kFKC), the reflect indices (kFR + kFS).
constexpr int kFMom = 5 * kFR * kFMS;
constexpr int kFwdSmem = 4 * (kFMom + 2 * kFR * kFS + kFKR * kFKC + kFR + kFS);  // 88,848 bytes
static_assert(kFH % kRB == 0 && kFW % kRB == 0, "whole items along a line");
static_assert(kFwdItems * kRB * kFwdThreads == kFH * kFW, "whole column-pass items a thread");
static_assert(kFwdThreads / 32 == kSums + 1, "the fold: a warp a sum, one for H*W");

// Jobs job = blockIdx.x + k * gridDim.x < B * tiles, job = b * tiles + tile
// (tile = row * tiles_x + column): the tile's 7 sums into partials[job];
// then, after the grid-wide barrier, images blockIdx.x + k * gridDim.x
// folded over their tiles in tile order into out.  The grid must be
// resident at once (a cooperative launch).
template <int HALF>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
loss_forward(const float* __restrict__ pred, const float* __restrict__ gt,
             const float* __restrict__ mask, const float* __restrict__ weights, int B, int H,
             int W, int tiles_x, int tiles, float inv_max, float c1, float c2,
             float* __restrict__ partials, float* __restrict__ out) {
  constexpr int NT = 2 * HALF + 1;
  constexpr int SH = HALF > 1 ? HALF : 1;  // staged halo: the differences need 1
  constexpr int T0 = SH - HALF;
  constexpr int SR = kFH + 2 * SH, SC = kFW + 2 * SH;
  constexpr int MP = SR * kFMS;  // one moment plane
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kFwdThreads / 32][kSums];
  float* const hm = smem;             // (5, SR, kFMS)
  float* const sp = smem + kFMom;     // (SR, kFS)
  float* const sg = sp + kFR * kFS;
  float* const sm = sg + kFR * kFS;   // mask (kFKR, kFKC)
  int* const rix = reinterpret_cast<int*>(sm + kFKR * kFKC);  // staged row -> image row * W
  int* const cix = rix + kFR;                                  // staged column -> image column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, total = B * tiles;
  float wt[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wt[t] = weights[t];

  for (int job = blockIdx.x; job < total; job += gridDim.x) {
    const int b = job / tiles, tile = job - b * tiles, ty = tile / tiles_x;
    const int r0 = ty * kFH, c0 = (tile - ty * tiles_x) * kFW;
    const size_t img = (size_t)b * H * W;
    // The reflect indices of the staged rows and columns, computed once a
    // row and once a column.
    if (tid < SR) rix[tid] = reflect(r0 - SH + tid, H) * W;
    if (tid < SC) cix[tid] = reflect(c0 - SH + tid, W);
    __syncthreads();  // the indices are in; the last job's maps and sums are read
    // Stage raw pred and gt (tile + SH) and the mask (tile + 1 right and
    // below): 4-byte cp.async copies, all of a thread's issued at once.
    for (int i = tid; i < SR * SC; i += kFwdThreads) {
      const int sr = i / SC, sc = i - sr * SC;
      const size_t off = img + rix[sr] + cix[sc];
      cp_async4(sp + sr * kFS + sc, pred + off);
      cp_async4(sg + sr * kFS + sc, gt + off);
    }
    for (int i = tid; i < kFKR * kFKC; i += kFwdThreads) {
      const int mr = i / kFKC, mc = i - mr * kFKC;
      cp_async4(sm + i, mask + img + rix[mr + SH] + cix[mc + SH]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // L1 and the forward differences from the staged raw values, at the
    // pixels of the column pass (item it: column it % kFW, kRB rows from
    // it / kFW * kRB); a difference is owned by its left/top pixel.
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
#pragma unroll
    for (int q = 0; q < kFwdItems; ++q) {
      const int it = tid + q * kFwdThreads;
      const int tc = it % kFW, tr0 = it / kFW * kRB, c = c0 + tc;
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        const int tr = tr0 + j, r = r0 + tr;
        if (r >= H || c >= W) continue;
        const float* P = sp + (tr + SH) * kFS + tc + SH;
        const float* G = sg + (tr + SH) * kFS + tc + SH;
        const float* M = sm + tr * kFKC + tc;
        const float p = P[0], g = G[0], m = M[0];
        acc[0] += fabsf(p - g) * m;
        acc[1] += m;
        if (c + 1 < W) {
          const float mdx = M[1] * m;
          acc[2] += fabsf((P[1] - p) - (G[1] - g)) * mdx;
          acc[3] += mdx;
        }
        if (r + 1 < H) {
          const float mdy = M[kFKC] * m;
          acc[4] += fabsf((P[kFS] - p) - (G[kFS] - g)) * mdy;
          acc[5] += mdy;
        }
      }
    }

    // Row pass: the 5 moments of pred/max and gt/max over the staged rows
    // at the tile's columns; a thread takes kRB columns of one row, a warp
    // 32 rows.
    for (int it = tid; it < SR * (kFW / kRB); it += kFwdThreads) {
      const int sr = it % SR, fc0 = it / SR * kRB;
      const float* a = sp + sr * kFS + fc0 + T0;
      const float* g = sg + sr * kFS + fc0 + T0;
      float x[kRB], y[kRB], xx[kRB], yy[kRB], xy[kRB];
#pragma unroll
      for (int j = 0; j < kRB; ++j) x[j] = y[j] = xx[j] = yy[j] = xy[j] = 0.f;
#pragma unroll
      for (int t = 0; t < kRB + 2 * HALF; ++t) {
        const float av = a[t] * inv_max, gv = g[t] * inv_max;
        const float aa = av * av, gg = gv * gv, ag = av * gv;
#pragma unroll
        for (int j = 0; j < kRB; ++j) {
          if (t - j >= 0 && t - j < NT) {
            const float w = wt[t - j];
            x[j] += w * av;
            y[j] += w * gv;
            xx[j] += w * aa;
            yy[j] += w * gg;
            xy[j] += w * ag;
          }
        }
      }
      const int o = sr * kFMS + fc0;
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        hm[o + j] = x[j];
        hm[MP + o + j] = y[j];
        hm[2 * MP + o + j] = xx[j];
        hm[3 * MP + o + j] = yy[j];
        hm[4 * MP + o + j] = xy[j];
      }
    }
    __syncthreads();

    // Column pass and the SSIM map at the tile's pixels, summed at once; a
    // thread takes kRB rows of one column, a warp 32 columns.
#pragma unroll
    for (int q = 0; q < kFwdItems; ++q) {
      const int it = tid + q * kFwdThreads;
      const int tc = it % kFW, tr0 = it / kFW * kRB, c = c0 + tc;
      float mo[5][kRB];
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int j = 0; j < kRB; ++j) mo[k][j] = 0.f;
#pragma unroll
      for (int t = 0; t < kRB + 2 * HALF; ++t) {
        const float* h = hm + (tr0 + T0 + t) * kFMS + tc;
        float v[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) v[k] = h[k * MP];
#pragma unroll
        for (int j = 0; j < kRB; ++j)
          if (t - j >= 0 && t - j < NT) {
#pragma unroll
            for (int k = 0; k < 5; ++k) mo[k][j] += wt[t - j] * v[k];
          }
      }
#pragma unroll
      for (int j = 0; j < kRB; ++j) {
        if (r0 + tr0 + j >= H || c >= W) continue;
        const float mx = mo[0][j], my = mo[1][j];
        // clamped: non-negative in exact math
        const float sxx = fmaxf(mo[2][j] - mx * mx, 0.f);
        const float syy = fmaxf(mo[3][j] - my * my, 0.f);
        const float sxy = mo[4][j] - mx * my;
        const float n1 = 2.f * mx * my + c1;
        const float n2 = 2.f * sxy + c2;
        const float d1 = mx * mx + my * my + c1;
        const float d2 = sxx + syy + c2;
        acc[6] += (n1 * n2) / (d1 * d2);
      }
    }

    // The tile's 7 sums, in a fixed order: warp trees, then the warps in
    // turn.
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (tid < kSums) {
      float v = 0.f;
      for (int w = 0; w < kFwdThreads / 32; ++w) v += red[w][tid];
      partials[(size_t)job * 8 + tid] = v;
    }
  }

  cg::this_grid().sync();

  // Warp k adds column k of an image over its tiles (lanes strided, then a
  // warp tree); the last warp writes H*W.
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (warp < kSums) {
      const float* src = partials + (size_t)b * tiles * 8 + warp;
      float v = 0.f;
      for (int t = lane; t < tiles; t += 32) v += __ldcg(src + (size_t)t * 8);
      v = warp_sum(v);
      if (lane == 0) out[b * 8 + warp] = v;
    } else if (lane == 0) {
      out[b * 8 + kSums] = (float)H * (float)W;
    }
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
constexpr int kBwdThreads = 256;
// Region A: the reflect indices and the mask, then the row-blurred moments
// (5, kSR, kMC), then the row pass of the transposed blur (3, kMR, kTS).
// Region B: the staged pred and gt (2, kSR, kSS), then the adjoint maps (3,
// kMR, kAS).  Each buffer is dead before the next one in its region is
// written.
constexpr int kRegionA = cmax(cmax(kSR + kSC + kKR * kKC, 5 * kSR * kMC), 3 * kMR * kTS);
constexpr int kRegionB = cmax(2 * kSR * kSS, 3 * kMR * kAS);
constexpr int kBwdSmem = 4 * (kRegionA + kRegionB);  // 114,760 bytes: two blocks an SM
static_assert(kBH * kBW == 2 * kRB * kBwdThreads, "the last pass: two items a thread");

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

// Dynamic shared memory above 48 KB needs the attribute: set once a device
// for each kernel (``done``: that kernel's flags).
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int HALF>
cudaError_t prepare_forward() {
  static bool done[kMaxDevices];
  return allow_smem(loss_forward<HALF>, kFwdSmem, done);
}

template <int HALF>
cudaError_t launch_forward(const float* pred, const float* gt, const float* mask,
                           const float* weights, int B, int H, int W, int tiles_x, int tiles,
                           int grid, float inv_max, float c1, float c2, float* partials,
                           float* out, cudaStream_t stream) {
  cudaError_t err = prepare_forward<HALF>();
  if (err != cudaSuccess) return err;
  void* args[] = {&pred, &gt,    &mask,    &weights, &B,  &H,        &W,
                  &tiles_x, &tiles, &inv_max, &c1,   &c2, &partials, &out};
  return cudaLaunchCooperativeKernel((const void*)loss_forward<HALF>, dim3(grid),
                                     dim3(kFwdThreads), args, (size_t)kFwdSmem, stream);
}

template <int HALF>
cudaError_t launch_backward(const float* pred, const float* gt, const float* mask,
                            const float* weights, const float* cts, float* dpred, int B, int H,
                            int W, float inv_max, float c1, float c2, cudaStream_t stream) {
  static bool done[kMaxDevices];
  cudaError_t err = allow_smem(loss_backward<HALF>, kBwdSmem, done);
  if (err != cudaSuccess) return err;
  dim3 grid((W + kBW - 1) / kBW, (H + kBH - 1) / kBH, B);
  loss_backward<HALF><<<grid, kBwdThreads, kBwdSmem, stream>>>(pred, gt, mask, weights, cts, H,
                                                                W, inv_max, c1, c2, dpred);
  return cudaGetLastError();
}

// f(std::integral_constant<int, half>()) for half in 0..5.
template <typename F>
cudaError_t by_half(int half, F f) {
  switch (half) {
    case 0: return f(std::integral_constant<int, 0>());
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 5>());
  }
}

// attrs = [registers a thread, local (spill) bytes a thread, static shared
// bytes, dynamic shared bytes, threads a block] of a kernel.
cudaError_t kernel_attrs(const void* kernel, int dyn, int threads, int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.localSizeBytes;
  attrs[2] = (int)fa.sharedSizeBytes;
  attrs[3] = dyn;
  attrs[4] = threads;
  return cudaSuccess;
}

}  // namespace

// Forward: partials (B, tiles_y * tiles_x, 8) scratch, out (B, 8); one
// cooperative launch of ``grid`` blocks, which must be resident at once
// (fused_loss_forward_occupancy; a grid the card refuses returns its
// error).  Returns a cudaError_t.
extern "C" int fused_loss_forward(const void* pred, const void* gt, const void* mask,
                                  const void* weights, void* partials, void* out, int B, int H,
                                  int W, int half, int tiles_y, int tiles_x, int grid,
                                  float inv_max, float c1, float c2, void* stream) {
  if (!shape_ok(B, H, W, half) || tiles_y != (H + kFH - 1) / kFH ||
      tiles_x != (W + kFW - 1) / kFW || grid < 1 || (long long)grid > (long long)B * tiles_y * tiles_x)
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pred);
  const float* g = static_cast<const float*>(gt);
  const float* m = static_cast<const float*>(mask);
  const float* w = static_cast<const float*>(weights);
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_half(half, [&](auto h) {
    return launch_forward<decltype(h)::value>(p, g, m, w, B, H, W, tiles_x, tiles_y * tiles_x,
                                              grid, inv_max, c1, c2, part, o, st);
  });
}

// info = [SMs, blocks of the forward for ``half`` that one SM holds at once,
// cooperative launch supported] on the current device.  Returns a
// cudaError_t.
extern "C" int fused_loss_forward_occupancy(int half, int* info) {
  if (half < 0 || half > kHalo) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&info[2], cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)by_half(half, [&](auto h) {
    constexpr int HALF = decltype(h)::value;
    cudaError_t e = prepare_forward<HALF>();
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], loss_forward<HALF>,
                                                         kFwdThreads, kFwdSmem);
  });
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
  return (int)by_half(half, [&](auto h) {
    return launch_backward<decltype(h)::value>(p, g, m, w, ct, d, B, H, W, inv_max, c1, c2, st);
  });
}

// The forward kernel's resources as built (the 11-tap instantiation):
// attrs = [registers a thread, local (spill) bytes a thread, static shared
// bytes, dynamic shared bytes, threads a block].  Returns a cudaError_t.
extern "C" int fused_loss_forward_attrs(int* attrs) {
  return (int)kernel_attrs((const void*)loss_forward<kHalo>, kFwdSmem, kFwdThreads, attrs);
}

// The backward kernel's resources as built (the 11-tap instantiation):
// attrs = [registers a thread, local (spill) bytes a thread, static shared
// bytes, dynamic shared bytes, threads a block].  Returns a cudaError_t.
extern "C" int fused_loss_backward_attrs(int* attrs) {
  return (int)kernel_attrs((const void*)loss_backward<kHalo>, kBwdSmem, kBwdThreads, attrs);
}

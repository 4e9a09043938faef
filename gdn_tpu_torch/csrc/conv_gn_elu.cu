// Fused conv3x3 + GroupNorm + ELU forward for Hopper (sm_90a), plain C
// interface for ctypes.  One source behind six entry points.
//
// Replaces the TPU kernels (each the pl.pallas_call at the line given)
//   gdn_tpu/kernels/conv_gn_elu.py:109  fused_conv_gn_elu     (stride 1, fp32 out)
//   gdn_tpu/kernels/conv_gn_elu.py:356  fused_conv_gn_elu_bt  (stride 1, a/yn/inv)
//   gdn_tpu/kernels/conv_gn_elu.py:679  fused_conv_gn_elu_s2  (stride 2, a/yn/inv)
//   gdn_tpu/kernels/fusion_bt.py:226    fused_fusion_bt       (two inputs, concat
//                                                              never built)
//   gdn_tpu/kernels/fusion_block.py:235 fused_fusion_block    (two inputs, fp32 out)
//   gdn_tpu/kernels/upsample.py:148     fused_upsample_conv   (bilinear 2x of x in
//                                                              front, fp32 out)
// which all compute: 3x3 SAME convolution with fp32 accumulation of
// inputs and weights rounded to the tap dtype -> per-(image, group) mean
// and variance of the fp32 accumulator (single pass, clamped at 0) ->
// yn = (acc - mean) * inv -> a = ELU(yn * scale + bias), stored once.
//
// The upsample entry point convolves U = the exact-2x bilinear upsample
// of x (half-pixel centers, edge clamp), four times the size of x, and
// U is never stored in device memory: each element is a 4-point blend of
// x in fp32 (rows first, then columns, as the TPU kernel: 0.25 of the far
// neighbour, 0.75 of the near one), rounded to the tap dtype, made in
// shared memory once a channel chunk by the tensor-core kernel
// (conv3x3_stats_tc_up) and once a gathered im2col element by the FMA
// kernel (conv3x3_stats<..., UP = true>).  Where the clamp and the zero
// border meet: a tap position outside [0, 2H) x [0, 2W) is the
// convolution's zero padding and reads nothing; inside, the far
// neighbour's index is clamped into the image, so U's outermost rows and
// columns blend a pixel with itself.  Device memory sees x once and the
// fp32 output once.
//
// What bounds it: a site does 18 * Cin * Cout flops per output pixel
// against (Cin * s^2 + Cout [+ Cout for yn]) * itemsize bytes.  In bf16
// that is ~100 flops a byte at the 32-channel sites, ~190 at 64 channels
// and 380-1500 from 128 channels up; the card's line is ~295 (989 TFLOP/s
// dense bf16 over 3.35 TB/s), so the shallow, large sites are bound by
// memory and the deep ones by the tensor cores.
//
// Launch 1 runs one of three K loops:
//   conv3x3_stats<T, BM, BN, UP>: a register-tiled implicit GEMM on the
//     fp32 FMA units (67 TFLOP/s peak), exact for both tap dtypes (a
//     bf16 x bf16 product is exact in fp32).  It serves fp32 taps, which
//     are exact fp32 in the JAX reference, at every entry point.
//   The tensor-core kernels, for bf16 taps at all six entry points, as
//   the TPU kernels convolve on the MXU: bf16 x bf16 products, fp32 sums
//   (mma.sync m16n8k16, operands from shared memory by ldmatrix).
//   conv3x3_stats_tc<T, BM, BN, BK, ASYNC, S> serves stride S = 1 (one
//     input or two) and S = 2 (XLA's SAME pads: (0, 1) for an even
//     length, (1, 1) for an odd one).  Operands stay bf16 in shared
//     memory: the A tile is BM output pixels of one image x BK columns
//     of the flattened K axis (tap, then x's channels and the lateral's,
//     each rounded up to 8: the concatenated activation is never built,
//     its columns are gathered from the two sources), the B tile BN
//     output channels x the same columns of the bf16 K-major weights
//     (Cout, 9 * (Cx_p + Cl_p)), packed from the two weight halves.  A
//     ring of three or four stages is filled by 16-byte cp.async copies
//     (8 channels of one pixel each; a tap in the SAME padding copies
//     zero bytes, which zero-fills the slot); fp32 inputs (rounded to
//     bf16 as gathered) and a channel count % 8 != 0 (no 16-byte
//     alignment) load through registers into the same layout (ASYNC =
//     false).  Tile rows are XOR-swizzled so that neither ldmatrix nor
//     the copies meet bank conflicts.  S is a template parameter: only
//     the prologue, which turns a tile row into its input origin, differs.
//   conv3x3_stats_tc_up<T, BM, BN>: the upsample entry point.  A cp.async
//     copy cannot blend, so U is built in shared memory: a block owns a
//     2-D tile of U (BM / 16 rows x 16 columns) and walks K channel chunk
//     outer (32 channels), tap inner, against weights packed to match
//     ((Cout, Cin_p / 32, 9, 32)).  Per chunk it stages the x patch the
//     tile and its 1-pixel halo need (cp.async, or through registers for
//     a channel count the copies cannot align), blends the halo tile of U
//     from it once (bf16, rows padded by 16 bytes so that 8 consecutive
//     rows meet 8 bank groups), and the nine taps read their A fragments
//     from it by ldmatrix with the row addresses shifted by (ky, kx).  Each
//     U element is blended once a chunk, not once a tap.
//   Per site the bound is the bytes at the 32- and 64-channel sites (~100
//   and ~190 flops a byte against the card's ~295) and the tensor cores
//   from 128 channels up.
//
// Design: two launches, as group_norm_elu.cu.  The TPU kernels hold T
// whole images in VMEM for the conv, the statistics and the epilogue;
// here an image's output is spread over many blocks that run in no
// order, so the statistics cross blocks:
//   1. conv3x3_stats<T, BM, BN>: grid (m tiles, Cout tiles, B).  A block
//      owns BM consecutive output pixels of ONE image and BN output
//      channels.  K runs over (source, tap, 16 input channels): the
//      im2col rows are gathered straight from NHWC x (and, for the
//      fusion, from the lateral through its own weight half - no
//      concatenated tensor exists), padding and ragged edges masked to
//      zero, staged transposed in shared memory beside the weight slab;
//      each thread accumulates a 4x4 register tile.  The next K step's
//      global loads are issued before the current step's FMAs.  The block
//      writes its fp32 tile to the scratch y and, reduced in a fixed
//      order through shared memory, per-channel (sum, sum of squares)
//      partials (B, m tiles, Cout, 2).  No atomics: deterministic.
//   2. gn_elu_apply<TO, V>: grid (row chunks, B).  Each block folds its
//      image's partials into per-group mean and inverse std (one warp per
//      group, fixed order), then normalizes its rows of y in fp32 and
//      stores a (and yn, when asked) in the output dtype; chunk 0 also
//      stores inv (B, Cout).
// y stays fp32 between the launches, so the result is "fp32 until the one
// store" as on the TPU; the price is one fp32 round trip of the output
// map (mostly through the 50 MB L2 at the deep sites): 8 bytes an output
// element on top of the 2-6 the bound counts (bf16 a; + yn; fp32 a).  At
// the five stride-1 sites of a net at B=32 that is ~210 MB of the ~370 the
// tensor-core kernel moves, against ~160 MB in the bound, and once the K
// loop is on the tensor cores it sets the pace at the shallow sites.
// The tensor-core kernels keep the contract of conv3x3_stats (the scratch
// y, the partials, one gn_elu_apply after it), so every K loop shares
// launch 2; the upsample kernel's m tiles are 2-D tiles of U, which the
// fold does not see (each pixel lies in one tile, y is stored at the
// pixel's own index).
//
// Layout: x (B, H, W, Cx) and lat (B, H, W, Cl) dense NHWC, fp32 or bf16;
// weights of the FMA kernel fp32 (9, Cs, Cout) per source, tap-major,
// values already rounded to the tap dtype by the wrapper; of the
// tensor-core kernel bf16 (Cout, 9 * (Cx_p + Cl_p)), k = (3 ky + kx)
// (Cx_p + Cl_p) + c, x's channels then the lateral's, zero in each one's
// padding; of the upsample's tensor-core kernel bf16 (Cout, 9 * Cin_p),
// Cin_p = Cin rounded up to 32, k = (chunk * 9 + 3 ky + kx) * 32 + c for
// input channel chunk * 32 + c; scale, bias fp32 (Cout,).
// No width is assumed to be a power of two or a multiple of anything:
// 4-wide vector loads are used where a channel count is a multiple of 4
// and scalar masked loads otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;  // input channels per K step
constexpr int TM = 4;   // output pixels per thread
constexpr int TN = 4;   // output channels per thread
constexpr int kMaxC = 1024;

struct ConvArgs {
  const void* x;
  const void* lat;  // null for one input
  const float* wx;  // (9, cx, cout)
  const float* wl;  // (9, cl, cout) or null
  float* y;         // (B, ho*wo, cout)
  float* partials;  // (B, mtiles, cout, 2)
  int h, w, cx, cl, cout, ho, wo, stride, pad_top, pad_left, round_bf16;
};
// h, w are x's; with the upsample in front the convolution runs over the
// (2h, 2w) map U and ho = 2h, wo = 2w, stride 1, pads 1.

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 0.25 far + 0.75 near, each product and the sum rounded on its own (no
// contraction into an fma), so U is bit for bit the plain version's.
__device__ __forceinline__ float blend(float far, float near) {
  return __fadd_rn(__fmul_rn(0.25f, far), __fmul_rn(0.75f, near));
}

// Channels c..c+3 of the pixel at px (cs channels), zero beyond cs.
__device__ __forceinline__ void load4(const float* px, int c, int cs, bool vec,
                                      float (&out)[4]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(px + c);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (c + j < cs) ? px[c + j] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* px, int c, int cs, bool vec,
                                      float (&out)[4]) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(px + c);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (c + j < cs) ? __bfloat162float(px[c + j]) : 0.f;
  }
}

template <typename T, int BM, int BN, bool UP>
__global__ void __launch_bounds__(kThreads) conv3x3_stats(ConvArgs p) {
  constexpr int TX = BN / TN;       // threads along the channels
  constexpr int TY = BM / TM;       // threads along the pixels
  constexpr int A_ITEMS = BM / 64;  // (pixel, 4 channels) loads per thread and K step
  constexpr int B_ITEMS = BK * BN / 4;  // float4 loads of the weight slab (<= kThreads)
  static_assert(TX * TY == kThreads, "tile does not match the block");
  static_assert(BM % 64 == 0 && B_ITEMS <= kThreads, "loader does not cover the tile");
  __shared__ __align__(16) float As[BK][BM];  // im2col slab, transposed
  __shared__ __align__(16) float Bs[BK][BN];  // weight slab
  __shared__ float red1[TY * BN];
  __shared__ float red2[TY * BN];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int m_total = p.ho * p.wo;
  const bool vecw = (p.cout & 3) == 0;

  // This thread's im2col rows: pixel (tid / 4 + 64 i), channels 4 (tid % 4)...
  const int kq = tid & 3;
  int hi0[A_ITEMS], wi0[A_ITEMS];
#pragma unroll
  for (int i = 0; i < A_ITEMS; ++i) {
    const int m = m0 + (tid >> 2) + i * 64;
    if (m < m_total) {
      const int oy = m / p.wo;
      hi0[i] = oy * p.stride - p.pad_top;
      wi0[i] = (m - oy * p.wo) * p.stride - p.pad_left;
    } else {
      hi0[i] = -(1 << 20);  // never inside the image: the row stays zero
      wi0[i] = 0;
    }
  }
  // ... and its float4 of the weight slab.
  const int kb = tid / (BN / 4);
  const int nq = tid - kb * (BN / 4);

  const int nx = (p.cx + BK - 1) / BK;
  const int nl = (p.cl + BK - 1) / BK;
  const int chunks = 9 * (nx + nl);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float areg[A_ITEMS][4];
  float breg[4] = {0.f, 0.f, 0.f, 0.f};

  const int tx = tid % TX, ty = tid / TX;

  for (int chunk = 0; chunk <= chunks; ++chunk) {
    if (chunk > 0) {  // stage the slabs fetched in the last iteration
#pragma unroll
      for (int i = 0; i < A_ITEMS; ++i) {
        const int ml = (tid >> 2) + i * 64;
#pragma unroll
        for (int j = 0; j < 4; ++j) As[kq * 4 + j][ml] = areg[i][j];
      }
      if (tid < B_ITEMS)
        *reinterpret_cast<float4*>(&Bs[kb][nq * 4]) =
            make_float4(breg[0], breg[1], breg[2], breg[3]);
      __syncthreads();
    }
    if (chunk < chunks) {  // fetch this K step: (source, tap, 16 channels)
      const T* src;
      const float* wsrc;
      int cs, rest = chunk, per;
      if (chunk < 9 * nx) {
        src = static_cast<const T*>(p.x); wsrc = p.wx; cs = p.cx; per = nx;
      } else {
        src = static_cast<const T*>(p.lat); wsrc = p.wl; cs = p.cl; per = nl;
        rest -= 9 * nx;
      }
      const int tap = rest / per;
      const int c0 = (rest - tap * per) * BK;
      const int ky = tap / 3, kx = tap - ky * 3;
      const int c = c0 + kq * 4;
      const bool vec = (cs & 3) == 0;
#pragma unroll
      for (int i = 0; i < A_ITEMS; ++i) {
        const int hi = hi0[i] + ky, wi = wi0[i] + kx;
        if (UP) {
          // (hi, wi) is a position in U.  Near source pixel (hi/2, wi/2);
          // the far one lies before it at an even position, after it at
          // an odd one, clamped into the image.
          if (hi >= 0 && hi < 2 * p.h && wi >= 0 && wi < 2 * p.w && c < cs) {
            const int rn = hi >> 1, cn = wi >> 1;
            const int rf = (hi & 1) ? min(rn + 1, p.h - 1) : max(rn - 1, 0);
            const int cf = (wi & 1) ? min(cn + 1, p.w - 1) : max(cn - 1, 0);
            const T* img = src + (size_t)b * p.h * p.w * cs;
            float nn[4], fn[4], nf[4], ff[4];  // (row, column): near / far
            load4(img + ((size_t)rn * p.w + cn) * cs, c, cs, vec, nn);
            load4(img + ((size_t)rf * p.w + cn) * cs, c, cs, vec, fn);
            load4(img + ((size_t)rn * p.w + cf) * cs, c, cs, vec, nf);
            load4(img + ((size_t)rf * p.w + cf) * cs, c, cs, vec, ff);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float vn = blend(fn[j], nn[j]);  // rows, near column
              const float vf = blend(ff[j], nf[j]);  // rows, far column
              const float u = blend(vf, vn);         // columns
              areg[i][j] = p.round_bf16 ? round_to_bf16(u) : u;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) areg[i][j] = 0.f;
          }
        } else if (hi >= 0 && hi < p.h && wi >= 0 && wi < p.w && c < cs) {
          const T* px = src + (((size_t)b * p.h + hi) * p.w + wi) * cs;
          load4(px, c, cs, vec, areg[i]);
          if (p.round_bf16) {
#pragma unroll
            for (int j = 0; j < 4; ++j) areg[i][j] = round_to_bf16(areg[i][j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) areg[i][j] = 0.f;
        }
      }
      if (tid < B_ITEMS) {
        const int kc = c0 + kb;
        const int n = n0 + nq * 4;
        if (kc < cs && n < p.cout) {
          const float* wr = wsrc + ((size_t)tap * cs + kc) * p.cout;
          load4(wr, n, p.cout, vecw, breg);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) breg[j] = 0.f;
        }
      }
    }
    if (chunk > 0) {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float w[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // The fp32 tile to the scratch.  Rows beyond the image and channels
  // beyond Cout hold exact zeros (their slabs were zero) and are skipped.
  const int n = n0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= m_total || n >= p.cout) continue;
    float* dst = p.y + ((size_t)b * m_total + m) * p.cout + n;
    if (vecw) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < p.cout) dst[j] = acc[i][j];
    }
  }
  // Per-channel sums over the block's pixels, fixed order.
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      s1 += acc[i][j];
      s2 += acc[i][j] * acc[i][j];
    }
    red1[ty * BN + tx * TN + j] = s1;
    red2[ty * BN + tx * TN + j] = s2;
  }
  __syncthreads();
  if (tid < BN && n0 + tid < p.cout) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < TY; ++r) {
      s1 += red1[r * BN + tid];
      s2 += red2[r * BN + tid];
    }
    float* dst = p.partials +
                 ((((size_t)b * gridDim.x + blockIdx.x) * p.cout) + n0 + tid) * 2;
    dst[0] = s1;
    dst[1] = s2;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename TO, int V>
__global__ void __launch_bounds__(kThreads)
gn_elu_apply(const float* __restrict__ y, const float* __restrict__ partials,
             const float* __restrict__ scale, const float* __restrict__ bias,
             TO* __restrict__ a_out, TO* __restrict__ yn_out, float* __restrict__ inv_out,
             int m_total, int cout, int groups, int mtiles, int rows_per_chunk, float eps) {
  __shared__ float mean_g[kMaxC];
  __shared__ float inv_g[kMaxC];
  __shared__ float mean_c[kMaxC];
  __shared__ float inv_c[kMaxC];
  __shared__ float sc_c[kMaxC];
  __shared__ float bi_c[kMaxC];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int lane = tid & 31, warp = tid >> 5;
  const int cg = cout / groups;
  const float count = (float)m_total * (float)cg;
  // Fold the image's partials: one warp per group, lanes over (tile,
  // channel of the group), then a butterfly: the same order every time.
  for (int g = warp; g < groups; g += kThreads / 32) {
    float t1 = 0.f, t2 = 0.f;
    for (int idx = lane; idx < mtiles * cg; idx += 32) {
      const int t = idx / cg, j = idx - t * cg;
      const float* src = partials + ((((size_t)b * mtiles + t) * cout) + g * cg + j) * 2;
      t1 += src[0];
      t2 += src[1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    if (lane == 0) {
      const float mean = t1 / count;
      // clamp: cancellation can dip below zero and rsqrt would give NaN
      const float var = fmaxf(t2 / count - mean * mean, 0.f);
      mean_g[g] = mean;
      inv_g[g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int ch = tid; ch < cout; ch += kThreads) {
    mean_c[ch] = mean_g[ch / cg];
    inv_c[ch] = inv_g[ch / cg];
    sc_c[ch] = scale[ch];
    bi_c[ch] = bias[ch];
    if (blockIdx.x == 0 && inv_out != nullptr) inv_out[(size_t)b * cout + ch] = inv_g[ch / cg];
  }
  __syncthreads();
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, m_total);
  const int per_row = cout / V;
  const size_t base = (size_t)b * m_total * cout;
  for (int e = r0 * per_row + tid; e < r1 * per_row; e += kThreads) {
    const int c0 = (e % per_row) * V;
    const size_t off = base + (size_t)e * V;
    const Pack<float, V> in = *reinterpret_cast<const Pack<float, V>*>(y + off);
    Pack<TO, V> qa, qn;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float yn = (in.v[i] - mean_c[c0 + i]) * inv_c[c0 + i];
      const float z = yn * sc_c[c0 + i] + bi_c[c0 + i];
      qa.v[i] = from_f32<TO>(z > 0.f ? z : expm1f(z));
      qn.v[i] = from_f32<TO>(yn);
    }
    *reinterpret_cast<Pack<TO, V>*>(a_out + off) = qa;
    if (yn_out != nullptr) *reinterpret_cast<Pack<TO, V>*>(yn_out + off) = qn;
  }
}

// ---- the tensor-core K loops (bf16 taps) ----

// K is one flattened axis of 9 * kc_p columns, k = tap * kc_p + c, where a
// tap's kc_p = cx_p + cl_p columns are x's channels rounded up to 8, then
// the lateral's (none for one input).  A K step is BK consecutive columns:
// 64 where kc_p % 64 == 0 and the copies are asynchronous (half the
// barriers and stage switches a flop; 64-row tiles only), else 32.  A
// step may straddle two taps or both sources: each 16-byte piece (8
// columns) lies in one tap of one source and resolves its own.  Only the
// last step runs past K (zero-filled): 9 * 48 = 432 columns take 14 steps
// of 32, against 18 for a step per (tap, 32 channels).  The cp.async ring
// holds four stages of 32, three of 64.
__host__ __device__ constexpr int tc_stages(int bk) { return bk == 64 ? 3 : 4; }

// Warps: WARPS_M along M (BM / WARPS_M pixels each) x BN / WN along N, WN =
// 32 output channels a warp (16 when BN <= 32), WARPS_M = 2 (4 for the BN =
// 16 tile of Cout <= 16, which keeps four warps a block): 128 threads, 256
// at BN = 128.  At most 128 registers a thread (512 threads an SM in the
// launch bounds), so that two 128 x 128 blocks share an SM where one alone
// left the tensor cores waiting on its barriers.
__host__ __device__ constexpr int tc_wn(int bn) { return bn >= 64 ? 32 : 16; }
__host__ __device__ constexpr int tc_warps_m(int bn) { return bn == 16 ? 4 : 2; }
__host__ __device__ constexpr int tc_threads(int bn) {
  return 32 * tc_warps_m(bn) * (bn / tc_wn(bn));
}

struct TcArgs {
  const void* x;             // (B, H, W, cx) NHWC, bf16 or fp32
  const void* lat;           // (B, H, W, cl), x's dtype; x itself when cl = 0
  const __nv_bfloat16* wk;   // (cout, 9 * (cx_p + cl_p)), K-major
  float* y;                  // (B, ho*wo, cout)
  float* partials;           // (B, mtiles, cout, 2)
  int h, w, cx, cl, cx_p, cl_p, cout;
  int ho, wo, pad_top, pad_left;  // the output map; the low SAME pads
  int tiles_x;               // upsample: U tiles along a row
  int copy16;                // upsample: cp.async may copy x's channels
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `chunk` (0..BK/8-1) of tile row `row`, rows
// of BK bf16.  BK = 32: rows of 64 bytes, two to a 128-byte line of the 32
// banks, XOR with (row / 2) % 4; BK = 64: one row a line, XOR with row % 8.
// Either way the 8 rows of one ldmatrix phase, and the pieces that 8
// threads copy, land on 8 distinct 16-byte bank groups.
template <int BK>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  if constexpr (BK == 64) return row * 128 + ((chunk ^ (row & 7)) << 4);
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// L1 = true caches the line in L1 as well (.ca), else L2 only (.cg).
template <bool L1 = false>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  if constexpr (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 products summed in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Channels c..c+7 of the pixel at px as 8 bf16 (rounded to nearest even),
// zero where !valid or beyond cin: the gather of the register path.
template <typename T>
__device__ __forceinline__ uint4 gather8(const T* px, int c, int cin, bool valid) {
  float f[8];
  if (!valid) {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = 0.f;
  } else if (sizeof(T) == 4 && (cin & 3) == 0 && c + 8 <= cin) {  // fp32, 16-byte aligned
    const float4 lo = *reinterpret_cast<const float4*>(px + c);
    const float4 hi = *reinterpret_cast<const float4*>(px + c + 4);
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (c + j < cin) ? to_f32(px[c + j]) : 0.f;
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    o[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return out;
}

// The end of every tensor-core K loop: the fp32 tile to the scratch y and
// the block's per-channel (sum, sum of squares) to partials.  Thread (g, t)
// of a warp holds rows g and g + 8 of each 16-row tile, columns 2t and
// 2t + 1 of each 8-column tile.  pixel(r) is the output pixel of tile row
// r, or -1 past the map: such a row is not stored, and with MASK not
// summed either (without MASK it is an exact zero, its operands were).
// Channels beyond Cout are exact zeros and are not stored.  The sums run
// in a fixed order: a thread's rows, then the lanes that share its columns
// (xor 4, 8, 16), then the warps along M; red is the free ring.
template <int MT, int NT, int WM, int WN, int WARPS_M, int BN, bool MASK, typename Pixel>
__device__ __forceinline__ void tc_store_stats(const float (&acc)[MT][NT][4], const TcArgs& p,
                                               int b, int n0, int m_total, float* red,
                                               Pixel pixel) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const bool even = (p.cout & 1) == 0;
  bool ok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = pixel(warp_m * WM + mt * 16 + g + half * 8);
      ok[mt][half] = m >= 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + warp_n * WN + nt * 8 + 2 * t;
        if (m < 0 || n >= p.cout) continue;
        float* dst = p.y + ((size_t)b * m_total + m) * p.cout + n;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (even) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (n + 1 < p.cout) dst[1] = v1;
        }
      }
    }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float lo = acc[mt][nt][j], hi = acc[mt][nt][2 + j];
        if constexpr (MASK) {
          lo = ok[mt][0] ? lo : 0.f;
          hi = ok[mt][1] ? hi : 0.f;
        }
        s1 += lo;
        s2 += lo * lo;
        s1 += hi;
        s2 += hi * hi;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0) {
        const int col = warp_n * WN + nt * 8 + 2 * t + j;
        red[(warp_m * BN + col) * 2] = s1;
        red[(warp_m * BN + col) * 2 + 1] = s2;
      }
    }
  __syncthreads();
  if (tid < BN && n0 + tid < p.cout) {
    float s1 = red[tid * 2], s2 = red[tid * 2 + 1];
#pragma unroll
    for (int wm = 1; wm < WARPS_M; ++wm) {
      s1 += red[(wm * BN + tid) * 2];
      s2 += red[(wm * BN + tid) * 2 + 1];
    }
    float* dst = p.partials + ((((size_t)b * gridDim.x + blockIdx.x) * p.cout) + n0 + tid) * 2;
    dst[0] = s1;
    dst[1] = s2;
  }
}

// Launch 1 on the tensor cores.  grid (m tiles, Cout tiles, B); a block owns
// BM output pixels of ONE image x BN output channels and walks the
// flattened K axis BK columns at a time.  Same outputs as conv3x3_stats:
// the fp32 tile to y, per-channel (sum, sum of squares) over the block's
// pixels to partials.
template <typename T, int BM, int BN, int BK, bool ASYNC, int S>
__global__ void __launch_bounds__(tc_threads(BN), 512 / tc_threads(BN))
    conv3x3_stats_tc(TcArgs p) {
  constexpr int THREADS = tc_threads(BN);
  constexpr int WN = tc_wn(BN), WARPS_M = tc_warps_m(BN), WARPS_N = BN / WN;
  constexpr int WM = BM / WARPS_M;
  constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles of a warp
  constexpr int PIECES = BK / 8;            // 16-byte pieces of a tile row
  constexpr int ROWS = THREADS / PIECES;    // tile rows one pass of the copies covers
  constexpr int A_IT = BM / ROWS;           // pieces a thread copies
  constexpr int B_IT = (BN + ROWS - 1) / ROWS;  // BN = 16 at BK = 32: half a pass
  constexpr int STAGES = tc_stages(BK);
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int STAGE = (BM + BN) * BK * 2;
  static_assert(BM % ROWS == 0 && A_IT >= 1 && (BN % ROWS == 0 || BN < ROWS), "copies");
  static_assert(NT % 2 == 0 && MT >= 1 && WM % 16 == 0, "tile");
  static_assert(BK == 32 || (BK == 64 && ASYNC), "K step");
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "warps");
  static_assert(THREADS >= BN, "the statistics' last step takes a thread a channel");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = p.h * p.w;  // input pixels of an image
  const int m_total = S == 1 ? hw : p.ho * p.wo;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * hw * p.cx;
  const T* lb = static_cast<const T*>(p.lat) + (size_t)b * hw * p.cl;
  const int kc_p = p.cx_p + p.cl_p;  // K columns a tap
  const int k_total = 9 * kc_p;
  const int kchunks = (k_total + BK - 1) / BK;

  // This thread's pieces: tile rows (tid / PIECES + i * ROWS), piece
  // tid % PIECES.  Registers are the scarce resource (128 a thread): a
  // row is kept as one word, the input position of its tap (1, 1), (iy <<
  // 16) + ix with iy = oy * S - pad_top + 1 and ix likewise, in [0, H] x
  // [0, W] (H < 2^15, W < 2^16; iy = -2^15 past the image, never inside:
  // the row stays zero), and the weight rows as one pointer and a mask.
  // At S = 1 (pads 1) the position is the output pixel itself.
  const int piece = tid % PIECES;
  int a_pos[A_IT];
#pragma unroll
  for (int i = 0; i < A_IT; ++i) {
    const int m = m0 + tid / PIECES + i * ROWS;
    if constexpr (S == 1) {
      a_pos[i] = m < m_total ? (m / p.w) * 65536 + m % p.w : INT_MIN;
    } else {
      const int oy = m / p.wo;
      a_pos[i] = m < m_total ? (oy * S - p.pad_top + 1) * 65536 +
                                   (m - oy * p.wo) * S - p.pad_left + 1
                             : INT_MIN;
    }
  }
  const __nv_bfloat16* b_row = p.wk + (size_t)min(n0 + tid / PIECES, p.cout - 1) * k_total;
  unsigned b_ok = 0;
#pragma unroll
  for (int i = 0; i < B_IT; ++i) {
    const int row = tid / PIECES + i * ROWS;
    b_ok |= (row < BN && n0 + row < p.cout) ? 1u << i : 0u;
  }

  auto load = [&](int stage, int kc) {
    // This thread's 8 columns: tap, source, channel; past K it copies zeros.
    const int k = kc * BK + piece * 8;
    const int tap = k / kc_p;
    const bool in_k = tap < 9;
    const bool second = k - tap * kc_p >= p.cx_p;
    const int c = k - tap * kc_p - (second ? p.cx_p : 0);
    const int cs = second ? p.cl : p.cx;
    const T* src = second ? lb : xb;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t sa = s0 + stage * STAGE;
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
      const int row = tid / PIECES + i * ROWS;
      const int hi = (a_pos[i] >> 16) + dy, wi = (a_pos[i] & 0xffff) + dx;
      const bool ok = in_k && hi >= 0 && hi < p.h && wi >= 0 && wi < p.w;
      const T* px = src + ((size_t)(ok ? hi : 0) * p.w + (ok ? wi : 0)) * cs;
      // At BN = 16 each gathered byte feeds few products and the nine
      // taps' re-reads of a pixel set the pace: they may hit L1 there.
      if constexpr (ASYNC)
        cp_async16<BN == 16>(sa + swz<BK>(row, piece), ok ? px + c : xb, ok);
      else
        *reinterpret_cast<uint4*>(smem + stage * STAGE + swz<BK>(row, piece)) =
            gather8(px, c, cs, ok);
    }
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int row = tid / PIECES + i * ROWS;
      if (BN < ROWS && row >= BN) continue;
      const bool ok = (b_ok >> i & 1u) && in_k;
      cp_async16(sa + A_BYTES + swz<BK>(row, piece),
                 ok ? b_row + (size_t)i * ROWS * k_total + k : p.wk, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kchunks) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < kchunks; ++kc) {
    cp_async_wait<STAGES - 2>();  // chunk kc has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage (kc - 1) is free
    const int next = kc + STAGES - 1;
    if (next < kchunks) load(next % STAGES, next);
    cp_async_commit();
    const uint32_t sa = s0 + (kc % STAGES) * STAGE, sb = sa + A_BYTES;
    // The chunk's BK products of each output are summed on the tensor
    // cores from zero, then added to acc in IEEE fp32: the tensor cores'
    // own fp32 sums then never run over more than BK / 16 products of 16,
    // and a 4608-deep K loop stays as close to cuDNN's fp32 result as the
    // FMA kernel (a single chain of mma over all of K missed the fp32
    // tolerance at the 512-channel site).
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(sa + swz<BK>(warp_m * WM + mt * 16 + (lane & 15), kk * 2 + (lane >> 4)),
                    af[mt]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(sb + swz<BK>(warp_n * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kk * 2 + ((lane >> 3) & 1)),
                    bfr[np]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(part[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                   bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the statistics reuse it

  tc_store_stats<MT, NT, WM, WN, WARPS_M, BN, false>(
      acc, p, b, n0, m_total, reinterpret_cast<float*>(smem),
      [&](int r) { return m0 + r < m_total ? m0 + r : -1; });
}

// U tile of the upsample kernel: 16 columns x BM / 16 rows of U.
constexpr int kUpTW = 16;
constexpr int kUpBK = 32;  // input channels a chunk: the K step of one tap

__host__ __device__ constexpr int up_smem(int bm, int bn, int item) {
  return tc_stages(kUpBK) * bn * kUpBK * 2                       // weight ring
         + (bm / kUpTW + 2) * (kUpTW + 2) * (kUpBK * 2 + 16)      // halo tile of U
         + (bm / kUpTW / 2 + 2) * (kUpTW / 2 + 2) * kUpBK * item;  // x patch
}

// Launch 1 of the upsample entry point on the tensor cores.  grid (U
// tiles, Cout tiles, B); a block owns a TH x 16 tile of U (tile index
// blockIdx.x, tiles_x to a row) x BN output channels.  K runs over
// (chunk of 32 input channels, tap): at a chunk's first tap the block
// blends the chunk's halo tile of U ((TH + 2) x 18 pixels) from the x
// patch staged with that step's weights, and every tap reads its A
// fragments from the halo tile, rows shifted by (ky, kx).  The weights
// stream through the same cp.async ring as in conv3x3_stats_tc, and each
// (chunk, tap) step is summed from zero on the tensor cores and added to
// acc in IEEE fp32, as there.  Same outputs as conv3x3_stats_tc.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(tc_threads(BN), 512 / tc_threads(BN))
    conv3x3_stats_tc_up(TcArgs p) {
  constexpr int BK = kUpBK;
  constexpr int THREADS = tc_threads(BN);
  constexpr int WN = tc_wn(BN), WARPS_M = tc_warps_m(BN), WARPS_N = BN / WN;
  constexpr int WM = BM / WARPS_M;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int PIECES = BK / 8;                // 16-byte pieces of a bf16 row
  constexpr int ROWS = THREADS / PIECES;
  constexpr int B_IT = (BN + ROWS - 1) / ROWS;
  constexpr int STAGES = tc_stages(BK);
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int TW = kUpTW, TH = BM / TW;
  constexpr int HW = TW + 2, HROWS = (TH + 2) * HW;  // the halo tile, row-major
  // A halo row is 64 bytes of bf16 and 16 of padding: 8 consecutive rows
  // (one ldmatrix phase, at any shift) land on 8 distinct bank groups.
  constexpr int HSTRIDE = BK * 2 + 16;
  constexpr int PW = TW / 2 + 2, PPIX = (TH / 2 + 2) * PW;  // the x patch
  constexpr int VEC = 16 / sizeof(T);           // channels of a 16-byte copy
  constexpr int PPIECES = BK / VEC;             // copies of a patch pixel
  constexpr int HALO = STAGES * B_BYTES;        // byte offsets in smem
  constexpr int PATCH = HALO + HROWS * HSTRIDE;
  static_assert(BM % (2 * TW) == 0 && WM % 16 == 0 && NT % 2 == 0, "tile");
  static_assert(BN % ROWS == 0 || BN < ROWS, "copies");
  static_assert(STAGES - 1 < 9, "a chunk's patch is staged after the last one was blended");
  static_assert(THREADS >= BN, "the statistics' last step takes a thread a channel");
  static_assert(PATCH + PPIX * BK * (int)sizeof(T) == up_smem(BM, BN, sizeof(T)), "smem");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int b = blockIdx.z, n0 = blockIdx.y * BN;
  const int tile_y = blockIdx.x / p.tiles_x;
  const int uy0 = tile_y * TH, ux0 = (blockIdx.x - tile_y * p.tiles_x) * TW;
  const int py0 = uy0 / 2 - 1, px0 = ux0 / 2 - 1;  // the patch's origin in x
  const int m_total = p.ho * p.wo;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * p.h * p.w * p.cx;
  const int k_total = 9 * p.cx_p;  // cx_p: cx rounded up to BK
  const int ksteps = k_total / BK;

  const int piece = tid % PIECES;
  const __nv_bfloat16* b_row = p.wk + (size_t)min(n0 + tid / PIECES, p.cout - 1) * k_total;
  unsigned b_ok = 0;
#pragma unroll
  for (int i = 0; i < B_IT; ++i) {
    const int row = tid / PIECES + i * ROWS;
    b_ok |= (row < BN && n0 + row < p.cout) ? 1u << i : 0u;
  }

  // Step kc's weights; at a chunk's first tap also the chunk's x patch
  // (zeros outside the image and past cx: never blended, or times zero
  // weights).  The patch has one buffer: a chunk's is copied STAGES - 1
  // steps before its first tap, which is 9 - (STAGES - 1) steps and at
  // least one barrier after the last chunk's was blended.
  auto load = [&](int stage, int kc) {
    const uint32_t sb = s0 + stage * B_BYTES;
    const int k = kc * BK + piece * 8;
#pragma unroll
    for (int i = 0; i < B_IT; ++i) {
      const int row = tid / PIECES + i * ROWS;
      if (BN < ROWS && row >= BN) continue;
      const bool ok = b_ok >> i & 1u;
      cp_async16(sb + swz<BK>(row, piece), ok ? b_row + (size_t)i * ROWS * k_total + k : p.wk,
                 ok);
    }
    if (kc % 9) return;
    const int c0 = kc / 9 * BK;
    for (int j = tid; j < PPIX * PPIECES; j += THREADS) {
      const int pix = j / PPIECES, c = c0 + (j - pix * PPIECES) * VEC;
      const int xr = py0 + pix / PW, xc = px0 + pix % PW;
      const bool in = xr >= 0 && xr < p.h && xc >= 0 && xc < p.w;
      const T* src = xb + ((size_t)(in ? xr : 0) * p.w + (in ? xc : 0)) * p.cx + c;
      if (p.copy16) {
        cp_async16(s0 + PATCH + j * 16, in && c < p.cx ? src : xb, in && c < p.cx);
      } else {
        T v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = in && c + e < p.cx ? src[e] : T(0.f);
        *reinterpret_cast<uint4*>(smem + PATCH + j * 16) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  // The chunk's halo tile of U from the patch: U position (uy0 - 1 + r,
  // ux0 - 1 + c) at halo row r * HW + c, zero outside [0, 2H) x [0, 2W)
  // (the convolution's padding), else the blend of its near and far x
  // rows and columns (the far index clamped into x), rounded to bf16.
  auto build_halo = [&]() {
    const T* patch = reinterpret_cast<const T*>(smem + PATCH);
    for (int j = tid; j < HROWS * PIECES; j += THREADS) {
      const int r = j / PIECES, pc = j - r * PIECES;
      const int hr = r / HW;
      const int u = uy0 - 1 + hr, v = ux0 - 1 + (r - hr * HW);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (u >= 0 && u < 2 * p.h && v >= 0 && v < 2 * p.w) {
        const int rn = u >> 1, cn = v >> 1;
        const int rf = (u & 1) ? min(rn + 1, p.h - 1) : max(rn - 1, 0);
        const int cf = (v & 1) ? min(cn + 1, p.w - 1) : max(cn - 1, 0);
        const T* at = patch + pc * 8;
        const T* nn = at + ((rn - py0) * PW + cn - px0) * BK;
        const T* fn = at + ((rf - py0) * PW + cn - px0) * BK;
        const T* nf = at + ((rn - py0) * PW + cf - px0) * BK;
        const T* ff = at + ((rf - py0) * PW + cf - px0) * BK;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // 4 channels at a time
          float a[4], bb[4], c[4], d[4];
          load4(nn, 4 * q, 8, true, a);
          load4(fn, 4 * q, 8, true, bb);
          load4(nf, 4 * q, 8, true, c);
          load4(ff, 4 * q, 8, true, d);
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const __nv_bfloat162 v2 = __floats2bfloat162_rn(
                blend(blend(d[e], c[e]), blend(bb[e], a[e])),
                blend(blend(d[e + 1], c[e + 1]), blend(bb[e + 1], a[e + 1])));
            o[2 * q + e / 2] = *reinterpret_cast<const uint32_t*>(&v2);
          }
        }
      }
      *reinterpret_cast<uint4*>(smem + HALO + r * HSTRIDE + pc * 16) = out;
    }
  };

  // This lane's ldmatrix rows: halo row of its pixel's tap (0, 0).
  int a_row[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int px = warp_m * WM + mt * 16 + (lane & 15);
    a_row[mt] = (px / TW) * HW + px % TW;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < ksteps; ++kc) {
    cp_async_wait<STAGES - 2>();  // step kc (and at tap 0 its patch) has landed
    __syncthreads();              // ... for everyone; stage (kc - 1) is free
    const int next = kc + STAGES - 1;
    if (next < ksteps) load(next % STAGES, next);
    cp_async_commit();
    const int tap = kc % 9;
    if (tap == 0) {  // the last chunk's taps are done: the halo tile is free
      build_halo();
      __syncthreads();
    }
    const int shift = (tap / 3) * HW + tap % 3;
    const uint32_t sh = s0 + HALO, sb = s0 + (kc % STAGES) * B_BYTES;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(sh + (a_row[mt] + shift) * HSTRIDE + (kk * 2 + (lane >> 4)) * 16, af[mt]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(sb + swz<BK>(warp_n * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                             kk * 2 + ((lane >> 3) & 1)),
                    bfr[np]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(part[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2],
                   bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the statistics reuse it

  // Rows of the tile past U's edge read real halo pixels: masked.
  tc_store_stats<MT, NT, WM, WN, WARPS_M, BN, true>(
      acc, p, b, n0, m_total, reinterpret_cast<float*>(smem), [&](int r) {
        const int uy = uy0 + r / TW, ux = ux0 + r % TW;
        return uy < p.ho && ux < p.wo ? uy * p.wo + ux : -1;
      });
}

template <typename T, int BM, int BN>
cudaError_t launch_conv(const ConvArgs& p, int batch, int mtiles, bool upsample,
                        cudaStream_t stream) {
  dim3 grid(mtiles, (p.cout + BN - 1) / BN, batch);
  if (upsample)
    conv3x3_stats<T, BM, BN, true><<<grid, kThreads, 0, stream>>>(p);
  else
    conv3x3_stats<T, BM, BN, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv_bm(const ConvArgs& p, int batch, int bm, int mtiles, bool upsample,
                           cudaStream_t stream) {
  if (bm == 64) return launch_conv<T, 64, 64>(p, batch, mtiles, upsample, stream);
  if (bm == 128) return launch_conv<T, 128, 32>(p, batch, mtiles, upsample, stream);
  if (bm == 256) return launch_conv<T, 256, 16>(p, batch, mtiles, upsample, stream);
  return cudaErrorInvalidValue;
}

template <typename TO>
cudaError_t launch_apply(const float* y, const float* partials, const float* scale,
                         const float* bias, void* a, void* yn, float* inv, int batch,
                         int m_total, int cout, int groups, int mtiles, int rows_per_chunk,
                         float eps, cudaStream_t stream) {
  dim3 grid((m_total + rows_per_chunk - 1) / rows_per_chunk, batch);
  if ((cout & 3) == 0)
    gn_elu_apply<TO, 4><<<grid, kThreads, 0, stream>>>(
        y, partials, scale, bias, static_cast<TO*>(a), static_cast<TO*>(yn), inv, m_total,
        cout, groups, mtiles, rows_per_chunk, eps);
  else
    gn_elu_apply<TO, 1><<<grid, kThreads, 0, stream>>>(
        y, partials, scale, bias, static_cast<TO*>(a), static_cast<TO*>(yn), inv, m_total,
        cout, groups, mtiles, rows_per_chunk, eps);
  return cudaGetLastError();
}

// Sets the dynamic shared memory limit of `kernel` once (`ready` is the
// instantiation's own flag) and launches it on grid (mtiles, Cout tiles, B).
template <typename Kernel>
cudaError_t launch_dyn(Kernel kernel, bool& ready, int smem, int threads, int mtiles, int bn,
                       const TcArgs& p, int batch, cudaStream_t stream) {
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  dim3 grid(mtiles, (p.cout + bn - 1) / bn, batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, int BK, bool ASYNC, int S>
cudaError_t launch_tc(const TcArgs& p, int batch, cudaStream_t stream) {
  constexpr int smem = tc_stages(BK) * (BM + BN) * BK * 2;  // up to 96 KB: dynamic
  static bool ready = false;
  return launch_dyn(conv3x3_stats_tc<T, BM, BN, BK, ASYNC, S>, ready, smem, tc_threads(BN),
                    (p.ho * p.wo + BM - 1) / BM, BN, p, batch, stream);
}

// The register path's 128-row tiles stop at BN = 32: wider ones spill
// under the 128-register cap (its gather holds 8 floats a piece).
template <typename T, int BM, int BK, bool ASYNC, int S>
cudaError_t launch_tc_bn(const TcArgs& p, int batch, int bn, cudaStream_t stream) {
  if (bn == 16) return launch_tc<T, BM, 16, BK, ASYNC, S>(p, batch, stream);
  if (bn == 32) return launch_tc<T, BM, 32, BK, ASYNC, S>(p, batch, stream);
  if constexpr (ASYNC || BM == 64) {
    if (bn == 64) return launch_tc<T, BM, 64, BK, ASYNC, S>(p, batch, stream);
    if (bn == 128) return launch_tc<T, BM, 128, BK, ASYNC, S>(p, batch, stream);
  }
  return cudaErrorInvalidValue;
}

// The 64-channel K step runs 64-row tiles only: with 128 rows it spills
// under the 128-register cap.
template <typename T, int BK, bool ASYNC, int S>
cudaError_t launch_tc_tile(const TcArgs& p, int batch, int bm, int bn, cudaStream_t stream) {
  if (bm == 64) return launch_tc_bn<T, 64, BK, ASYNC, S>(p, batch, bn, stream);
  if constexpr (BK == 32)
    if (bm == 128) return launch_tc_bn<T, 128, BK, ASYNC, S>(p, batch, bn, stream);
  return cudaErrorInvalidValue;
}

// The K step and the copies by the inputs: 64 columns where bf16 sources
// are 16-byte aligned and a tap's columns fill them, cp.async wherever
// bf16 sources are aligned, the register path otherwise.
template <int S>
cudaError_t launch_tc_route(const TcArgs& p, int in_dtype, int batch, int bm, int bn,
                            cudaStream_t stream) {
  // cp.async needs every 8 channels of a pixel 16-byte aligned in both sources
  const bool aligned = p.cx % 8 == 0 && p.cl % 8 == 0;
  if (in_dtype == 1 && aligned && (p.cx_p + p.cl_p) % 64 == 0)
    return launch_tc_tile<__nv_bfloat16, 64, true, S>(p, batch, bm, bn, stream);
  if (in_dtype == 1 && aligned)
    return launch_tc_tile<__nv_bfloat16, 32, true, S>(p, batch, bm, bn, stream);
  if (in_dtype == 1) return launch_tc_tile<__nv_bfloat16, 32, false, S>(p, batch, bm, bn, stream);
  if (in_dtype == 0) return launch_tc_tile<float, 32, false, S>(p, batch, bm, bn, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int BM, int BN>
cudaError_t launch_up(const TcArgs& p, int batch, int mtiles, cudaStream_t stream) {
  constexpr int smem = up_smem(BM, BN, sizeof(T));  // up to 54 KB: dynamic
  static bool ready = false;
  return launch_dyn(conv3x3_stats_tc_up<T, BM, BN>, ready, smem, tc_threads(BN), mtiles, BN, p,
                    batch, stream);
}

// With fp32 inputs the 128-row tiles stop at BN = 32: wider ones spill
// under the 128-register cap (the blend holds four float4 loads).
template <typename T, int BM>
cudaError_t launch_up_bn(const TcArgs& p, int batch, int bn, int mtiles, cudaStream_t stream) {
  if (bn == 16) return launch_up<T, BM, 16>(p, batch, mtiles, stream);
  if (bn == 32) return launch_up<T, BM, 32>(p, batch, mtiles, stream);
  if constexpr (sizeof(T) == 2 || BM == 64) {
    if (bn == 64) return launch_up<T, BM, 64>(p, batch, mtiles, stream);
    if (bn == 128) return launch_up<T, BM, 128>(p, batch, mtiles, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_up_tile(const TcArgs& p, int batch, int bm, int bn, int mtiles,
                           cudaStream_t stream) {
  if (bm == 64) return launch_up_bn<T, 64>(p, batch, bn, mtiles, stream);
  if (bm == 128) return launch_up_bn<T, 128>(p, batch, bn, mtiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, cx) and lat (B, H, W, cl; null and cl = 0 for one input) in
// in_dtype; wx (9, cx, cout), wl (9, cl, cout) fp32; scale, bias fp32 (cout).
// y (B, ho*wo, cout) and partials (B, mtiles, cout, 2) are fp32 scratch with
// mtiles = ceil(ho*wo / bm), bm one of 64 (64 channels a block), 128 (32)
// or 256 (16).  a and yn (null to skip) are (B, ho, wo, cout) in out_dtype,
// inv (null to skip) is fp32 (B, cout).  dtypes: 0 = float32, 1 = bfloat16.
// round_bf16 rounds fp32 inputs to bf16 as they are read.  upsample = 1
// puts the bilinear 2x of x in front of the convolution (one input,
// stride 1, ho = 2h, wo = 2w, pads 1; round_bf16 then rounds the blended
// values, whatever in_dtype is).  Returns a cudaError_t.
extern "C" int conv_gn_elu_forward(const void* x, const void* lat, const void* wx,
                                   const void* wl, const void* scale, const void* bias,
                                   void* y, void* partials, void* a, void* yn, void* inv,
                                   int batch, int h, int w, int cx, int cl, int cout, int ho,
                                   int wo, int stride, int pad_top, int pad_left, int groups,
                                   float eps, int in_dtype, int out_dtype, int round_bf16,
                                   int bm, int rows_per_chunk, int upsample, void* stream) {
  if (upsample && (cl != 0 || stride != 1 || ho != 2 * h || wo != 2 * w || pad_top != 1 ||
                   pad_left != 1))
    return (int)cudaErrorInvalidValue;
  if (cout > kMaxC || groups < 1 || cout % groups != 0 || batch < 1 || cx < 1 || cl < 0 ||
      (cl > 0 && (lat == nullptr || wl == nullptr)) || rows_per_chunk < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvArgs p;
  p.x = x;
  p.lat = lat;
  p.wx = static_cast<const float*>(wx);
  p.wl = static_cast<const float*>(wl);
  p.y = static_cast<float*>(y);
  p.partials = static_cast<float*>(partials);
  p.h = h; p.w = w; p.cx = cx; p.cl = cl; p.cout = cout; p.ho = ho; p.wo = wo;
  p.stride = stride; p.pad_top = pad_top; p.pad_left = pad_left;
  p.round_bf16 = (in_dtype == 0 || upsample) ? round_bf16 : 0;
  const int m_total = ho * wo;
  if (bm < 1) return (int)cudaErrorInvalidValue;
  const int mtiles = (m_total + bm - 1) / bm;
  cudaError_t err;
  if (in_dtype == 0)
    err = launch_conv_bm<float>(p, batch, bm, mtiles, upsample != 0, st);
  else if (in_dtype == 1)
    err = launch_conv_bm<__nv_bfloat16>(p, batch, bm, mtiles, upsample != 0, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* iv = static_cast<float*>(inv);
  if (out_dtype == 0)
    err = launch_apply<float>(p.y, p.partials, sc, bi, a, yn, iv, batch, m_total, cout,
                              groups, mtiles, rows_per_chunk, eps, st);
  else if (out_dtype == 1)
    err = launch_apply<__nv_bfloat16>(p.y, p.partials, sc, bi, a, yn, iv, batch, m_total,
                                      cout, groups, mtiles, rows_per_chunk, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

// The tensor-core route: bf16 taps, SAME.  x (B, H, W, cx) and lat (B, H,
// W, cl; null and cl = 0 for one input) in in_dtype (fp32 is rounded to
// bf16 as gathered or blended); scale, bias fp32 (cout).  stride 1: ho =
// h, wo = w, pads 1, one input or two; wk bf16 (cout, 9 * (cx_p + cl_p)),
// cx_p and cl_p = cx and cl rounded up to 8, K-major: column tap * (cx_p +
// cl_p) + c holds wx's channel c below cx_p, wl's channel c - cx_p above,
// zero in the padding.  stride 2: one input, ho = ceil(h / 2), wo =
// ceil(w / 2), pad_top and pad_left 0 or 1 (XLA's SAME: 1 for an odd
// length), wk as at stride 1.  upsample = 1: the bilinear 2x of x in
// front, one input, stride 1, ho = 2h, wo = 2w, pads 1; wk bf16 (cout, 9 *
// cx_p) with cx_p = cx rounded up to 32, column (chunk * 9 + tap) * 32 + c
// holding channel chunk * 32 + c, zero past cx.  y (B, ho*wo, cout) and
// partials (B, mtiles, cout, 2) are fp32 scratch with mtiles = ceil(ho*wo
// / bm), or for the upsample ceil(ho / (bm / 16)) * ceil(wo / 16); (bm,
// bn) is one of {64, 128} x {16, 32, 64, 128}: without the upsample bm =
// 64 where cx_p + cl_p is a multiple of 64, and bn <= 32 at bm = 128
// where an input takes the register path (fp32, or cx or cl % 8 != 0);
// with the upsample bn <= 32 at bm = 128 for fp32 inputs.
// ho < 2^15 and wo < 2^16 (h, w likewise).  a, yn, inv as
// conv_gn_elu_forward.  Returns a cudaError_t.
extern "C" int conv_gn_elu_forward_tc(const void* x, const void* lat, const void* wk,
                                      const void* scale, const void* bias, void* y,
                                      void* partials, void* a, void* yn, void* inv, int batch,
                                      int h, int w, int cx, int cl, int cout, int ho, int wo,
                                      int stride, int pad_top, int pad_left, int groups,
                                      float eps, int in_dtype, int out_dtype, int bm, int bn,
                                      int rows_per_chunk, int upsample, void* stream) {
  if (cout < 1 || cout > kMaxC || groups < 1 || cout % groups != 0 || batch < 1 ||
      batch > 65535 || cx < 1 || cl < 0 || (cl > 0) != (lat != nullptr) || h < 1 ||
      h >= 32768 || w < 1 || w >= 65536 || ho >= 32768 || wo >= 65536 ||
      rows_per_chunk < 1 || (bm != 64 && bm != 128) ||
      (bn != 16 && bn != 32 && bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  const bool pads1 = pad_top == 1 && pad_left == 1;
  if (upsample ? cl != 0 || stride != 1 || ho != 2 * h || wo != 2 * w || !pads1
      : stride == 1 ? ho != h || wo != w || !pads1
      : stride == 2 ? cl != 0 || ho != (h + 1) / 2 || wo != (w + 1) / 2 || pad_top < 0 ||
                          pad_top > 1 || pad_left < 0 || pad_left > 1
                    : true)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TcArgs p;
  p.x = x;
  p.lat = cl > 0 ? lat : x;
  p.wk = static_cast<const __nv_bfloat16*>(wk);
  p.y = static_cast<float*>(y);
  p.partials = static_cast<float*>(partials);
  p.h = h; p.w = w; p.cx = cx; p.cl = cl; p.cout = cout;
  p.ho = ho; p.wo = wo; p.pad_top = pad_top; p.pad_left = pad_left;
  p.cx_p = upsample ? (cx + kUpBK - 1) / kUpBK * kUpBK : (cx + 7) / 8 * 8;
  p.cl_p = (cl + 7) / 8 * 8;
  p.tiles_x = (wo + kUpTW - 1) / kUpTW;
  p.copy16 = cx % (in_dtype == 1 ? 8 : 4) == 0;
  const int m_total = ho * wo;
  const int mtiles = upsample ? (ho + bm / kUpTW - 1) / (bm / kUpTW) * p.tiles_x
                              : (m_total + bm - 1) / bm;
  cudaError_t err;
  if (upsample && in_dtype == 1)
    err = launch_up_tile<__nv_bfloat16>(p, batch, bm, bn, mtiles, st);
  else if (upsample && in_dtype == 0)
    err = launch_up_tile<float>(p, batch, bm, bn, mtiles, st);
  else if (upsample)
    err = cudaErrorInvalidValue;
  else if (stride == 1)
    err = launch_tc_route<1>(p, in_dtype, batch, bm, bn, st);
  else
    err = launch_tc_route<2>(p, in_dtype, batch, bm, bn, st);
  if (err != cudaSuccess) return (int)err;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* iv = static_cast<float*>(inv);
  if (out_dtype == 0)
    err = launch_apply<float>(p.y, p.partials, sc, bi, a, yn, iv, batch, m_total, cout, groups,
                              mtiles, rows_per_chunk, eps, st);
  else if (out_dtype == 1)
    err = launch_apply<__nv_bfloat16>(p.y, p.partials, sc, bi, a, yn, iv, batch, m_total,
                                      cout, groups, mtiles, rows_per_chunk, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

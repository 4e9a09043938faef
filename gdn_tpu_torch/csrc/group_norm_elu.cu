// GroupNorm + ELU forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel gdn_tpu/kernels/groupnorm.py::fused_group_norm_elu
// (the pl.pallas_call at line 133): per-image GroupNorm moments in fp32,
// normalize, affine, ELU, one write in the input dtype.
//
// What bounds it: memory.  Each element takes ~10 flops against 2 bytes
// (bf16) of traffic, far below the card's ~295 operations per byte, so
// the least time is 2 * B*H*W*C*itemsize bytes over 3.35 TB/s.  At the
// serving batch of 8 the 21 GN sites of the KITTI G-net hold ~53 M
// elements: ~213 MB of bf16 traffic per forward, ~64 us at peak.
//
// Design: two launches.  The TPU kernel walks a sequential grid over
// images and keeps each image in VMEM for its two passes; blocks on a GPU
// run in no order and an image (up to 1.7 MB here) does not fit one SM,
// so the statistics need a pass of their own:
//   1. gn_stats: grid (chunks, B).  Each block reads rows_per_chunk full
//      NHWC rows (all C channels, coalesced 16-byte loads), reduces per
//      channel in registers then in shared memory in a fixed order, folds
//      channels into groups and writes fp32 partials (B, G, chunks, 2).
//      No atomics: the result is deterministic.
//   2. gn_apply: the same grid.  Each block folds the partials of its
//      image into per-group mean and inverse std, then normalizes its
//      rows: y = elu((x - mean) * inv * scale + bias), fp32 math, one
//      store in the input dtype.
// The second read of x mostly hits the 50 MB L2 at these sizes (the
// largest site is 13.6 MB in bf16), so DRAM traffic stays near 2x.
//
// Layout: x and out are (B, HW, C) contiguous (channels_last NCHW);
// scale and bias are fp32 (C,).  A thread owns VEC consecutive channels of
// a row: blockDim = (C / VEC, rows in flight).  The wrapper checks
// C % VEC == 0, 16-byte alignment for VEC > 1, and C / VEC <= 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 1024;
constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ partials,
                         int hw, int c, int groups, int rows_per_chunk) {
  __shared__ float s1[kThreads * 8];  // (blockDim.y, C) per-thread channel sums
  __shared__ float s2[kThreads * 8];
  __shared__ float c1[kMaxC];  // per-channel block sums
  __shared__ float c2[kMaxC];
  const int chunk = blockIdx.x, b = blockIdx.y, chunks = gridDim.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, hw);
  float a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) { a1[i] = 0.f; a2[i] = 0.f; }
  const T* img = x + (size_t)b * hw * c;
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(img + (size_t)r * c + threadIdx.x * V);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float f = to_f32(p.v[i]);
      a1[i] += f;
      a2[i] += f * f;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s1[threadIdx.y * c + threadIdx.x * V + i] = a1[i];
    s2[threadIdx.y * c + threadIdx.x * V + i] = a2[i];
  }
  __syncthreads();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int ch = tid; ch < c; ch += nthreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) {
      t1 += s1[y * c + ch];
      t2 += s2[y * c + ch];
    }
    c1[ch] = t1;
    c2[ch] = t2;
  }
  __syncthreads();
  const int cg = c / groups;
  for (int g = tid; g < groups; g += nthreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      t1 += c1[g * cg + j];
      t2 += c2[g * cg + j];
    }
    float* dst = partials + (((size_t)b * groups + g) * chunks + chunk) * 2;
    dst[0] = t1;
    dst[1] = t2;
  }
}

template <typename T, int V>
__global__ void gn_apply(const T* __restrict__ x, const float* __restrict__ partials,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         T* __restrict__ out, int hw, int c, int groups,
                         int rows_per_chunk, float eps) {
  __shared__ float mean_g[kMaxC];
  __shared__ float inv_g[kMaxC];
  __shared__ float mean_c[kMaxC];
  __shared__ float mul_c[kMaxC];  // inv * scale
  __shared__ float add_c[kMaxC];  // bias
  const int chunk = blockIdx.x, b = blockIdx.y, chunks = gridDim.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  // Only full warps fold (the shuffles below take all 32 lanes); a block
  // has at least 129 threads, so at least 4 of them.
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int cg = c / groups;
  const float n = (float)hw * (float)cg;
  // Fold this image's chunk partials, one warp per group, fixed order.
  for (int g = warp; warp < nwarps && g < groups; g += nwarps) {
    const float* src = partials + ((size_t)b * groups + g) * chunks * 2;
    float t1 = 0.f, t2 = 0.f;
    for (int k = lane; k < chunks; k += 32) {
      t1 += src[2 * k];
      t2 += src[2 * k + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    if (lane == 0) {
      const float mean = t1 / n;
      // clamp: cancellation can dip below zero and rsqrt would give NaN
      const float var = fmaxf(t2 / n - mean * mean, 0.f);
      mean_g[g] = mean;
      inv_g[g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += nthreads) {
    mean_c[ch] = mean_g[ch / cg];
    mul_c[ch] = inv_g[ch / cg] * scale[ch];
    add_c[ch] = bias[ch];
  }
  __syncthreads();
  const int c0 = threadIdx.x * V;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(r0 + rows_per_chunk, hw);
  const size_t base = (size_t)b * hw * c;
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const size_t off = base + (size_t)r * c + c0;
    Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(x + off);
    Pack<T, V> q;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float z = (to_f32(p.v[i]) - mean_c[c0 + i]) * mul_c[c0 + i] + add_c[c0 + i];
      q.v[i] = from_f32<T>(z > 0.f ? z : expm1f(z));
    }
    *reinterpret_cast<Pack<T, V>*>(out + off) = q;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* out,
                   float* partials, int batch, int hw, int c, int groups,
                   int rows_per_chunk, int chunks, float eps, cudaStream_t stream) {
  const int px = c / V;
  dim3 block(px, px >= kThreads ? 1 : kThreads / px);
  dim3 grid(chunks, batch);
  gn_stats<T, V><<<grid, block, 0, stream>>>(static_cast<const T*>(x), partials, hw, c,
                                             groups, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, V><<<grid, block, 0, stream>>>(static_cast<const T*>(x), partials, scale,
                                             bias, static_cast<T*>(out), hw, c, groups,
                                             rows_per_chunk, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per thread load (1, or
// 16 bytes' worth: 4 for float32, 8 for bfloat16).  Returns a cudaError_t.
extern "C" int gn_elu_forward(const void* x, const void* scale, const void* bias,
                              void* out, void* partials, int batch, int hw, int c,
                              int groups, int rows_per_chunk, int chunks, float eps,
                              int dtype, int vec, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c > kMaxC || c % groups != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return (int)launch<float, 4>(x, s, bi, out, part, batch, hw, c, groups,
                                 rows_per_chunk, chunks, eps, st);
  if (dtype == 0 && vec == 1)
    return (int)launch<float, 1>(x, s, bi, out, part, batch, hw, c, groups,
                                 rows_per_chunk, chunks, eps, st);
  if (dtype == 1 && vec == 8)
    return (int)launch<__nv_bfloat16, 8>(x, s, bi, out, part, batch, hw, c, groups,
                                         rows_per_chunk, chunks, eps, st);
  if (dtype == 1 && vec == 1)
    return (int)launch<__nv_bfloat16, 1>(x, s, bi, out, part, batch, hw, c, groups,
                                         rows_per_chunk, chunks, eps, st);
  return (int)cudaErrorInvalidValue;
}

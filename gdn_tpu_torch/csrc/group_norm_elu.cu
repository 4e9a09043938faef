// GroupNorm + ELU forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel gdn_tpu/kernels/groupnorm.py::fused_group_norm_elu
// (the pl.pallas_call at line 133): per-image GroupNorm moments in fp32
// (single pass, variance clamped at 0), normalize, affine, ELU in fp32, one
// store in the input dtype; also the fp32 (B, 2, G) mean and inverse std.
//
// What bounds it: memory.  Each element takes ~10 flops against 2 bytes
// (bf16) of traffic, far below the card's ~295 operations per byte, so the
// least time is 2 * B*H*W*C*itemsize bytes over 3.35 TB/s.  At the serving
// batch of 8 the 21 GN sites of the KITTI G-net hold ~53 M elements: ~213 MB
// of bf16 traffic per forward, ~64 us at peak.  Most sites are small (16 of
// them hold <= 6.8 MB), so a call's latency counts as much as its bytes.
//
// Design: one cooperative launch.  The TPU kernel walks a sequential grid
// over images and keeps each image in VMEM for its two passes.  Here every
// block of a grid sized to what is resident on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, so that the grid
// barrier cannot deadlock) owns slabs: `rows` consecutive NHWC rows (all C
// channels) of one image, contiguous in memory.
//   1. The block copies its slab into shared memory with 16-byte cp.async,
//      all of it issued before any use, so a whole slab is in flight.
//   2. It sums the slab per channel (each thread fixed on V channels, rows
//      strided; then shuffles across the rows a warp holds and the warps in
//      order), then per group (a warp per group), and writes the slab's
//      (G, 2) partial.  No atomics: every sum has a fixed order, the
//      result is deterministic.
//   3. grid.sync().
//   4. For each of its slabs, the block folds the partials of the slab's
//      image in a fixed order (a warp per group), so every block derives the
//      same mean and inverse std; the block of slab 0 writes them to stats.
//      It normalizes the slab from shared memory and stores it once.
// Held: where the grid has a block for every slab (every B=8 serving site:
// the largest, 32 x 128 x 416, is 27.3 MB in bf16, 3.4 MB an image, against
// ~28 MB of shared memory at two blocks an SM), the slab stays in shared
// memory across the barrier and x is read once.  Streamed: otherwise (the
// 128 x 416 training sites at B=32, 109 and 54 MB) a block walks several
// slabs, summing each before the barrier and reading it again after it:
// two reads and one write, in one launch.  Its slab space is then two
// buffers, the next slab's copy in flight while the block works on the
// current one; the second pass walks the slabs backwards, so the last slab
// of the first pass is still in shared memory and the next ones are the
// likeliest to be in L2.  kernels/groupnorm.py::gn_plan picks rows, slabs
// per image and the grid (one block an SM where that holds the tensor,
// which ran the small sites faster on the H100 than two); the wrapper
// passes them in.
//
// Split form (gn_rows_sums, gn_rows_apply): for an image whose rows are
// sharded over ranks (spatial parallelism), the statistics are the whole
// image's.  The first kernel writes each slab's per-group (sum, sum of
// squares); the caller sums each image's slabs and all-reduces those sums
// over the ranks (one shape on every rank, whatever its rows); the second
// folds an image's `fold` entries of them in a fixed order (the cooperative
// kernel's fold, with n the whole image's count), writes the stats and
// normalizes its slab.  Neither
// stages in shared memory: x is read twice and out written once, as in the
// streamed plan.
//
// Layout: x and out are (B, HW, C) contiguous (channels_last NCHW); scale
// and bias are fp32 (C,).  A thread owns VEC consecutive channels of a row:
// blockDim = (C / VEC, rows at once).  Dynamic shared memory: the slab
// (slab_bytes), then by*C fp32 for the block's channel sums, then 2*G fp32
// for the image's group statistics.  The wrapper checks C % VEC == 0,
// 16-byte alignment for VEC > 1, and C <= 1024.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxC = 1024;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Issue the copies of one slab (n elements, contiguous in x) into buf as one
// cp.async group; the scalar route copies at once.
template <typename T, int V>
__device__ __forceinline__ void issue(T* buf, const T* src, int n, int tid, int nthreads) {
  if (V > 1) {  // V elements are 16 bytes; n is a multiple of C, C of V
    char* d = reinterpret_cast<char*>(buf);
    const char* s = reinterpret_cast<const char*>(src);
    for (int i = tid; i < n / V; i += nthreads) cp_async16(d + 16 * i, s + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = tid; i < n; i += nthreads) buf[i] = src[i];
  }
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elu((x - mean) * mul + add) in fp32, one rounding to T (bf16 in pairs).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> normalize(const Pack<T, V>& p, const float (&mean)[V],
                                                const float (&mul)[V], const float (&add)[V]) {
  float z[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float v = (to_f32(p.v[i]) - mean[i]) * mul[i] + add[i];
    z[i] = v > 0.f ? v : __expf(v) - 1.f;  // exp(v) - 1 as the TPU kernel; v <= 0
  }
  Pack<T, V> q;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 2)
      reinterpret_cast<__nv_bfloat162*>(q.v)[i / 2] = __floats2bfloat162_rn(z[i], z[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) q.v[i] = from_f32<T>(z[i]);
  }
  return q;
}

// The block's per-channel sum of a[V] over its rows, into red[0, C), in a
// fixed order.  Where a warp holds whole rows (C / V divides 32), shuffles
// first add the warp's rows; red then holds one row per warp, else one per
// threadIdx.y; a thread per channel adds them in order.
template <int V>
__device__ __forceinline__ void channel_sums(const float (&a)[V], float* red, int c) {
  const int px = blockDim.x, by = blockDim.y, tx = threadIdx.x;
  const int tid = threadIdx.y * px + tx, nthreads = px * by;
  int nrow = by;
  if (px < 32 && 32 % px == 0 && nthreads % 32 == 0) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = a[i];
    for (int off = px; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
    nrow = nthreads / 32;
    if ((tid & 31) < px) {  // the warp's first row: lane == tx
#pragma unroll
      for (int i = 0; i < V; ++i) red[(tid >> 5) * c + tx * V + i] = v[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) red[threadIdx.y * c + tx * V + i] = a[i];
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += nthreads) {
    float t = 0.f;
    for (int y = 0; y < nrow; ++y) t += red[y * c + ch];
    red[ch] = t;  // only this thread reads column ch
  }
  __syncthreads();
}

// The per-group sums of the channel sums red[0, C) into dst[0], dst[2], ...:
// a warp per group, lanes over its channels, then shuffles (a fixed order).
// Only full warps take part.
__device__ __forceinline__ void group_sums(const float* red, int cgs, int groups, float* dst) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x * blockDim.y >> 5;
  for (int g = warp; warp < nwarps && g < groups; g += nwarps) {
    float t = 0.f;
    for (int j = lane; j < cgs; j += 32) t += red[g * cgs + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) dst[2 * g] = t;
  }
}

// A block has C / V threads across and at most 256 in all, except with
// V == 1 where C / V may reach 1024.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256, 1)
gn_elu_coop(const T* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, T* __restrict__ out,
            float* __restrict__ partials, float* __restrict__ stats, int batch, int hw,
            int c, int groups, int rows, int spi, int slab_bytes, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + slab_bytes);  // (by, C)
  float* gst = red + blockDim.y * c;                         // mean (G), inv (G)
  const int px = blockDim.x, by = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * px + tx, nthreads = px * by;
  const int cg_ = c / groups, c0 = tx * V;
  const int total = batch * spi;
  // Held: one slab a block, kept in shared memory across the barrier.
  // Streamed: two buffers of half the slab space, the next slab's copy in
  // flight while the block works on the current one.
  const bool held = gridDim.x >= total;
  T* const buf0 = reinterpret_cast<T*>(smem);
  T* const buf1 = reinterpret_cast<T*>(smem + (held ? 0 : slab_bytes / 2 / 16 * 16));
  auto buf = [&](int k) { return k ? buf1 : buf0; };  // not an array: no local memory
  const int m = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto slab_src = [&](int i) {  // the block's i-th slab
    const int s = blockIdx.x + i * gridDim.x;
    return x + ((size_t)(s / spi) * hw + (s % spi) * rows) * c;
  };
  auto slab_rows = [&](int i) {
    return min(rows, hw - ((blockIdx.x + i * gridDim.x) % spi) * rows);
  };

  int cur = 0;
  if (m > 0) issue<T, V>(buf(0), slab_src(0), slab_rows(0) * c, tid, nthreads);
  for (int i = 0; i < m; ++i) {
    if (i + 1 < m) {
      issue<T, V>(buf(cur ^ 1), slab_src(i + 1), slab_rows(i + 1) * c, tid, nthreads);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const T* slab = buf(cur);
    const int nr = slab_rows(i);
    float a1[V], a2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) { a1[k] = 0.f; a2[k] = 0.f; }
    for (int r = ty; r < nr; r += by) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(slab + r * c + c0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(p.v[k]);
        a1[k] += f;
        a2[k] += f * f;
      }
    }
    float* dst = partials + (size_t)(blockIdx.x + i * gridDim.x) * groups * 2;
    channel_sums<V>(a1, red, c);
    group_sums(red, cg_, groups, dst);
    __syncthreads();  // red is refilled
    channel_sums<V>(a2, red, c);
    group_sums(red, cg_, groups, dst + 1);
    __syncthreads();  // this buffer and red are refilled next
    cur ^= 1;
  }

  // The second pass walks the slabs backwards: the last one is still in
  // shared memory (buf(cur ^ 1)), the one before it is fetched across the
  // barrier, and the most recent ones are the likeliest to be in L2.
  int hold = cur ^ 1;
  if (m >= 2) issue<T, V>(buf(cur), slab_src(m - 2), slab_rows(m - 2) * c, tid, nthreads);

  cg::this_grid().sync();

  // Only full warps fold (the shuffles take all 32 lanes); a block has at
  // least 252 threads, so at least 7 of them.
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float n = (float)hw * (float)cg_;
  for (int i = m - 1; i >= 0; --i) {
    if (i >= 1 && i < m - 1)
      issue<T, V>(buf(hold ^ 1), slab_src(i - 1), slab_rows(i - 1) * c, tid, nthreads);
    const int s = blockIdx.x + i * gridDim.x;
    const int b = s / spi, k = s % spi;
    for (int g = warp; warp < nwarps && g < groups; g += nwarps) {
      const float* src = partials + (size_t)b * spi * groups * 2 + 2 * g;
      float t1 = 0.f, t2 = 0.f;
      for (int j = lane; j < spi; j += 32) {
        t1 += __ldcg(src + (size_t)j * groups * 2);
        t2 += __ldcg(src + (size_t)j * groups * 2 + 1);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
        t2 += __shfl_xor_sync(0xffffffffu, t2, off);
      }
      if (lane == 0) {
        const float mean = t1 / n;
        // clamp: cancellation can dip below zero and rsqrt would give NaN
        const float inv = rsqrtf(fmaxf(t2 / n - mean * mean, 0.f) + eps);
        gst[g] = mean;
        gst[groups + g] = inv;
        if (k == 0) {
          stats[(size_t)b * 2 * groups + g] = mean;
          stats[((size_t)b * 2 + 1) * groups + g] = inv;
        }
      }
    }
    if (i < m - 1) {  // slab i's copy is in flight, slab i - 1's after it
      if (i >= 1)
        wait_copies<1>();
      else
        wait_copies<0>();
    }
    __syncthreads();
    float mean_c[V], mul_c[V], add_c[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = c0 + j, g = ch / cg_;
      mean_c[j] = gst[g];
      mul_c[j] = gst[groups + g] * scale[ch];
      add_c[j] = bias[ch];
    }
    const T* slab = buf(hold);
    const int nr = slab_rows(i);
    T* dst = out + ((size_t)b * hw + k * rows) * c + c0;
    for (int r = ty; r < nr; r += by)
      *reinterpret_cast<Pack<T, V>*>(dst + (size_t)r * c) = normalize<T, V>(
          *reinterpret_cast<const Pack<T, V>*>(slab + r * c + c0), mean_c, mul_c, add_c);
    __syncthreads();  // gst and this buffer are refilled next
    hold ^= 1;
  }
}

// Split form, first half: slab s = blockIdx.x (image s / spi, rows
// [(s % spi) * rows, +rows)) writes its (G, 2) per-group sums to partials.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256, 1)
gn_rows_sums(const T* __restrict__ x, float* __restrict__ partials, int hw, int c,
             int groups, int rows, int spi) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // (by, C)
  const int by = blockDim.y, c0 = threadIdx.x * V;
  const int s = blockIdx.x, b = s / spi, k = s % spi;
  const int nr = min(rows, hw - k * rows);
  const T* src = x + ((size_t)b * hw + (size_t)k * rows) * c + c0;
  float a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) { a1[i] = 0.f; a2[i] = 0.f; }
  for (int r = threadIdx.y; r < nr; r += by) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(src + (size_t)r * c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f32(p.v[i]);
      a1[i] += f;
      a2[i] += f * f;
    }
  }
  float* dst = partials + (size_t)s * groups * 2;
  channel_sums<V>(a1, red, c);
  group_sums(red, c / groups, groups, dst);
  __syncthreads();  // red is refilled
  channel_sums<V>(a2, red, c);
  group_sums(red, c / groups, groups, dst + 1);
}

// Split form, second half: slab blockIdx.x folds its image's `fold` partial
// sums (already summed over the ranks) in a fixed order, with n elements a
// group in the whole image, and normalizes its rows.  The image's slab 0
// writes the (B, 2, G) stats.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256, 1)
gn_rows_apply(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, const float* __restrict__ partials,
              T* __restrict__ out, float* __restrict__ stats, int hw, int c, int groups,
              int rows, int spi, int fold, float n, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gst = reinterpret_cast<float*>(smem);  // mean (G), inv (G)
  const int px = blockDim.x, by = blockDim.y, c0 = threadIdx.x * V;
  const int tid = threadIdx.y * px + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = px * by >> 5, cg_ = c / groups;
  const int s = blockIdx.x, b = s / spi, k = s % spi;
  for (int g = warp; warp < nwarps && g < groups; g += nwarps) {
    const float* src = partials + (size_t)b * fold * groups * 2 + 2 * g;
    float t1 = 0.f, t2 = 0.f;
    for (int j = lane; j < fold; j += 32) {
      t1 += src[(size_t)j * groups * 2];
      t2 += src[(size_t)j * groups * 2 + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    if (lane == 0) {
      const float mean = t1 / n;
      const float inv = rsqrtf(fmaxf(t2 / n - mean * mean, 0.f) + eps);
      gst[g] = mean;
      gst[groups + g] = inv;
      if (k == 0) {
        stats[(size_t)b * 2 * groups + g] = mean;
        stats[((size_t)b * 2 + 1) * groups + g] = inv;
      }
    }
  }
  __syncthreads();
  float mean_c[V], mul_c[V], add_c[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = c0 + j, g = ch / cg_;
    mean_c[j] = gst[g];
    mul_c[j] = gst[groups + g] * scale[ch];
    add_c[j] = bias[ch];
  }
  const int nr = min(rows, hw - k * rows);
  const size_t base = ((size_t)b * hw + (size_t)k * rows) * c + c0;
  for (int r = threadIdx.y; r < nr; r += by)
    *reinterpret_cast<Pack<T, V>*>(out + base + (size_t)r * c) = normalize<T, V>(
        *reinterpret_cast<const Pack<T, V>*>(x + base + (size_t)r * c), mean_c, mul_c, add_c);
}

// Dynamic shared memory above 48 KB needs the attribute; set once a device
// to the block's limit, so that any plan's size launches.
template <typename T, int V>
cudaError_t allow_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gn_elu_coop<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int V>
cudaError_t occupancy(int threads, int dyn, int* blocks) {
  cudaError_t err = allow_smem<T, V>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gn_elu_coop<T, V>, threads, dyn);
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* out,
                   void* partials, void* stats, int batch, int hw, int c, int groups,
                   int rows, int spi, int grid, int px, int by, int slab_bytes, int dyn,
                   float eps, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, V>();
  if (err != cudaSuccess) return err;
  void* args[] = {&x, &scale, &bias, &out, &partials, &stats, &batch, &hw, &c,
                  &groups, &rows, &spi, &slab_bytes, &eps};
  return cudaLaunchCooperativeKernel((const void*)gn_elu_coop<T, V>,
                                     dim3(grid), dim3(px, by), args, (size_t)dyn, stream);
}

}  // namespace

// The current device: info = [SMs, shared memory per SM, shared memory the
// runtime reserves per block, dynamic shared memory a block may opt in to,
// cooperative launch supported].  Returns a cudaError_t.
extern "C" int gn_elu_device(int* info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrCooperativeLaunch};
  for (int i = 0; i < 5 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(&info[i], attrs[i], dev);
  return (int)err;
}

// Blocks of threads threads and dyn bytes of dynamic shared memory that one
// SM holds at once, for the kernel of (dtype, vec).  Returns a cudaError_t.
extern "C" int gn_elu_occupancy(int dtype, int vec, int threads, int dyn, int* blocks) {
  if (dtype == 0 && vec == 4) return (int)occupancy<float, 4>(threads, dyn, blocks);
  if (dtype == 0 && vec == 1) return (int)occupancy<float, 1>(threads, dyn, blocks);
  if (dtype == 1 && vec == 8) return (int)occupancy<__nv_bfloat16, 8>(threads, dyn, blocks);
  if (dtype == 1 && vec == 1) return (int)occupancy<__nv_bfloat16, 1>(threads, dyn, blocks);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per thread load (1, or
// 16 bytes' worth: 4 for float32, 8 for bfloat16).  partials: fp32
// (B * spi, G, 2) scratch; stats: fp32 (B, 2, G) out.  A cooperative
// launch the card refuses (a grid beyond what is resident) returns its
// error.  Returns a cudaError_t.
extern "C" int gn_elu_forward(const void* x, const void* scale, const void* bias, void* out,
                              void* partials, void* stats, int batch, int hw, int c,
                              int groups, int rows, int spi, int grid, int px, int by,
                              int slab_bytes, int dyn, float eps, int dtype, int vec,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c > kMaxC || groups < 1 || c % groups != 0 || px * vec != c || px * by > 1024 ||
      rows < 1 || spi < 1 || (long long)rows * spi < hw || grid < 1 ||
      rows * c * (dtype ? 2 : 4) > (grid >= batch * spi ? slab_bytes : slab_bytes / 2 / 16 * 16) ||
      slab_bytes % 16 != 0 || dyn < slab_bytes + 4 * (by * c + 2 * groups))
    return (int)cudaErrorInvalidValue;
#define GN_LAUNCH(T, V)                                                                    \
  return (int)launch<T, V>(x, scale, bias, out, partials, stats, batch, hw, c, groups, rows, \
                           spi, grid, px, by, slab_bytes, dyn, eps, st)
  if (dtype == 0 && vec == 4) GN_LAUNCH(float, 4);
  if (dtype == 0 && vec == 1) GN_LAUNCH(float, 1);
  if (dtype == 1 && vec == 8) GN_LAUNCH(__nv_bfloat16, 8);
  if (dtype == 1 && vec == 1) GN_LAUNCH(__nv_bfloat16, 1);
#undef GN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The split form's two launches (see the header).  gn_rows_sums writes
// partials, fp32 (B * spi, G, 2); gn_rows_apply reads fp32 (B * fold, G, 2)
// sums, summed over the ranks (the caller's fold of the partials: fold 1);
// n: elements of one group in the whole image.  Each returns a cudaError_t.
static bool rows_args_ok(int batch, int hw, int c, int groups, int rows, int spi, int px,
                         int by, int vec) {
  return batch >= 1 && hw >= 1 && c <= kMaxC && groups >= 1 && c % groups == 0 &&
         px * vec == c && px * by <= 1024 && px * by >= 32 && rows >= 1 &&
         spi >= 1 && (long long)rows * (spi - 1) < hw && (long long)rows * spi >= hw;
}

extern "C" int gn_rows_sums(const void* x, void* partials, int batch, int hw, int c,
                            int groups, int rows, int spi, int px, int by, int dtype, int vec,
                            void* stream) {
  if (!rows_args_ok(batch, hw, c, groups, rows, spi, px, by, vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch * spi), block(px, by);
  const size_t dyn = 4 * (size_t)by * c;
#define GN_SUMS(T, V)                                                                    \
  gn_rows_sums<T, V><<<grid, block, dyn, st>>>(static_cast<const T*>(x),                  \
                                               static_cast<float*>(partials), hw, c,      \
                                               groups, rows, spi);                        \
  return (int)cudaGetLastError()
  if (dtype == 0 && vec == 4) { GN_SUMS(float, 4); }
  if (dtype == 0 && vec == 1) { GN_SUMS(float, 1); }
  if (dtype == 1 && vec == 8) { GN_SUMS(__nv_bfloat16, 8); }
  if (dtype == 1 && vec == 1) { GN_SUMS(__nv_bfloat16, 1); }
#undef GN_SUMS
  return (int)cudaErrorInvalidValue;
}

extern "C" int gn_rows_apply(const void* x, const void* scale, const void* bias,
                             const void* partials, void* out, void* stats, int batch, int hw,
                             int c, int groups, int rows, int spi, int fold, int px, int by,
                             float n, float eps, int dtype, int vec, void* stream) {
  if (!rows_args_ok(batch, hw, c, groups, rows, spi, px, by, vec) || fold < 1 || !(n > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch * spi), block(px, by);
  const size_t dyn = 8 * (size_t)groups;
#define GN_APPLY(T, V)                                                                   \
  gn_rows_apply<T, V><<<grid, block, dyn, st>>>(                                          \
      static_cast<const T*>(x), static_cast<const float*>(scale),                         \
      static_cast<const float*>(bias), static_cast<const float*>(partials),               \
      static_cast<T*>(out), static_cast<float*>(stats), hw, c, groups, rows, spi, fold, n,  \
      eps);                                                                                \
  return (int)cudaGetLastError()
  if (dtype == 0 && vec == 4) { GN_APPLY(float, 4); }
  if (dtype == 0 && vec == 1) { GN_APPLY(float, 1); }
  if (dtype == 1 && vec == 8) { GN_APPLY(__nv_bfloat16, 8); }
  if (dtype == 1 && vec == 1) { GN_APPLY(__nv_bfloat16, 1); }
#undef GN_APPLY
  return (int)cudaErrorInvalidValue;
}

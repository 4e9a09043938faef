// GroupNorm + ELU forward and backward for Hopper (sm_90a), plain C interface
// for ctypes.  The backward (gn_elu_bwd_coop) has its own note further down.
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
// image's, so the all-reduce of the sums over the ranks comes between two
// ordinary launches.  Both take a grid of what the card holds at once
// (kernels/groupnorm.py::rows_plan), each block walking several slabs of
// at least kRowsUnroll rows a thread row, the loads of kRowsUnroll rows in
// flight at once.  The first kernel reduces each slab's two moments in one
// barrier round and writes its per-group (sum, sum of squares); the block
// that finishes an image's last slab (a ticket from a per-image counter,
// after a __threadfence: CUDA's threadfence reduction) folds the image's
// slab partials in slab order into one (B, G, 2) tensor, the same shape on
// every rank whatever its rows.  The second kernel derives the mean and
// inverse std with n the whole image's count, writes the stats and
// normalizes, walking the slabs in the reverse of the first kernel's order
// so that the rows still in L2 are read again first.  Neither stages in
// shared memory: x is read twice and out written once.
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

// V fp32 values rounded once to T (bf16 in pairs).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> pack(const float (&z)[V]) {
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

// elu((x - mean) * mul + add) in fp32, one rounding to T.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> normalize(const Pack<T, V>& p, const float (&mean)[V],
                                                const float (&mul)[V], const float (&add)[V]) {
  float z[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float v = (to_f32(p.v[i]) - mean[i]) * mul[i] + add[i];
    z[i] = v > 0.f ? v : __expf(v) - 1.f;  // exp(v) - 1 as the TPU kernel; v <= 0
  }
  return pack<T, V>(z);
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

// Split form.  One slab s (image s / spi, rows [(s % spi) * rows, +rows))
// at a time; a block walks slabs blockIdx.x, + gridDim.x, ... (the grid is
// what the card holds at once, kernels/groupnorm.py::rows_plan).  Each
// thread keeps kRowsUnroll loads of V elements in flight: rows r, r + by,
// ... of the slab in one unrolled trip.  kRowsMinBlocks: the blocks of
// 256 threads an SM that __launch_bounds__ asks the register allocation to
// leave room for (scripts/split_gn_variants_torch.py times the choices).
constexpr int kRowsUnroll = 4;
constexpr int kRowsMinBlocks = 1;

// Rows of the block's reduction buffer (each 2C fp32 wide): one a warp
// where a warp holds whole rows (C / V divides 32), else one a threadIdx.y.
__host__ __device__ __forceinline__ int red_rows(int px, int by) {
  return px < 32 && 32 % px == 0 && (px * by) % 32 == 0 ? px * by / 32 : by;
}

// Both moments' per-channel block sums in one barrier round: a1 into
// red[0, C), a2 into red[C, 2C), each in a fixed order (shuffles over the
// rows a warp holds, then the buffer's rows in order).
template <int V>
__device__ __forceinline__ void block_sums(const float (&a1)[V], const float (&a2)[V],
                                           float* red, int c) {
  const int px = blockDim.x, by = blockDim.y, tx = threadIdx.x;
  const int tid = threadIdx.y * px + tx, nthreads = px * by;
  const int nrow = red_rows(px, by);
  float v1[V], v2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) { v1[i] = a1[i]; v2[i] = a2[i]; }
  int row = threadIdx.y;
  bool writes = true;
  if (nrow != by) {
    for (int off = px; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v1[i] += __shfl_xor_sync(0xffffffffu, v1[i], off);
        v2[i] += __shfl_xor_sync(0xffffffffu, v2[i], off);
      }
    }
    row = tid >> 5;
    writes = (tid & 31) < px;  // the warp's first row: lane == tx
  }
  if (writes) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[row * 2 * c + tx * V + i] = v1[i];
      red[row * 2 * c + c + tx * V + i] = v2[i];
    }
  }
  __syncthreads();
  for (int col = tid; col < 2 * c; col += nthreads) {
    float t = 0.f;
    for (int y = 0; y < nrow; ++y) t += red[y * 2 * c + col];
    red[col] = t;  // only this thread reads column col
  }
  __syncthreads();
}

// First half: each slab's (G, 2) per-group sums into partials; then a
// ticket from its image's counter (__threadfence, atomicAdd), and the
// block that takes the image's last ticket folds the image's spi partials
// in slab order into sums (B, G, 2), the tensor the all-reduce reads, and
// sets the counter back to 0 for the next call.  Every sum has a fixed
// order: which block folds does not change a bit.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256, V == 1 ? 1 : kRowsMinBlocks)
gn_rows_sums(const T* __restrict__ x, float* __restrict__ partials,
             float* __restrict__ sums, unsigned* __restrict__ count, int batch, int hw,
             int c, int groups, int rows, int spi) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // (red_rows, 2C)
  __shared__ unsigned ticket;
  const int px = blockDim.x, by = blockDim.y, ty = threadIdx.y, c0 = threadIdx.x * V;
  const int tid = ty * px + threadIdx.x, nthreads = px * by;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5, cg_ = c / groups;
  for (int s = blockIdx.x; s < batch * spi; s += gridDim.x) {
    const int b = s / spi, k = s % spi;
    const int nr = min(rows, hw - k * rows);
    const T* src = x + ((size_t)b * hw + (size_t)k * rows) * c + c0;
    float a1[V], a2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) { a1[i] = 0.f; a2[i] = 0.f; }
    for (int r0 = ty; r0 < nr; r0 += kRowsUnroll * by) {
      Pack<T, V> p[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        if (r0 + u * by < nr)
          p[u] = *reinterpret_cast<const Pack<T, V>*>(src + (size_t)(r0 + u * by) * c);
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        if (r0 + u * by < nr) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float f = to_f32(p[u].v[i]);
            a1[i] += f;
            a2[i] += f * f;
          }
        }
      }
    }
    block_sums<V>(a1, a2, red, c);
    // a warp per group, lanes over its channels (only full warps: shuffles)
    float* dst = partials + (size_t)s * groups * 2;
    for (int g = warp; warp < nwarps && g < groups; g += nwarps) {
      float t1 = 0.f, t2 = 0.f;
      for (int j = lane; j < cg_; j += 32) {
        t1 += red[g * cg_ + j];
        t2 += red[c + g * cg_ + j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
        t2 += __shfl_xor_sync(0xffffffffu, t2, off);
      }
      if (lane == 0) {
        dst[2 * g] = t1;
        dst[2 * g + 1] = t2;
      }
    }
    __threadfence();  // this slab's partial is visible before its ticket
    __syncthreads();  // (and red may be refilled after the next barrier)
    if (tid == 0) ticket = atomicAdd(count + b, 1u);
    __syncthreads();
    if (ticket == (unsigned)spi - 1) {
      __threadfence();
      const float* img = partials + (size_t)b * spi * groups * 2;
      for (int t = tid; t < 2 * groups; t += nthreads) {
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < spi; ++j) acc += __ldcg(img + (size_t)j * groups * 2 + t);
        sums[(size_t)b * groups * 2 + t] = acc;
      }
      if (tid == 0) count[b] = 0;
    }
  }
}

// Second half: the block walks its slabs in the reverse of the first
// half's order, and each slab's rows from the last, so the rows read last
// by the first half (the likeliest still in L2) are read first.  Each
// slab's image statistics come from the all-reduced sums (B, G, 2), with
// n elements a group in the whole image; the image's slab 0 writes them
// to stats (B, 2, G).
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256, V == 1 ? 1 : kRowsMinBlocks)
gn_rows_apply(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, const float* __restrict__ sums,
              T* __restrict__ out, float* __restrict__ stats, int batch, int hw, int c,
              int groups, int rows, int spi, float n, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gst = reinterpret_cast<float*>(smem);  // mean (G), inv (G)
  const int px = blockDim.x, by = blockDim.y, ty = threadIdx.y, c0 = threadIdx.x * V;
  const int tid = ty * px + threadIdx.x, nthreads = px * by, cg_ = c / groups;
  const int total = batch * spi;
  const int m = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int chunk = kRowsUnroll * by;
  for (int i = m - 1; i >= 0; --i) {
    const int s = blockIdx.x + i * gridDim.x, b = s / spi, k = s % spi;
    __syncthreads();  // gst is refilled
    for (int g = tid; g < groups; g += nthreads) {
      const float mean = sums[((size_t)b * groups + g) * 2] / n;
      // clamp: cancellation can dip below zero and rsqrt would give NaN
      const float inv =
          rsqrtf(fmaxf(sums[((size_t)b * groups + g) * 2 + 1] / n - mean * mean, 0.f) + eps);
      gst[g] = mean;
      gst[groups + g] = inv;
      if (k == 0) {
        stats[(size_t)b * 2 * groups + g] = mean;
        stats[((size_t)b * 2 + 1) * groups + g] = inv;
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
    for (int r0 = (nr - 1) / chunk * chunk + ty; r0 >= 0; r0 -= chunk) {
      Pack<T, V> p[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        if (r0 + u * by < nr)
          p[u] = *reinterpret_cast<const Pack<T, V>*>(x + base + (size_t)(r0 + u * by) * c);
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        if (r0 + u * by < nr)
          *reinterpret_cast<Pack<T, V>*>(out + base + (size_t)(r0 + u * by) * c) =
              normalize<T, V>(p[u], mean_c, mul_c, add_c);
    }
  }
}

// GroupNorm + ELU backward, one cooperative launch (gn_elu_bwd_coop).
//
// Replaces, on the card, the plain-PyTorch analytic backward
// ops/groupnorm.py::gn_elu_backward (about 38 launches a call, 17 of them
// full-tensor passes); the TPU had no kernel for it, only XLA's backward of
// the Pallas forward.  From the saved x, the forward's fp32 (B, 2, G) mean
// and inverse std and the cotangent da, all in fp32:
//   yn = (x - mean) * inv,  z = yn * scale + bias,
//   dz = da * (z > 0 ? 1 : exp(z)),
//   S1[b, c] = sum_hw dz,  S2[b, c] = sum_hw dz * yn,
//   m1[b, g] = sum_{c in g} scale_c S1[b, c] / n,  m2 likewise with S2,
//   dx = (dz * scale - m1 - yn * m2) * inv   (one store in x's dtype),
//   dscale = sum_b S2,  dbias = sum_b S1.
//
// What bounds it: memory, as the forward.  ~20 flops an element against
// 3 * itemsize bytes at the least (x and da read, dx written): a stage-2
// step at B=128 128x416 moves 852 M elements of the G-net's 21 sites, 1.53
// ms of bf16 at 3.35 TB/s.
//
// Design: the forward's, with two tensors staged a slab.  A grid of what
// the card holds at once (kernels/groupnorm.py::gn_plan on two rows' bytes
// a row, bwd_slab_capacity) walks slabs of one image's NHWC rows.
//   1. The block copies the slab's x and da rows into shared memory with
//      16-byte cp.async (da at any row pitch >= C: the channel slice of a
//      concat's gradient is read in place), sums dz and dz * yn per channel
//      in a fixed order (block_sums), and writes the slab's per-group sums
//      of scale_c * S (the m's numerators).  For the affine gradients it
//      also adds the slab's per-channel sums into a running (2, C) sum of
//      its own slabs, in slab order, written once after its last slab.
//   2. grid.sync().
//   3. Block b folds image b's slab partials in slab order into m1, m2
//      (coef, (B, G, 2)); block j folds column j of the blocks' running
//      sums in block order into dbias, dscale.  Every sum has a fixed
//      order: two calls give the same bits.
//   4. grid.sync().
//   5. Each block computes dx of its slabs, walking them in reverse: held
//      (a block per slab) from shared memory, so x and da are read once;
//      streamed (several slabs a block, two slab buffers, the next copy in
//      flight) the last slab from shared memory and the others read again,
//      the latest first (likeliest in L2).
// Shared memory: the slab space (slab_bytes; x's rows then da's, a buffer
// each half when streamed), then red_rows(px, by) * 2C fp32 for block_sums,
// 2C fp32 for the running sums, 32 fp32 for the fold's warp sums.
template <typename T, int V>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int nr, int c, int pitch) {
  const int c0 = threadIdx.x * V;
  for (int r = threadIdx.y; r < nr; r += blockDim.y) {
    if (V > 1)
      cp_async16(dst + r * c + c0, src + (size_t)r * pitch + c0);
    else
      dst[r * c + c0] = src[(size_t)r * pitch + c0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256, 1)
gn_elu_bwd_coop(const T* __restrict__ x, const T* __restrict__ da, int pitch,
                const float* __restrict__ stats, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ dx,
                float* __restrict__ partials, float* __restrict__ coef,
                float* __restrict__ blocksums, float* __restrict__ dsb, int batch, int hw,
                int c, int groups, int rows, int spi, int slab_bytes, int affine) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int px = blockDim.x, by = blockDim.y, ty = threadIdx.y, c0 = threadIdx.x * V;
  const int tid = ty * px + threadIdx.x, nthreads = px * by;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5, cg_ = c / groups;
  float* red = reinterpret_cast<float*>(smem + slab_bytes);  // (red_rows, 2C)
  float* acc = red + red_rows(px, by) * 2 * c;                 // (2C) running sums
  float* wsum = acc + 2 * c;                                   // (32) warp sums
  const int total = batch * spi;
  const bool held = gridDim.x >= total;
  T* const buf0 = reinterpret_cast<T*>(smem);
  T* const buf1 = reinterpret_cast<T*>(smem + (held ? 0 : slab_bytes / 2 / 16 * 16));
  auto buf = [&](int k) { return k ? buf1 : buf0; };  // not an array: no local memory
  const int m = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto slab_row = [&](int i) {  // the first NHWC row of the block's i-th slab
    const int s = blockIdx.x + i * gridDim.x;
    return (size_t)(s / spi) * hw + (s % spi) * rows;
  };
  auto slab_rows = [&](int i) {
    return min(rows, hw - ((blockIdx.x + i * gridDim.x) % spi) * rows);
  };
  auto stage = [&](int k, int i) {  // slab i's x and da into buffer k, one copy group
    copy_rows<T, V>(buf(k), x + slab_row(i) * c, slab_rows(i), c, c);
    copy_rows<T, V>(buf(k) + rows * c, da + slab_row(i) * pitch, slab_rows(i), c, pitch);
    if (V > 1) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the per-channel constants of an image: mean, inv, scale, bias
  float mean_c[V], inv_c[V], sc_c[V], bi_c[V];
  auto constants = [&](int b) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = c0 + j, g = ch / cg_;
      mean_c[j] = stats[(size_t)b * 2 * groups + g];
      inv_c[j] = stats[((size_t)b * 2 + 1) * groups + g];
      sc_c[j] = scale[ch];
      bi_c[j] = bias[ch];
    }
  };

  int cur = 0;
  if (m > 0) stage(0, 0);
  for (int i = 0; i < m; ++i) {
    if (i + 1 < m) {
      stage(cur ^ 1, i + 1);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int s = blockIdx.x + i * gridDim.x;
    constants(s / spi);
    const T* xs = buf(cur);
    const T* ds = xs + rows * c;
    const int nr = slab_rows(i);
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) { a1[j] = 0.f; a2[j] = 0.f; }
    for (int r = ty; r < nr; r += by) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xs + r * c + c0);
      const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(ds + r * c + c0);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float yn = (to_f32(p.v[j]) - mean_c[j]) * inv_c[j];
        const float z = yn * sc_c[j] + bi_c[j];
        const float dz = z > 0.f ? to_f32(q.v[j]) : to_f32(q.v[j]) * __expf(z);
        a1[j] += dz;
        a2[j] += dz * yn;
      }
    }
    block_sums<V>(a1, a2, red, c);  // red[0, C) = S1, red[C, 2C) = S2 of the slab
    float* dst = partials + (size_t)s * groups * 2;
    for (int g = warp; warp < nwarps && g < groups; g += nwarps) {
      float t1 = 0.f, t2 = 0.f;
      for (int j = lane; j < cg_; j += 32) {
        const float w = scale[g * cg_ + j];
        t1 += w * red[g * cg_ + j];
        t2 += w * red[c + g * cg_ + j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
        t2 += __shfl_xor_sync(0xffffffffu, t2, off);
      }
      if (lane == 0) {
        dst[2 * g] = t1;
        dst[2 * g + 1] = t2;
      }
    }
    if (affine)  // each column read and written by one thread: block_sums' own
      for (int col = tid; col < 2 * c; col += nthreads) acc[col] = (i ? acc[col] : 0.f) + red[col];
    __syncthreads();  // this buffer and red are refilled next
    cur ^= 1;
  }
  if (affine)
    for (int col = tid; col < 2 * c; col += nthreads)
      blocksums[(size_t)blockIdx.x * 2 * c + col] = m ? acc[col] : 0.f;

  // The second pass walks the slabs backwards: the last one is still in
  // shared memory (buf(cur ^ 1)), the one before it is fetched across the
  // barriers.
  int hold = cur ^ 1;
  if (m >= 2) stage(cur, m - 2);

  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // Fold: only full warps (the shuffles take all 32 lanes); a block has at
  // least 252 threads, so at least 7 of them.
  const float n = (float)hw * (float)cg_;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
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
        coef[((size_t)b * groups + g) * 2] = t1 / n;
        coef[((size_t)b * groups + g) * 2 + 1] = t2 / n;
      }
    }
  }
  if (affine) {
    for (int col = blockIdx.x; col < 2 * c; col += gridDim.x) {
      float t = 0.f;
      if (warp < nwarps)
        for (int k = tid; k < (int)gridDim.x; k += nwarps * 32)
          t += __ldcg(blocksums + (size_t)k * 2 * c + col);
      if (warp < nwarps) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
        if (lane == 0) wsum[warp] = t;
      }
      __syncthreads();
      if (tid == 0) {
        float u = 0.f;
        for (int w = 0; w < nwarps; ++w) u += wsum[w];
        dsb[col] = u;  // dbias (C), then dscale (C)
      }
      __syncthreads();  // wsum is refilled
    }
  }

  grid.sync();

  for (int i = m - 1; i >= 0; --i) {
    if (i >= 1 && i < m - 1) stage(hold ^ 1, i - 1);
    const int s = blockIdx.x + i * gridDim.x;
    const int b = s / spi;
    constants(b);
    float m1[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (c0 + j) / cg_;
      m1[j] = __ldcg(coef + ((size_t)b * groups + g) * 2);
      m2[j] = __ldcg(coef + ((size_t)b * groups + g) * 2 + 1);
    }
    if (i < m - 1) {  // slab i's copy is in flight, slab i - 1's after it
      if (i >= 1)
        wait_copies<1>();
      else
        wait_copies<0>();
    }
    __syncthreads();
    const T* xs = buf(hold);
    const T* ds = xs + rows * c;
    const int nr = slab_rows(i);
    T* out = dx + slab_row(i) * c + c0;
    for (int r = ty; r < nr; r += by) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xs + r * c + c0);
      const Pack<T, V> q = *reinterpret_cast<const Pack<T, V>*>(ds + r * c + c0);
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float yn = (to_f32(p.v[j]) - mean_c[j]) * inv_c[j];
        const float z = yn * sc_c[j] + bi_c[j];
        const float dz = z > 0.f ? to_f32(q.v[j]) : to_f32(q.v[j]) * __expf(z);
        v[j] = (dz * sc_c[j] - m1[j] - yn * m2[j]) * inv_c[j];
      }
      *reinterpret_cast<Pack<T, V>*>(out + (size_t)r * c) = pack<T, V>(v);
    }
    __syncthreads();  // this buffer is refilled next
    hold ^= 1;
  }
}

// Dynamic shared memory above 48 KB needs the attribute; set once a device
// to the block's limit, so that any plan's size launches.  Bwd: the
// backward kernel, else the forward.
template <typename T, int V, bool Bwd>
cudaError_t allow_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if constexpr (Bwd)
    err = cudaFuncSetAttribute(gn_elu_bwd_coop<T, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  else
    err = cudaFuncSetAttribute(gn_elu_coop<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int V, bool Bwd>
cudaError_t occupancy(int threads, int dyn, int* blocks) {
  cudaError_t err = allow_smem<T, V, Bwd>();
  if (err != cudaSuccess) return err;
  if constexpr (Bwd)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gn_elu_bwd_coop<T, V>,
                                                         threads, dyn);
  else
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gn_elu_coop<T, V>, threads,
                                                         dyn);
}

template <typename T, int V>
cudaError_t launch_bwd(const void* x, const void* da, int pitch, const void* stats,
                       const void* scale, const void* bias, void* dx, void* partials,
                       void* coef, void* blocksums, void* dsb, int batch, int hw, int c,
                       int groups, int rows, int spi, int grid, int px, int by, int slab_bytes,
                       int dyn, int affine, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, V, true>();
  if (err != cudaSuccess) return err;
  void* args[] = {&x,        &da,   &pitch, &stats, &scale,  &bias, &dx,  &partials,
                  &coef,     &blocksums, &dsb, &batch, &hw, &c, &groups, &rows,
                  &spi,      &slab_bytes, &affine};
  return cudaLaunchCooperativeKernel((const void*)gn_elu_bwd_coop<T, V>, dim3(grid),
                                     dim3(px, by), args, (size_t)dyn, stream);
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* out,
                   void* partials, void* stats, int batch, int hw, int c, int groups,
                   int rows, int spi, int grid, int px, int by, int slab_bytes, int dyn,
                   float eps, cudaStream_t stream) {
  cudaError_t err = allow_smem<T, V, false>();
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
  if (dtype == 0 && vec == 4) return (int)occupancy<float, 4, false>(threads, dyn, blocks);
  if (dtype == 0 && vec == 1) return (int)occupancy<float, 1, false>(threads, dyn, blocks);
  if (dtype == 1 && vec == 8)
    return (int)occupancy<__nv_bfloat16, 8, false>(threads, dyn, blocks);
  if (dtype == 1 && vec == 1)
    return (int)occupancy<__nv_bfloat16, 1, false>(threads, dyn, blocks);
  return (int)cudaErrorInvalidValue;
}

// The same for the backward kernel.
extern "C" int gn_elu_bwd_occupancy(int dtype, int vec, int threads, int dyn, int* blocks) {
  if (dtype == 0 && vec == 4) return (int)occupancy<float, 4, true>(threads, dyn, blocks);
  if (dtype == 0 && vec == 1) return (int)occupancy<float, 1, true>(threads, dyn, blocks);
  if (dtype == 1 && vec == 8) return (int)occupancy<__nv_bfloat16, 8, true>(threads, dyn, blocks);
  if (dtype == 1 && vec == 1) return (int)occupancy<__nv_bfloat16, 1, true>(threads, dyn, blocks);
  return (int)cudaErrorInvalidValue;
}

// The backward (see gn_elu_bwd_coop).  da: rows `pitch` elements apart
// (>= C; a multiple of vec, and 16-byte aligned with vec > 1).  work: fp32
// scratch of B * spi * 2G (slab partials), then B * 2G (m1, m2), then,
// with affine, grid * 2C (the blocks' running sums).  dsb: fp32 (2, C)
// out, dbias then dscale, written only with affine.  Returns a cudaError_t.
extern "C" int gn_elu_backward(const void* x, const void* da, int pitch, const void* stats,
                               const void* scale, const void* bias, void* dx, void* work,
                               void* dsb, int batch, int hw, int c, int groups, int rows,
                               int spi, int grid, int px, int by, int slab_bytes, int dyn,
                               int affine, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int item = dtype ? 2 : 4;
  const bool held = grid >= batch * spi;
  if (batch < 1 || hw < 1 || c > kMaxC || groups < 1 || c % groups != 0 || px * vec != c ||
      px * by > 1024 || rows < 1 || spi < 1 || (long long)rows * (spi - 1) >= hw ||
      (long long)rows * spi < hw || grid < 1 || grid > batch * spi || pitch < c ||
      pitch % vec != 0 ||
      2 * rows * c * item > (held ? slab_bytes : slab_bytes / 2 / 16 * 16) ||
      slab_bytes % 16 != 0 ||
      dyn < slab_bytes + 4 * (red_rows(px, by) * 2 * c + 2 * c + 32) || (affine && !dsb))
    return (int)cudaErrorInvalidValue;
  float* partials = static_cast<float*>(work);
  float* coef = partials + (size_t)batch * spi * groups * 2;
  float* blocksums = affine ? coef + (size_t)batch * groups * 2 : nullptr;
#define GN_BWD(T, V)                                                                       \
  return (int)launch_bwd<T, V>(x, da, pitch, stats, scale, bias, dx, partials, coef,        \
                               blocksums, dsb, batch, hw, c, groups, rows, spi, grid, px, by, \
                               slab_bytes, dyn, affine, st)
  if (dtype == 0 && vec == 4) GN_BWD(float, 4);
  if (dtype == 0 && vec == 1) GN_BWD(float, 1);
  if (dtype == 1 && vec == 8) GN_BWD(__nv_bfloat16, 8);
  if (dtype == 1 && vec == 1) GN_BWD(__nv_bfloat16, 1);
#undef GN_BWD
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
// partials, fp32 (B * spi, G, 2) scratch, and sums, fp32 (B, G, 2), with
// count, B zeroed unsigned counters that it leaves zeroed; gn_rows_apply
// reads sums (after the all-reduce over the ranks) and writes out and
// stats; n: elements of one group in the whole image.  grid: blocks of
// (px, by) threads, each walking slabs blockIdx.x, + grid, ...  Each
// returns a cudaError_t.
static bool rows_args_ok(int batch, int hw, int c, int groups, int rows, int spi, int grid,
                         int px, int by, int vec) {
  return batch >= 1 && hw >= 1 && c <= kMaxC && groups >= 1 && c % groups == 0 &&
         px * vec == c && px * by <= 1024 && px * by >= 32 && rows >= 1 &&
         spi >= 1 && (long long)rows * (spi - 1) < hw && (long long)rows * spi >= hw &&
         grid >= 1 && grid <= batch * spi;
}

static size_t rows_red_bytes(int px, int by, int c) {
  return 4 * (size_t)red_rows(px, by) * 2 * c;
}

// kRowsUnroll, which kernels/groupnorm.py::rows_plan must take too.
extern "C" int gn_rows_unroll() { return kRowsUnroll; }

// Blocks of (px, by) threads that one SM holds at once of both split-form
// kernels (the fewer of the two), for (dtype, vec, C, G).  Returns a
// cudaError_t.
extern "C" int gn_rows_occupancy(int dtype, int vec, int px, int by, int c, int groups,
                                 int* blocks) {
  int a = 0, b = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define GN_OCC(T, V)                                                                       \
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, gn_rows_sums<T, V>, px * by,    \
                                                      rows_red_bytes(px, by, c));         \
  if (err == cudaSuccess)                                                                  \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, gn_rows_apply<T, V>, px * by, \
                                                        8 * (size_t)groups)
  if (dtype == 0 && vec == 4) { GN_OCC(float, 4); }
  else if (dtype == 0 && vec == 1) { GN_OCC(float, 1); }
  else if (dtype == 1 && vec == 8) { GN_OCC(__nv_bfloat16, 8); }
  else if (dtype == 1 && vec == 1) { GN_OCC(__nv_bfloat16, 1); }
#undef GN_OCC
  *blocks = a < b ? a : b;
  return (int)err;
}

extern "C" int gn_rows_sums(const void* x, void* partials, void* sums, void* count,
                            int batch, int hw, int c, int groups, int rows, int spi, int grid,
                            int px, int by, int dtype, int vec, void* stream) {
  if (!rows_args_ok(batch, hw, c, groups, rows, spi, grid, px, by, vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t dyn = rows_red_bytes(px, by, c);
#define GN_SUMS(T, V)                                                                    \
  gn_rows_sums<T, V><<<grid, dim3(px, by), dyn, st>>>(                                  \
      static_cast<const T*>(x), static_cast<float*>(partials), static_cast<float*>(sums), \
      static_cast<unsigned*>(count), batch, hw, c, groups, rows, spi);                    \
  return (int)cudaGetLastError()
  if (dtype == 0 && vec == 4) { GN_SUMS(float, 4); }
  if (dtype == 0 && vec == 1) { GN_SUMS(float, 1); }
  if (dtype == 1 && vec == 8) { GN_SUMS(__nv_bfloat16, 8); }
  if (dtype == 1 && vec == 1) { GN_SUMS(__nv_bfloat16, 1); }
#undef GN_SUMS
  return (int)cudaErrorInvalidValue;
}

extern "C" int gn_rows_apply(const void* x, const void* scale, const void* bias,
                             const void* sums, void* out, void* stats, int batch, int hw,
                             int c, int groups, int rows, int spi, int grid, int px, int by,
                             float n, float eps, int dtype, int vec, void* stream) {
  if (!rows_args_ok(batch, hw, c, groups, rows, spi, grid, px, by, vec) || !(n > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t dyn = 8 * (size_t)groups;
#define GN_APPLY(T, V)                                                                   \
  gn_rows_apply<T, V><<<grid, dim3(px, by), dyn, st>>>(                                 \
      static_cast<const T*>(x), static_cast<const float*>(scale),                         \
      static_cast<const float*>(bias), static_cast<const float*>(sums),                   \
      static_cast<T*>(out), static_cast<float*>(stats), batch, hw, c, groups, rows, spi,  \
      n, eps);                                                                            \
  return (int)cudaGetLastError()
  if (dtype == 0 && vec == 4) { GN_APPLY(float, 4); }
  if (dtype == 0 && vec == 1) { GN_APPLY(float, 1); }
  if (dtype == 1 && vec == 8) { GN_APPLY(__nv_bfloat16, 8); }
  if (dtype == 1 && vec == 1) { GN_APPLY(__nv_bfloat16, 1); }
#undef GN_APPLY
  return (int)cudaErrorInvalidValue;
}

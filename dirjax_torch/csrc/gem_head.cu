// Fused descriptor head for Hopper (sm_90a): masked GeM pool -> FC -> L2.
//
// Replaces the TPU kernel dirjax/ops/gem_head.py::_kernel (launched by
// _fused_call). Per batch row b it computes
//     pooled[c] = (sum_hw m[hw] * max(x[hw, c], eps)^p / max(sum_hw m[hw], 1))^(1/p)
//     v[d]      = sum_c pooled[c] * W[d, c] + bias[d]
//     out[d]    = v[d] * rsqrt(max(sum_d v[d]^2, 1e-24))
// all in fp32; x may be fp32 or bf16 (widened on load, as the TPU kernel
// does). x is NHWC and contiguous, W is (D, C) row-major (torch.nn.Linear's
// own weight, so the model passes it without a transposed copy), the mask is
// (B, H*W) bytes (a bool tensor), fp32, or null (every cell valid), p is one
// fp32 on the device.
//
// The power of each cell is exp2(p * log2(v)) on the special-function unit
// (lg2.approx and ex2.approx, each within 2 ulp), not expf(p * logf(v)),
// whose instruction count left the pooling bound by issue rather than by
// its reads (bf16 took no less time than fp32). The error this adds, a few
// 1e-6 of each power relative, shrinks by the mean and then by 1/p in the
// root; the root itself stays expf(logf(.) / p). chip_smoke.py holds the
// head to rtol 2e-4 / atol 2e-5 of the plain version in fp32 and bf16, and
// the card tests at p = 1, 2.5, 3 and 8.
//
// What bounds it: at the main-path shape (B=8, H*W=32*24, C=D=2048) one read
// of x (50 MB in fp32, 25 MB in bf16) and one read of W (16.8 MB) against
// ~34 MFLOP of projection and 12.6 M powers, so it is memory-bound, and the
// pooling must keep tens of KB of loads in flight on every SM to stream x.
// Two launches on the caller's stream:
//   (a) gem_pool_kernel: grid (B * C / (32 * CPT), 1, S), a cluster of the S
//       CTAs that split one (b, channel slice)'s H*W cells. A thread owns CPT
//       channels (4 fp32 or 8 bf16: one 16-byte load a cell) and a warp a
//       512-byte run of one cell; the 8 warps of a CTA take every 8th cell of
//       its split, four cells' loads issued before the previous four cells'
//       powers. S is the most splits (at most 8, the portable cluster size)
//       whose clusters all fit on the card at once, so the grid runs in one
//       wave. The partial sums meet in a fixed order: a thread's cells in
//       increasing order, then warps 0..7 in shared memory, then the
//       cluster's CTAs in rank order, which rank 0 reads from the others'
//       shared memory (DSMEM) before it takes the mean and the 1/p root. So
//       two calls on one card give the same bits. The grid's threads also
//       ask L2 to keep W (prefetch, evict_last) for kernel (b).
//   (b) project_kernel: grid (ceil(D / 16), ceil(B / 8)); a warp owns two
//       output columns and its lanes walk their rows of W with 16-byte loads
//       against 8 pooled rows that the CTA stages in shared memory, 2048
//       channels at a time. W is read once for every 8 batch rows; the lane
//       sums meet in a fixed butterfly. Each CTA then counts itself done on
//       its batch group's counter (after a fence); the last one loads its
//       rows once, sums each row's squares in a fixed order and scales the
//       row, so the L2 normalisation takes no launch of its own. Kernel (a)
//       zeroes the counters.
// Any C and D are taken (C not a multiple of the vector width, or a
// misaligned x or W, takes the one-channel form of the same kernels): the
// TPU kernel's D % 128 rule (a Mosaic limit) has no counterpart.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "smem_opt_in.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPoolWarps = 8;
constexpr int kPoolThreads = 32 * kPoolWarps;
constexpr int kPoolUnroll = 4;     // cells whose loads a warp issues together
constexpr int kMaxSplit = 8;       // CTAs a cluster: the portable cluster size
constexpr int kProjWarps = 8;
constexpr int kProjThreads = 32 * kProjWarps;
constexpr int kProjCols = 2;       // output columns a warp
constexpr int kProjRows = 8;       // batch rows a CTA
constexpr int kProjChunk = 2048;   // pooled channels staged at a time (64 KB)
constexpr int kTailPer = 8;        // outputs of a row a thread of the last CTA holds

// One cell's CPT channels as loaded: a 16-byte vector where CPT > 1 (4 fp32
// or 8 bf16), else one value; widened to fp32 by add_powers.
template <typename T, int CPT>
__device__ __forceinline__ uint4 load_cell(const T* src) {
  if constexpr (CPT > 1) return __ldg(reinterpret_cast<const uint4*>(src));
  uint4 raw = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 2) {
    raw.x = *reinterpret_cast<const uint16_t*>(src);
  } else {
    raw.x = __float_as_uint(__ldg(reinterpret_cast<const float*>(src)));
  }
  return raw;
}

// Channel k of a loaded cell as fp32 (a bf16's bits are the fp32's top half).
template <typename T, int CPT>
__device__ __forceinline__ float channel(const uint4& raw, int k) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (sizeof(T) == 2) {
    if constexpr (CPT == 1) return __uint_as_float(w[0] << 16);
    return __uint_as_float(k & 1 ? w[k >> 1] & 0xFFFF0000u : w[k >> 1] << 16);
  } else {
    return __uint_as_float(w[k]);
  }
}

// A cell's mask value: bytes (bool), fp32, or none (1).
__device__ __forceinline__ float mask_at(const void* mask, int kind, size_t i) {
  if (kind == 1) return static_cast<const uint8_t*>(mask)[i] ? 1.f : 0.f;
  if (kind == 2) return static_cast<const float*>(mask)[i];
  return 1.f;
}

// acc[k] += m * max(v_k, eps)^p for the cell's channels, the power as
// exp2(p * log2(v)) on the special-function unit (see the header).
template <typename T, int CPT>
__device__ __forceinline__ void add_powers(float (&acc)[CPT], const uint4& raw, float m, float p,
                                           float eps) {
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    acc[k] += m * exp2f(p * __log2f(fmaxf(channel<T, CPT>(raw, k), eps)));
}

// Ask L2 to fetch W's bytes [0, w_bytes), kept in preference to the x
// stream, so the projection reads W from L2: the grid's threads take one
// 128-byte line each in turn.
__device__ __forceinline__ void prefetch_w(const float* w, size_t w_bytes) {
  const size_t threads = (size_t)gridDim.x * gridDim.y * gridDim.z * blockDim.x;
  const size_t t = (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                       blockDim.x + threadIdx.x;
  const char* base = reinterpret_cast<const char*>(w);
  for (size_t off = t * 128; off < w_bytes; off += threads * 128)
    asm volatile("prefetch.global.L2::evict_last [%0];" ::"l"(base + off));
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kPoolThreads)
gem_pool_kernel(const T* __restrict__ x, const void* __restrict__ mask, int mask_kind,
                const float* __restrict__ p_ptr, float* __restrict__ pooled,
                unsigned* __restrict__ counters, int n_counters, const float* __restrict__ w,
                size_t w_bytes, int slices, int hw, int c, float eps) {
  constexpr int kWidth = 32 * CPT;   // channels a CTA
  __shared__ float part_s[kPoolWarps][kWidth];
  __shared__ float cta_s[kWidth];
  __shared__ float cnt_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = blockIdx.x % slices, b = blockIdx.x / slices;
  const int split = blockIdx.z, splits = gridDim.z;   // the cluster spans z
  const int lo = (int)((long long)hw * split / splits);
  const int hi = (int)((long long)hw * (split + 1) / splits);
  const int ch = slice * kWidth + lane * CPT;
  const float p = *p_ptr;
  if (blockIdx.x == 0 && split == 0)   // kernel (b)'s counters
    for (int i = threadIdx.x; i < n_counters; i += kPoolThreads) counters[i] = 0u;
  prefetch_w(w, w_bytes);

  float acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0.f;
  if (ch < c) {   // CPT > 1 needs C % CPT == 0: the thread's channels all exist
    const T* xb = x + (size_t)b * hw * c + ch;
    const size_t mrow = (size_t)b * hw;
    constexpr int kGroup = kPoolUnroll * kPoolWarps;   // cells a CTA takes a group
    // groups of kPoolUnroll cells, the next group's loads issued before this
    // group's powers
    uint4 v[kPoolUnroll];
    float m[kPoolUnroll];
    int i = lo + warp;
    if (i + (kPoolUnroll - 1) * kPoolWarps < hi) {
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u) {
        v[u] = load_cell<T, CPT>(xb + (size_t)(i + u * kPoolWarps) * c);
        m[u] = mask_at(mask, mask_kind, mrow + i + u * kPoolWarps);
      }
    }
    for (; i + (kPoolUnroll - 1) * kPoolWarps < hi; i += kGroup) {
      uint4 vn[kPoolUnroll];
      float mn[kPoolUnroll];
      const int in = i + kGroup;
      const bool more = in + (kPoolUnroll - 1) * kPoolWarps < hi;
      if (more) {
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u) {
          vn[u] = load_cell<T, CPT>(xb + (size_t)(in + u * kPoolWarps) * c);
          mn[u] = mask_at(mask, mask_kind, mrow + in + u * kPoolWarps);
        }
      }
#pragma unroll
      for (int u = 0; u < kPoolUnroll; ++u) add_powers<T, CPT>(acc, v[u], m[u], p, eps);
      if (more) {
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u) {
          v[u] = vn[u];
          m[u] = mn[u];
        }
      }
    }
    for (; i < hi; i += kPoolWarps)
      add_powers<T, CPT>(acc, load_cell<T, CPT>(xb + (size_t)i * c),
                         mask_at(mask, mask_kind, mrow + i), p, eps);
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k) part_s[warp][lane * CPT + k] = acc[k];
  if (warp == 0) {   // the split's mask count; exact (a sum of 0s and 1s) in any order
    float cnt = 0.f;
    for (int i = lo + lane; i < hi; i += 32) cnt += mask_at(mask, mask_kind, (size_t)b * hw + i);
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (lane == 0) cnt_s = cnt;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kWidth; e += kPoolThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPoolWarps; ++w) s += part_s[w][e];
    cta_s[e] = s;
  }
  cluster.sync();   // every split's sums are in its shared memory
  if (cluster.block_rank() == 0) {
    for (int e = threadIdx.x; e < kWidth; e += kPoolThreads) {
      float total = 0.f, count = 0.f;
      for (int r = 0; r < splits; ++r) {
        total += cluster.map_shared_rank(cta_s, r)[e];
        count += *cluster.map_shared_rank(&cnt_s, r);
      }
      const int cc = slice * kWidth + e;
      if (cc < c) pooled[(size_t)b * c + cc] = expf(logf(total / fmaxf(count, 1.f)) / p);
    }
  }
  cluster.sync();   // rank 0 is done reading the others' shared memory
}

template <bool kVec>
__global__ void __launch_bounds__(kProjThreads)
project_kernel(const float* __restrict__ pooled, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               unsigned* __restrict__ counters, int batch, int c, int d, int chunk) {
  extern __shared__ __align__(16) float rows_s[];   // kProjRows x chunk
  __shared__ float red_s[kProjWarps][kProjRows];
  __shared__ bool last_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * kProjRows;
  const int rows = min(kProjRows, batch - row0);
  const int col0 = (blockIdx.x * kProjWarps + warp) * kProjCols;

  float acc[kProjCols][kProjRows];
#pragma unroll
  for (int j = 0; j < kProjCols; ++j)
#pragma unroll
    for (int r = 0; r < kProjRows; ++r) acc[j][r] = 0.f;
  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int clen = min(chunk, c - c0);
    __syncthreads();   // every warp is done with the previous chunk
    // the rows' chunks, eight loads a thread in flight (L2 latency, not
    // bandwidth, sets the pace of this copy)
    if constexpr (kVec) {
      const int per_row = clen / 4;
#pragma unroll 8
      for (int e = threadIdx.x; e < kProjRows * per_row; e += kProjThreads) {
        const int r = e / per_row, k = 4 * (e - r * per_row);
        *reinterpret_cast<float4*>(rows_s + r * chunk + k) =
            r < rows ? *reinterpret_cast<const float4*>(pooled + (size_t)(row0 + r) * c + c0 + k)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll 8
      for (int e = threadIdx.x; e < kProjRows * clen; e += kProjThreads) {
        const int r = e / clen, k = e - r * clen;
        rows_s[r * chunk + k] = r < rows ? pooled[(size_t)(row0 + r) * c + c0 + k] : 0.f;
      }
    }
    __syncthreads();
    if constexpr (kVec) {   // C % 4 == 0 and W 16-byte aligned: float4 of W
#pragma unroll 4
      for (int k = lane * 4; k < clen; k += 128) {
        float4 wv[kProjCols];
#pragma unroll
        for (int j = 0; j < kProjCols; ++j)
          wv[j] = col0 + j < d ? __ldg(reinterpret_cast<const float4*>(w + (size_t)(col0 + j) * c + c0 + k))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) {
          const float4 pr = *reinterpret_cast<const float4*>(rows_s + r * chunk + k);
#pragma unroll
          for (int j = 0; j < kProjCols; ++j) {
            acc[j][r] = fmaf(pr.x, wv[j].x, acc[j][r]);
            acc[j][r] = fmaf(pr.y, wv[j].y, acc[j][r]);
            acc[j][r] = fmaf(pr.z, wv[j].z, acc[j][r]);
            acc[j][r] = fmaf(pr.w, wv[j].w, acc[j][r]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = lane; k < clen; k += 32) {
        float wv[kProjCols];
#pragma unroll
        for (int j = 0; j < kProjCols; ++j)
          wv[j] = col0 + j < d ? __ldg(w + (size_t)(col0 + j) * c + c0 + k) : 0.f;
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) {
          const float pr = rows_s[r * chunk + k];
#pragma unroll
          for (int j = 0; j < kProjCols; ++j) acc[j][r] = fmaf(pr, wv[j], acc[j][r]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kProjCols; ++j)
#pragma unroll
    for (int r = 0; r < kProjRows; ++r) {
      float s = acc[j][r];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && r < rows && col0 + j < d)
        out[(size_t)(row0 + r) * d + col0 + j] = s + bias[col0 + j];
    }

  // The L2 normalisation: the last CTA of the batch group scales its rows,
  // all of them at once: a thread's squares in increasing column order, the
  // lanes in a butterfly, the warps in order.
  __threadfence();   // this CTA's outputs are visible before it counts itself
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(counters + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  float* const o = out + (size_t)row0 * d;
  float vals[kProjRows][kTailPer];   // where d <= kTailPer * kProjThreads: loaded once
  const bool held = d <= kTailPer * kProjThreads;
  float sq[kProjRows];
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) {
    sq[r] = 0.f;
    if (held) {
#pragma unroll
      for (int t = 0; t < kTailPer; ++t) {
        const int j = threadIdx.x + t * kProjThreads;
        vals[r][t] = r < rows && j < d ? __ldcg(o + (size_t)r * d + j) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kTailPer; ++t) sq[r] = fmaf(vals[r][t], vals[r][t], sq[r]);
    } else if (r < rows) {
      for (int j = threadIdx.x; j < d; j += kProjThreads) {
        const float v = __ldcg(o + (size_t)r * d + j);
        sq[r] = fmaf(v, v, sq[r]);
      }
    }
    for (int off = 16; off > 0; off >>= 1) sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], off);
    if (lane == 0) red_s[warp][r] = sq[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) {
    if (r >= rows) break;
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kProjWarps; ++k) total += red_s[k][r];
    const float inv = rsqrtf(fmaxf(total, 1e-24f));
    if (held) {
#pragma unroll
      for (int t = 0; t < kTailPer; ++t) {
        const int j = threadIdx.x + t * kProjThreads;
        if (j < d) o[(size_t)r * d + j] = vals[r][t] * inv;
      }
    } else {
      for (int j = threadIdx.x; j < d; j += kProjThreads)
        o[(size_t)r * d + j] = __ldcg(o + (size_t)r * d + j) * inv;
    }
  }
}

template <typename T, int CPT>
cudaError_t launch_pool(const void* x, const void* mask, int mask_kind, const float* p,
                        float* pooled, unsigned* counters, int n_counters, const float* w,
                        size_t w_bytes, int batch, int hw, int c, float eps, cudaStream_t s) {
  cudaError_t err;
  const int slices = (c + 32 * CPT - 1) / (32 * CPT);
  const long long clusters = (long long)slices * batch;
  if (clusters > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)clusters, 1u, 1u);
  cfg.blockDim = dim3(kPoolThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The most splits (up to 8, and H*W) whose clusters all fit the card at
  // once: one wave, no tail of a few CTAs. How many clusters of each size
  // fit depends only on the kernel and the card: asked once a device. Host
  // threads may launch at once: the cache is atomic, and two threads that
  // ask together store the same answer.
  constexpr int kDevices = 16;
  static std::atomic<int> fit[kDevices][kMaxSplit + 1];   // 0: not asked yet
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int splits = hw < kMaxSplit ? (hw > 1 ? hw : 1) : kMaxSplit;
  for (; splits > 1; --splits) {
    int n = dev < kDevices ? fit[dev][splits].load(std::memory_order_relaxed) : 0;
    if (n == 0) {
      attr[0].val.clusterDim.z = (unsigned)splits;
      cfg.gridDim.z = (unsigned)splits;
      err = cudaOccupancyMaxActiveClusters(&n, gem_pool_kernel<T, CPT>, &cfg);
      if (err != cudaSuccess) return err;
      if (dev < kDevices) fit[dev][splits].store(n > 0 ? n : -1, std::memory_order_relaxed);
    }
    if (clusters <= n) break;
  }
  attr[0].val.clusterDim.z = (unsigned)splits;
  cfg.gridDim.z = (unsigned)splits;
  return cudaLaunchKernelEx(&cfg, gem_pool_kernel<T, CPT>, static_cast<const T*>(x), mask,
                            mask_kind, p, pooled, counters, n_counters, w, w_bytes, slices, hw,
                            c, eps);
}

template <bool kVec>
cudaError_t launch_project(const float* pooled, const float* w, const float* bias, float* out,
                           unsigned* counters, int batch, int c, int d, cudaStream_t s) {
  const int chunk = c < kProjChunk ? c : kProjChunk;
  const int smem = kProjRows * chunk * (int)sizeof(float);
  auto* kernel = project_kernel<kVec>;
  static OptInFlags opted;   // the ceiling: kProjChunk channels staged (C >= 2048)
  cudaError_t err = opt_in_once(kernel, kProjRows * kProjChunk * (int)sizeof(float), smem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + kProjWarps * kProjCols - 1) / (kProjWarps * kProjCols),
                  (batch + kProjRows - 1) / kProjRows);
  kernel<<<grid, kProjThreads, smem, s>>>(pooled, w, bias, out, counters, batch, c, d, chunk);
  return cudaGetLastError();
}

}  // namespace

// Launches the two kernels on `stream`; `pooled` is (B, C) fp32 device
// scratch, `counters` ceil(B / 8) uint32 device scratch (kernel (a) zeroes
// them). mask_kind: 0 none, 1 bytes (bool), 2 fp32. Returns the first
// launch error (cudaSuccess == 0). Does not synchronise.
extern "C" int dirjax_gem_head(const void* x, int x_is_bf16, const void* mask, int mask_kind,
                               const float* p, const float* w, const float* bias, float* pooled,
                               unsigned* counters, float* out, int batch, int hw, int c, int d,
                               float eps, void* stream) {
  if (batch <= 0 || c <= 0 || d <= 0 || hw < 0 || mask_kind < 0 || mask_kind > 2 ||
      (mask_kind != 0 && mask == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_counters = (batch + kProjRows - 1) / kProjRows;
  const bool x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t w_bytes = (size_t)c * d * sizeof(float);
  cudaError_t err;
  if (x_is_bf16) {
    err = c % 8 == 0 && x16
              ? launch_pool<__nv_bfloat16, 8>(x, mask, mask_kind, p, pooled, counters, n_counters,
                                              w, w_bytes, batch, hw, c, eps, s)
              : launch_pool<__nv_bfloat16, 1>(x, mask, mask_kind, p, pooled, counters, n_counters,
                                              w, w_bytes, batch, hw, c, eps, s);
  } else {
    err = c % 4 == 0 && x16
              ? launch_pool<float, 4>(x, mask, mask_kind, p, pooled, counters, n_counters, w,
                                      w_bytes, batch, hw, c, eps, s)
              : launch_pool<float, 1>(x, mask, mask_kind, p, pooled, counters, n_counters, w,
                                      w_bytes, batch, hw, c, eps, s);
  }
  if (err != cudaSuccess) return (int)err;
  const bool w16 = c % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  err = w16 ? launch_project<true>(pooled, w, bias, out, counters, batch, c, d, s)
            : launch_project<false>(pooled, w, bias, out, counters, batch, c, d, s);
  return (int)err;
}

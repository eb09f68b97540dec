// Fused descriptor head for Hopper (sm_90a): masked GeM pool -> FC -> L2.
//
// Replaces the TPU kernel dirjax/ops/gem_head.py::_kernel (launched by
// _fused_call). Per batch row b it computes
//     pooled[c] = (sum_hw m[hw] * max(x[hw, c], eps)^p / max(sum_hw m[hw], 1))^(1/p)
//     v[d]      = sum_c pooled[c] * W[d, c] + bias[d]
//     out[d]    = v[d] * rsqrt(max(sum_d v[d]^2, 1e-24))
// all in fp32; x may be fp32 or bf16 (widened on load, as the TPU kernel
// does). x is NHWC and contiguous, W is (D, C) row-major (torch.nn.Linear's
// own weight, so the model passes it without a transposed copy), mask is
// (B, H*W) fp32 or null (every cell valid), p is one fp32 on the device.
//
// What bounds it: at the main-path shape (B=8, H*W=32*24, C=D=2048) one read
// of x (50 MB in fp32) and one read of W (16.8 MB) against ~34 MFLOP of
// projection, so it is memory-bound. The design is the simple one, in three
// launches on the caller's stream:
//   (a) gem_pool_kernel: grid (B, ceil(C/128)); a thread owns one channel and
//       walks the H*W cells, so a warp reads 128 contiguous bytes of a cell.
//       128 channels per block gives B*C/128 = 128 blocks at the main-path
//       shape, about one per SM; the H*W walk is not split across blocks.
//   (b) project_kernel: grid (ceil(D/8), ceil(B/8)); a warp owns one output
//       column d and its lanes walk row d of W (128 contiguous bytes per
//       step) against 8 pooled rows that the block stages in shared memory
//       1024 channels at a time. W is read once for every 8 batch rows; the
//       lane sums meet in a fixed butterfly, so the result does not change
//       from run to run. 256 blocks at the main-path shape.
//   (c) l2norm_kernel: grid (B); L2-normalises each row in place.
// Any D is taken: the columns past D are masked here, so the TPU kernel's
// D % 128 rule (a Mosaic limit) has no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kPoolThreads = 128;  // channels per pooling block
constexpr int kProjWarps = 8;      // output columns per projection block
constexpr int kProjRows = 8;       // batch rows per projection block
constexpr int kProjChunk = 1024;   // pooled channels staged at a time (32 KB)
constexpr int kNormThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void gem_pool_kernel(const T* __restrict__ x,
                                const float* __restrict__ mask,
                                const float* __restrict__ p_ptr,
                                float* __restrict__ pooled, int hw, int c,
                                float eps) {
  const int b = blockIdx.x;
  const int ch = blockIdx.y * kPoolThreads + threadIdx.x;
  if (ch >= c) return;
  const float p = *p_ptr;
  const T* xb = x + (size_t)b * hw * c + ch;
  const float* mb = mask == nullptr ? nullptr : mask + (size_t)b * hw;
  float acc = 0.f;
  float count = 0.f;
#pragma unroll 4
  for (int i = 0; i < hw; ++i) {
    const float m = mb == nullptr ? 1.f : mb[i];
    const float v = fmaxf(widen(xb[(size_t)i * c]), eps);
    acc += m * expf(p * logf(v));
    count += m;
  }
  pooled[(size_t)b * c + ch] = expf(logf(acc / fmaxf(count, 1.f)) / p);
}

__global__ void project_kernel(const float* __restrict__ pooled,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int batch, int c,
                               int d) {
  __shared__ float rows[kProjRows][kProjChunk];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row0 = blockIdx.y * kProjRows;
  const int col = blockIdx.x * kProjWarps + warp;
  const float* wd = w + (size_t)col * c;

  float acc[kProjRows];
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < c; c0 += kProjChunk) {
    const int clen = min(kProjChunk, c - c0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = tid; i < kProjRows * kProjChunk; i += kProjWarps * 32) {
      const int r = i / kProjChunk;
      const int k = i % kProjChunk;
      rows[r][k] = (row0 + r < batch && k < clen)
                       ? pooled[(size_t)(row0 + r) * c + c0 + k]
                       : 0.f;
    }
    __syncthreads();
    if (col < d) {
#pragma unroll 8
      for (int k = lane; k < clen; k += 32) {
        const float wv = wd[c0 + k];
#pragma unroll
        for (int r = 0; r < kProjRows; ++r) acc[r] += rows[r][k] * wv;
      }
    }
  }
  if (col >= d) return;
#pragma unroll
  for (int r = 0; r < kProjRows; ++r) {
    float s = acc[r];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && row0 + r < batch) {
      out[(size_t)(row0 + r) * d + col] = s + bias[col];
    }
  }
}

__global__ void l2norm_kernel(float* __restrict__ out, int d) {
  __shared__ float warp_sums[kNormThreads / 32];
  float* ob = out + (size_t)blockIdx.x * d;
  float sq = 0.f;
  for (int j = threadIdx.x; j < d; j += kNormThreads) sq += ob[j] * ob[j];
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kNormThreads / 32; ++k) total += warp_sums[k];
  const float inv = rsqrtf(fmaxf(total, 1e-24f));
  for (int j = threadIdx.x; j < d; j += kNormThreads) ob[j] *= inv;
}

}  // namespace

// Launches the three stages on `stream`; `pooled` is (B, C) fp32 device
// scratch. Returns the first launch error (cudaSuccess == 0). Does not
// synchronise.
extern "C" int dirjax_gem_head(const void* x, int x_is_bf16, const float* mask,
                               const float* p, const float* w,
                               const float* bias, float* pooled, float* out,
                               int batch, int hw, int c, int d, float eps,
                               void* stream) {
  if (batch <= 0 || c <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const dim3 pool_grid(batch, (c + kPoolThreads - 1) / kPoolThreads);
  if (x_is_bf16) {
    gem_pool_kernel<__nv_bfloat16><<<pool_grid, kPoolThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mask, p, pooled, hw, c, eps);
  } else {
    gem_pool_kernel<float><<<pool_grid, kPoolThreads, 0, s>>>(
        static_cast<const float*>(x), mask, p, pooled, hw, c, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 proj_grid((d + kProjWarps - 1) / kProjWarps,
                       (batch + kProjRows - 1) / kProjRows);
  project_kernel<<<proj_grid, dim3(32, kProjWarps), 0, s>>>(pooled, w, bias,
                                                            out, batch, c, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  l2norm_kernel<<<batch, kNormThreads, 0, s>>>(out, d);
  return (int)cudaGetLastError();
}

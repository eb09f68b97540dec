// The vision transformer's LayerScale residual update fused with the
// LayerNorm that follows it, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no vision transformer. It
// replaces three PyTorch launches of models/vit.py's pre-LN blocks (the
// mixed-dtype `z.addcmul_(y, gamma)`, `F.layer_norm(z)` and the `.to(bf16)`
// of its fp32 output), each of which read and wrote whole rows. Per row r of
// D columns it computes
//     z[r]   = z[r] + gamma * float(y[r])        (skipped without y)
//     out[r] = (z[r] - mean) * rsqrt(var + eps) * w + b
// in fp32, with z written back in place and out stored in fp32 or rounded
// to the nearest bf16. The mean and the (biased) variance are two passes
// over the row held in registers.
//
// What bounds it: bytes. At the main-path shape (B 8, 4,020 tokens, D 1024,
// a bf16 branch) one launch reads z (4 B an element) and y (2 B) and writes
// z (4 B) and out (2 B), 395 MB, against ~10 flops an element, so the
// design keeps only those bytes: one warp a row, each lane holding D / 128
// float4s of the row in registers (columns 4 * (32 k + lane) .. + 3, so a
// warp's k-th load is 512 contiguous bytes of z and 256 of a bf16 y), every
// load of the row issued before any arithmetic, the sums reduced by warp
// shuffles (no shared memory), and gamma, w, b read from L1 as float4s.
// Each row is read once and written once. Eight warps (rows) a CTA; a
// partial last CTA's spare warps exit. The kernel is instantiated for each
// D / 128 from 1 to 12 (D 128 to 1536), for a branch that is absent or
// bf16 with an fp32 or bf16 output, and for an fp32 branch with an fp32
// output (the fp32 forward); the entry picks by D and dtypes.
//
// z and y are (batch, rows, D) with contiguous rows D apart inside a batch
// entry and `batch_stride` elements between entries (equal for both), so a
// launch can take the patch tokens of a token stream (z[:, front:]); out is
// contiguous (batch, rows, D). Every row must start 16-byte aligned: the
// wrapper (ops/residual_norm.py) checks that, the dtypes and D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // rows a CTA, one a warp
constexpr int kVec = 4;           // columns a lane takes per load: a float4 of z
constexpr int kMaxChunks = 12;    // D / 128 at most (D = 1536)

enum Branch { kNoBranch = 0, kBf16Branch = 1, kFp32Branch = 2 };

// Four branch values at element offset `off` as fp32 (a bf16's bits are
// the fp32's top half).
template <int BR>
__device__ __forceinline__ float4 load_branch(const void* y, long long off) {
  if constexpr (BR == kBf16Branch) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(y) + off));
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xFFFF0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xFFFF0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(y) + off));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, m);
  return v;
}

template <int CH, int BR, bool OUT_BF16>
__global__ void __launch_bounds__(32 * kWarps)
    residual_norm_kernel(float* __restrict__ z, const void* __restrict__ y,
                         const float* __restrict__ gamma, const float* __restrict__ w,
                         const float* __restrict__ b, void* __restrict__ out,
                         long long batch_stride, int rows, long long total_rows, float eps) {
  constexpr int D = CH * 32 * kVec;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= total_rows) return;
  const int lane = threadIdx.x & 31;
  const long long entry = row / rows;
  const long long src = entry * batch_stride + (row - entry * rows) * D;

  float4 x[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k)
    x[k] = *reinterpret_cast<const float4*>(z + src + (k * 32 + lane) * kVec);
  if constexpr (BR != kNoBranch) {
    float4 v[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) v[k] = load_branch<BR>(y, src + (k * 32 + lane) * kVec);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int col = (k * 32 + lane) * kVec;
      const float4 g = __ldg(reinterpret_cast<const float4*>(gamma + col));
      x[k].x = fmaf(g.x, v[k].x, x[k].x);
      x[k].y = fmaf(g.y, v[k].y, x[k].y);
      x[k].z = fmaf(g.z, v[k].z, x[k].z);
      x[k].w = fmaf(g.w, v[k].w, x[k].w);
      *reinterpret_cast<float4*>(z + src + col) = x[k];
    }
  }

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CH; ++k) s += (x[k].x + x[k].y) + (x[k].z + x[k].w);
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const float a = x[k].x - mean, c = x[k].y - mean, d = x[k].z - mean, e = x[k].w - mean;
    q += (a * a + c * c) + (d * d + e * e);
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);

  const long long dst = row * D;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int col = (k * 32 + lane) * kVec;
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + col));
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b + col));
    const float4 o = make_float4((x[k].x - mean) * rstd * wv.x + bv.x,
                                 (x[k].y - mean) * rstd * wv.y + bv.y,
                                 (x[k].z - mean) * rstd * wv.z + bv.z,
                                 (x[k].w - mean) * rstd * wv.w + bv.w);
    if constexpr (OUT_BF16) {
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + dst + col) =
          make_uint2(bf16_pair(o.x, o.y), bf16_pair(o.z, o.w));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + dst + col) = o;
    }
  }
}

struct Args {
  float* z;
  const void* y;
  const float* gamma;
  const float* w;
  const float* b;
  void* out;
  long long batch_stride;
  int rows;
  long long total_rows;
  float eps;
};

// The instantiation for D / 128 == `chunks` (CH counts up to it).
template <int BR, bool OUT_BF16, int CH = 1>
cudaError_t launch(int chunks, const Args& a, cudaStream_t s) {
  if constexpr (CH > kMaxChunks) {
    return cudaErrorInvalidValue;
  } else {
    if (chunks != CH) return launch<BR, OUT_BF16, CH + 1>(chunks, a, s);
    const unsigned grid = (unsigned)((a.total_rows + kWarps - 1) / kWarps);
    residual_norm_kernel<CH, BR, OUT_BF16><<<grid, 32 * kWarps, 0, s>>>(
        a.z, a.y, a.gamma, a.w, a.b, a.out, a.batch_stride, a.rows, a.total_rows, a.eps);
    return cudaGetLastError();
  }
}

template <int BR>
cudaError_t launch_branch(int chunks, bool out_bf16, const Args& a, cudaStream_t s) {
  if constexpr (BR == kFp32Branch) {
    return out_bf16 ? cudaErrorInvalidValue : launch<BR, false>(chunks, a, s);
  } else {
    return out_bf16 ? launch<BR, true>(chunks, a, s) : launch<BR, false>(chunks, a, s);
  }
}

}  // namespace

// z: fp32 (batch, rows, d) at `batch_stride` elements an entry, updated in
// place where y is given; y: null (branch 0), bf16 (1) or fp32 (2), the
// same layout as z; gamma, w, b: fp32 (d,); out: contiguous (batch, rows,
// d), bf16 where out_bf16 else fp32 (fp32 with an fp32 y). d a multiple of 128 up to 1536, every
// row 16-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int dirjax_residual_norm(float* z, long long batch_stride, const void* y, int branch,
                                    const float* gamma, const float* w, const float* b,
                                    void* out, int out_bf16, int batch, int rows, int d,
                                    float eps, void* stream) {
  if (batch <= 0 || rows <= 0 || d <= 0 || d % (32 * kVec) != 0 ||
      d / (32 * kVec) > kMaxChunks || branch < kNoBranch || branch > kFp32Branch ||
      (branch != kNoBranch && (y == nullptr || gamma == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{z, y, gamma, w, b, out, batch_stride, rows, (long long)batch * rows, eps};
  const int chunks = d / (32 * kVec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (branch) {
    case kBf16Branch: return (int)launch_branch<kBf16Branch>(chunks, out_bf16 != 0, a, s);
    case kFp32Branch: return (int)launch_branch<kFp32Branch>(chunks, out_bf16 != 0, a, s);
    default: return (int)launch_branch<kNoBranch>(chunks, out_bf16 != 0, a, s);
  }
}

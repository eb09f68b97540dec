// Implicit-GEMM convolution with a fused fp32 epilogue for Hopper (sm_90a):
// the bf16 inference convolutions of the ResNet/ResNeXt backbones and of the
// FPN merge.
//
// Replaces no TPU kernel: it is the counterpart of the XLA convolution that
// dirjax's inference forward asks for (dirjax/models/resnet.py:159-191,
// `_conv` with preferred_element_type=float32, then `_bn`; the FPN merge,
// dirjax/models/rmac.py:169-179), whose elementwise chain XLA fuses into
// the convolution's epilogue. It computes, for an NHWC bf16 input x, bf16
// weights w packed (cout, kh, kw, cin / groups) and any stride, zero
// padding and group count,
//     acc[m, n] = sum_k x_patch[m, k] * w[n, k]        (fp32 accumulation)
//     v = acc * scale[n] + shift[n]                     (each optional)
//     v = relu(v)                                        (relu == 1)
//     v = v + residual[m, n]                            (bf16 or fp32, optional)
//     v = relu(v)                                        (relu == 2)
//     out[m, n] = v                                      (bf16 or fp32)
// with m = (b, ho, wo) an output pixel, n an output channel and
// k = (r, s, c) ordered as the packed weights are, so that a 16-byte load of
// the input is 8 consecutive channels of one pixel. The accumulator never
// leaves fp32 before the epilogue, which multiplies and adds with separate
// roundings (__fmul_rn, __fadd_rn), as the plain version in
// dirjax_torch/ops/conv.py does: the output is dirjax's fp32 convolution
// output carried through its fp32 epilogue, rounded once at the end.
//
// What bounds it: at resnet101_rmac's shapes (batch 8, 1024x768) one
// forward's 104 convolutions do 1.96 TFLOP (1.98 ms at 989 TFLOP/s) and, each
// operand read once and each output written once, move about 11 GB (3.3 ms
// at 3.35 TB/s): most layers are bound by their bytes, the 3x3 layers of the
// deeper stages by their operations. The design is the simple one that is
// right, and leaves the speed to a later change:
//   - A CTA of 8 warps owns a 128-pixel x BN-channel output tile (BN = 16,
//     32, 64 or 128, the least that covers cout / groups) of one group; the
//     grid is (pixel tiles, groups x channel tiles).
//   - K walks in 32-wide slices through a 4-stage cp.async ring in shared
//     memory (rows padded to 80 bytes, so ldmatrix reads no bank twice).
//     Each thread's input chunks share one (r, s, c) a slice; a chunk outside
//     the image, past K or past M is zero-filled by the copy itself
//     (src-size 0): that is the convolution's zero padding. Chunks are 16
//     bytes where cin / groups is a multiple of 8, else 8 bytes (a multiple
//     of 4: ResNeXt's 4-channel groups; the stem's 3 channels arrive padded
//     to 4 with zeros by the wrapper, which adds exact zeros to each sum).
//   - mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments;
//     each warp owns a (128 / WARPS_M) x (BN / WARPS_N) piece of the tile.
//   - The epilogue stages the fp32 accumulators in shared memory (the ring's
//     space), then each thread takes 4 consecutive channels of a pixel:
//     16-byte reads of the tile, the residual and scale/shift, 8- or 16-byte
//     stores of the output. (Written straight from the mma fragments, 4
//     bytes a lane, it left the epilogue-heavy 1x1 layers at 3-5x cuDNN.)
// Not done: TMA, wgmma, warp specialisation, persistent tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int kBM = 128;          // output pixels a CTA
constexpr int kBK = 32;           // K a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;     // 8 warps
constexpr int kRow = kBK + 8;     // a staged row: 32 bf16 and 8 of padding (80 bytes)

struct ConvArgs {
  const __nv_bfloat16* x;     // (batch, h, w, cin) bf16
  const __nv_bfloat16* w;     // (cout, kh, kw, cin_g) bf16
  const float* scale;         // (cout,) or null
  const float* shift;         // (cout,) or null
  const void* residual;       // (batch, ho, wo, cout), bf16 or fp32, or null
  void* out;                  // (batch, ho, wo, cout), bf16 or fp32
  int res_kind;               // 0 none, 1 bf16, 2 fp32
  int relu;                   // 0 none, 1 before the residual add, 2 after it
  int out_bf16;
  int h, w_in, cin, ho, wo, cout, kw, stride, pad;
  int cin_g, cout_g, k_g;     // per group; k_g = kh * kw * cin_g
  int m;                      // batch * ho * wo
  int n_tiles;                // channel tiles a group
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int bytes = valid ? VEC * 2 : 0;   // 0: the copy zero-fills dst
  if constexpr (VEC == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output element from its fp32 sum: the multiply and the adds rounded
// apart, as the plain version's separate fp32 ops round them; r is the
// residual (0 without one, whose add then leaves v as it is).
__device__ __forceinline__ float epilogue(const ConvArgs& a, float v, float sc, float sh,
                                          float r) {
  if (a.scale) v = __fmul_rn(v, sc);
  if (a.shift) v = __fadd_rn(v, sh);
  if (a.relu == 1) v = fmaxf(v, 0.f);
  if (a.res_kind) v = __fadd_rn(v, r);
  if (a.relu == 2) v = fmaxf(v, 0.f);
  return v;
}

template <int BN, int WARPS_M, int VEC>
__global__ void __launch_bounds__(kThreads) conv_kernel(ConvArgs a) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile");
  constexpr int CPR = kBK / VEC;                // chunks a staged row
  constexpr int A_CHUNKS = kBM * CPR / kThreads;
  static_assert(kBM * CPR % kThreads == 0 && kThreads % CPR == 0, "loader");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sA = smem;                               // [kStages][kBM][kRow]
  __nv_bfloat16* sB = smem + kStages * kBM * kRow;        // [kStages][BN][kRow]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int m0 = blockIdx.x * kBM;
  const int grp = blockIdx.y / a.n_tiles;
  const int n0 = (blockIdx.y % a.n_tiles) * BN;
  const int KT = (a.k_g + kBK - 1) / kBK;

  // this thread's input rows: every chunk it copies has the same column
  const int a_col = tid % CPR;
  long long a_pix[A_CHUNKS];     // first element of image b's pixel (0, 0) and channel grp * cin_g
  int a_hi[A_CHUNKS], a_wi[A_CHUNKS];
  bool a_ok[A_CHUNKS];
  const int hw_out = a.ho * a.wo;
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int m = m0 + (tid + i * kThreads) / CPR;
    a_ok[i] = m < a.m;
    const int mm = a_ok[i] ? m : 0;
    const int b = mm / hw_out, rem = mm - b * hw_out;
    const int ho = rem / a.wo, wo = rem - ho * a.wo;
    a_hi[i] = ho * a.stride - a.pad;
    a_wi[i] = wo * a.stride - a.pad;
    a_pix[i] = (long long)b * a.h * a.w_in * a.cin + (long long)grp * a.cin_g;
  }

  auto load_tile = [&](int stage, int kt) {
    // input: one (r, s, c) for all of this thread's chunks
    const int k = kt * kBK + a_col * VEC;
    const bool k_ok = k < a.k_g;
    const int rs = k / a.cin_g, c = k - rs * a.cin_g;
    const int r = rs / a.kw, s = rs - r * a.kw;
    __nv_bfloat16* dst_a = sA + stage * kBM * kRow;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int row = (tid + i * kThreads) / CPR;
      const int hi = a_hi[i] + r, wi = a_wi[i] + s;
      const bool ok = a_ok[i] && k_ok && hi >= 0 && hi < a.h && wi >= 0 && wi < a.w_in;
      const __nv_bfloat16* src =
          ok ? a.x + a_pix[i] + ((long long)hi * a.w_in + wi) * a.cin + c : a.x;
      cp_async<VEC>(dst_a + row * kRow + a_col * VEC, src, ok);
    }
    // weights: BN rows of this group's channel tile
    __nv_bfloat16* dst_b = sB + stage * BN * kRow;
    for (int idx = tid; idx < BN * CPR; idx += kThreads) {
      const int n = idx / CPR, col = idx - n * CPR;
      const int kk = kt * kBK + col * VEC;
      const bool ok = n0 + n < a.cout_g && kk < a.k_g;
      const __nv_bfloat16* src =
          ok ? a.w + (long long)(grp * a.cout_g + n0 + n) * a.k_g + kk : a.w;
      cp_async<VEC>(dst_b + n * kRow + col * VEC, src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt is in; every warp is done with the stage refilled below
    const int next = kt + kStages - 1;
    if (next < KT) load_tile(next % kStages, next);
    cp_async_commit();

    const __nv_bfloat16* tA = sA + (kt % kStages) * kBM * kRow;
    const __nv_bfloat16* tB = sB + (kt % kStages) * BN * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = wm * WM + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], tA + row * kRow + kk + (lane >> 4) * 8);
      }
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int n = wn * WN + j * 8 + (lane & 7) + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, tB + n * kRow + kk + ((lane >> 3) & 1) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: the accumulators go through shared memory (the ring is free
  // now), so that each thread then takes 4 consecutive channels of a pixel:
  // 16-byte reads of the tile, the residual and the scale/shift, 8- or
  // 16-byte stores, a warp on 512 contiguous bytes of a row where BN allows
  constexpr int TS = BN + 8;   // the staged row in floats: float2 stores hit no bank twice
  static_assert(kBM * TS * 4 <= kStages * (kBM + BN) * kRow * 2, "staged tile");
  float* tile = reinterpret_cast<float*>(smem_raw);
  __syncthreads();   // every warp is done reading the ring
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wm * WM + i * 16 + g + half * 8, col = wn * WN + j * 8 + 2 * t;
          *reinterpret_cast<float2*>(tile + row * TS + col) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
  }
  __syncthreads();
  constexpr int CHUNKS = BN / 4;   // 4-channel chunks a row of the tile
  for (int idx = tid; idx < kBM * CHUNKS; idx += kThreads) {
    const int row = idx / CHUNKS, c = (idx - row * CHUNKS) * 4;
    const int m = m0 + row, nl = n0 + c;
    if (m >= a.m || nl >= a.cout_g) continue;
    const int n = grp * a.cout_g + nl;
    const long long off = (long long)m * a.cout + n;
    const float4 acc4 = *reinterpret_cast<const float4*>(tile + row * TS + c);
    float v[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
    float sc[4] = {1.f, 1.f, 1.f, 1.f}, sh[4] = {0.f, 0.f, 0.f, 0.f}, r[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.scale) {
      const float4 q = *reinterpret_cast<const float4*>(a.scale + n);
      sc[0] = q.x; sc[1] = q.y; sc[2] = q.z; sc[3] = q.w;
    }
    if (a.shift) {
      const float4 q = *reinterpret_cast<const float4*>(a.shift + n);
      sh[0] = q.x; sh[1] = q.y; sh[2] = q.z; sh[3] = q.w;
    }
    if (a.res_kind == 1) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          static_cast<const __nv_bfloat16*>(a.residual) + off);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      r[0] = lo.x; r[1] = lo.y; r[2] = hi.x; r[3] = hi.y;
    } else if (a.res_kind == 2) {
      const float4 q = *reinterpret_cast<const float4*>(
          static_cast<const float*>(a.residual) + off);
      r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = epilogue(a, v[e], sc[e], sh[e], r[e]);
    if (a.out_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 raw;
      raw.x = *reinterpret_cast<const uint32_t*>(&lo);
      raw.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + off) = raw;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + off) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int BN, int WARPS_M, int VEC>
cudaError_t launch(const ConvArgs& a, int groups, cudaStream_t stream) {
  auto kernel = conv_kernel<BN, WARPS_M, VEC>;
  const int smem = kStages * (kBM + BN) * kRow * (int)sizeof(__nv_bfloat16);
  static OptInFlags opted;   // one size per instance: the ceiling is this launch's
  cudaError_t err = opt_in_once(kernel, smem, smem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + kBM - 1) / kBM, groups * a.n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(ConvArgs& a, int groups, cudaStream_t stream) {
  if (a.cout_g <= 16) {
    a.n_tiles = 1;
    return launch<16, 8, VEC>(a, groups, stream);
  }
  if (a.cout_g <= 32) {
    a.n_tiles = 1;
    return launch<32, 8, VEC>(a, groups, stream);
  }
  if (a.cout_g <= 64) {
    a.n_tiles = 1;
    return launch<64, 4, VEC>(a, groups, stream);
  }
  a.n_tiles = (a.cout_g + 127) / 128;
  return launch<128, 2, VEC>(a, groups, stream);
}

}  // namespace

// x: (batch, h, w, cin) bf16; w: (cout, kh, kw, cin / groups) bf16; scale,
// shift: (cout,) fp32 or null; residual: (batch, ho, wo, cout) of res_kind (0
// none, 1 bf16, 2 fp32); relu: 0 none, 1 before the residual add, 2 after
// it; out: (batch, ho, wo, cout), bf16 if out_bf16 else fp32. cin / groups
// and cout / groups must be multiples of 4 and every pointer 16-byte
// aligned (the epilogue moves 4 channels at a time). Returns a cudaError_t.
extern "C" int dirjax_conv_fused(const void* x, const void* w, const float* scale,
                                 const float* shift, const void* residual, int res_kind, int relu,
                                 void* out, int out_bf16, int batch, int h, int w_in, int cin,
                                 int cout, int kh, int kw, int stride, int pad, int groups,
                                 int ho, int wo, void* stream) {
  if (batch <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || groups <= 0 || ho <= 0 || wo <= 0 || cin % groups != 0 ||
      cout % groups != 0 || res_kind < 0 || res_kind > 2 || relu < 0 || relu > 2 ||
      (res_kind != 0 && residual == nullptr) || x == nullptr || w == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.scale = scale;
  a.shift = shift;
  a.residual = residual;
  a.out = out;
  a.res_kind = res_kind;
  a.relu = relu;
  a.out_bf16 = out_bf16;
  a.h = h;
  a.w_in = w_in;
  a.cin = cin;
  a.ho = ho;
  a.wo = wo;
  a.cout = cout;
  a.kw = kw;
  a.stride = stride;
  a.pad = pad;
  a.cin_g = cin / groups;
  a.cout_g = cout / groups;
  a.k_g = kh * kw * a.cin_g;
  const long long m = (long long)batch * ho * wo;
  if (m > 0x7fffffffLL || a.cout_g % 4 != 0 || a.cin_g % 4 != 0)
    return (int)cudaErrorInvalidValue;
  a.m = (int)m;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(residual) |
                          reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift);
  if (bases % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a.cin_g % 8 == 0 ? launch_vec<8>(a, groups, s) : launch_vec<4>(a, groups, s));
}

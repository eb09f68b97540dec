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
// k = (r, s, c) ordered as the packed weights are. The accumulator never
// leaves fp32 before the epilogue, which multiplies and adds with separate
// roundings (__fmul_rn, __fadd_rn), as the plain version in
// dirjax_torch/ops/conv.py does: the output is dirjax's fp32 convolution
// output carried through its fp32 epilogue, rounded once at the end.
//
// What bounds it: at resnet101_rmac's shapes (batch 8, 1024x768) one
// forward's 104 convolutions do 1.96 TFLOP (1.98 ms at 989 TFLOP/s) and, each
// operand read once and each output written once, move about 11 GB (3.3 ms
// at 3.35 TB/s): most layers are bound by their bytes, the 3x3 layers of the
// deeper stages by their operations.
//
// Three paths, chosen from the shape alone (dirjax_conv_path below); a shape
// none takes is refused:
//
// wgmma (groups == 1, cin and cout multiples of 64: every convolution of
// the ResNets but the stem, and the FPN merge; and, over 64-channel spans,
// every grouped 3x3 of ResNeXt: see spans below). A persistent CTA on each SM
// walks (128-pixel, BN-channel) output tiles, BN = 128, or 64 where cout is
// not a multiple of 128, channel tiles fastest so that CTAs running
// together share one pixel tile's input in L2. Three warpgroups:
//   - a producer (one thread, registers lowered by setmaxnreg) keeps a
//     160 KB ring of K stages in flight on mbarriers: each stage is 64 of K
//     (one (r, s) tap, 64 channels), the input's 128 x 64 and the weights'
//     BN x 64 bf16, each a TMA box in the 128-byte swizzle that wgmma reads.
//     The weights are a (cout, kh*kw*cin) matrix; the input is the
//     (B*H*W, cin) matrix of a 1x1 stride-1 convolution, else a 4-D NHWC
//     tensor read in TMA's im2col mode: the box is 128 output pixels'
//     windows at the stage's tap, and its out-of-bounds zero fill is the
//     convolution's zero padding and the ragged last tile. The tensor maps
//     are encoded on the host (the encoders reached through
//     cudaGetDriverEntryPoint; the weights' once per packed weight, the
//     input's per call, kept for the buffers a forward meets again) and
//     passed as __grid_constant__ parameters.
//   - two consumers, each 64 pixels x BN of the tile: four wgmma m64nBNk16
//     a stage from the swizzled stage (descriptors of csrc/tc_score.cuh),
//     fp32 accumulators in registers, one stage's wgmmas in flight while
//     the one before is released to the producer. The producer runs on into
//     the next tile while the consumers' epilogue runs: the K = 256 1x1
//     layers, 4 stages a tile, no longer wait for a ring fill per tile.
//   - the epilogue: at the tile's start each consumer thread issues the
//     loads of its scale, shift and residual for the whole tile (the
//     residual kind is a template parameter, so the loads carry no branch
//     and none is used before the wgmmas end: a bf16 residual widened as it
//     was loaded made each load wait, 2x the time at these shapes); after
//     the wgmmas it stages its accumulators 64 channels at a time in shared
//     memory (apart from the ring) and each thread takes 4 consecutive
//     channels of 8 pixels: 16-byte reads of the staged sums, 8- or 16-byte
//     stores. A thread holds 64 accumulators and up to 64 registers of
//     residual, which is why BN stays at 128 (at 256 it read slower as
//     well: 192 tiles at R101's stage 3 are 1.45 waves of 132 SMs).

// wgmma over a grouped convolution's 64-channel spans (as many channels
// out as in, cin / groups dividing 64, cin a multiple of 64): the same
// kernel with BN 64, a tile's K cut to its span. Tile (128 pixels, the 64
// outputs of span s) takes kh * kw stages, each one im2col box of input
// channels 64s .. 64s + 63 at one tap (the dense path's 128-byte-swizzled
// full-row box) against that tap's block-diagonal 64 x 64 weight block:
// the input is read in whole 128-byte rows once a span and tap, and each
// stage is a dense wgmma, where one group's channels a CTA would fill N
// tiles three quarters empty at g = 4.
//
// stem (groups == 1, at most 4 input channels, 64 outputs, kh, kw <= 7,
// stride <= 2: the 7x7/2 stem of every architecture). What bounds it is
// its bytes: at batch 8, 1024x768, 75.5 MB of fp32 input and 201.3 MB of
// bf16 output (0.083 ms) against 41.9 GFLOP (0.042 ms). It reads the input
// where it lies, fp32 or bf16 NHWC: the wrapper makes no copy of it.
// Persistent CTAs, two an SM, each of two warpgroups, walk tiles of
// 8 x 16 output pixels. For each tile a CTA
//   - copies the input rows under the tile's windows (21 runs of 37
//     pixels, each contiguous in NHWC) into shared memory with 16-byte
//     cp.async: each input byte crosses from L2 about 1.4 times, where
//     strips of one output row read each input row 3.5 times;
//   - widens them once into 8-byte pixels of 4 bf16 channels (round to
//     nearest even, as .to(torch.bfloat16); the fourth channel and the
//     padding zero), then issues the next tile's copies;
//   - has each thread load its wgmma A fragments (m16n8k16 layout: two
//     pixels, two taps a k16 step, two channels each) from the widened
//     rows, one conflict-free 4-byte load a register, and multiply them on
//     wgmma m64n64k16 with A from registers against the 64 x 208 weights
//     staged once a CTA: no operand is written to shared memory;
//   - stages the sums in shared memory so that a warp stores 256
//     contiguous bytes of the epilogue's output.
// The other CTA on the SM runs meanwhile: one CTA an SM (8 warps) left
// each tile's chain of shared-memory loads and stores exposed.

#include <cuda.h>   // CUtensorMap and its encoders' types only: nothing more is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

#include "smem_opt_in.cuh"
#include "tc_score.cuh"   // sw128, the wgmma fence / commit / wait, cp_async_commit / wait

namespace {

// The epilogue's operands, shared by every path.
struct Epilogue {
  const float* scale;         // (cout,) or null
  const float* shift;         // (cout,) or null
  const void* residual;       // (batch, ho, wo, cout), bf16 or fp32, or null
  void* out;                  // (batch, ho, wo, cout), bf16 or fp32
  int res_kind;               // 0 none, 1 bf16, 2 fp32
  int relu;                   // 0 none, 1 before the residual add, 2 after it
  int out_bf16;
  int cout;
};

// The residual of output channels n .. n + 3 of pixel m as it is stored
// (RES 1: four bf16, 2: four fp32, 0: none), loaded with no use of its
// value, so that a thread's loads for many pixels are all in flight at
// once, and widened to fp32 where it is used.
template <int RES> struct Residual;
template <> struct Residual<0> {
  struct Raw {};
  __device__ __forceinline__ static Raw load(const Epilogue&, long long, int) { return {}; }
  __device__ __forceinline__ static float4 get(Raw) { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Residual<1> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const Epilogue& a, long long m, int n) {
    return __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(a.residual) + m * a.cout + n));
  }
  __device__ __forceinline__ static float4 get(Raw raw) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};
template <> struct Residual<2> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const Epilogue& a, long long m, int n) {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.residual) +
                                                 m * a.cout + n));
  }
  __device__ __forceinline__ static float4 get(Raw raw) { return raw; }
};

// One output element from its fp32 sum: the multiply and the adds rounded
// apart, as the plain version's separate fp32 ops round them; r is the
// residual (0 without one, whose add then leaves v as it is).
__device__ __forceinline__ float epilogue(const Epilogue& a, float v, float sc, float sh,
                                          float r) {
  if (a.scale) v = __fmul_rn(v, sc);
  if (a.shift) v = __fadd_rn(v, sh);
  if (a.relu == 1) v = fmaxf(v, 0.f);
  if (a.res_kind) v = __fadd_rn(v, r);
  if (a.relu == 2) v = fmaxf(v, 0.f);
  return v;
}

// The epilogue's per-channel and residual operands of output channels
// n .. n + 3 (of pixel m), read through the read-only path.
__device__ __forceinline__ float4 scale4(const Epilogue& a, int n) {
  return a.scale ? __ldg(reinterpret_cast<const float4*>(a.scale + n))
                 : make_float4(1.f, 1.f, 1.f, 1.f);
}
__device__ __forceinline__ float4 shift4(const Epilogue& a, int n) {
  return a.shift ? __ldg(reinterpret_cast<const float4*>(a.shift + n))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float4 residual4(const Epilogue& a, long long m, int n) {
  if (a.res_kind == 1) return Residual<1>::get(Residual<1>::load(a, m, n));
  if (a.res_kind == 2) return Residual<2>::load(a, m, n);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Output channels n .. n + 3 of pixel m from their four fp32 sums and the
// operands above: an 8- or 16-byte store.
__device__ __forceinline__ void store4(const Epilogue& a, float4 acc, float4 sc, float4 sh,
                                       float4 r, long long m, int n) {
  const long long off = m * a.cout + n;
  const float v0 = epilogue(a, acc.x, sc.x, sh.x, r.x), v1 = epilogue(a, acc.y, sc.y, sh.y, r.y);
  const float v2 = epilogue(a, acc.z, sc.z, sh.z, r.z), v3 = epilogue(a, acc.w, sc.w, sh.w, r.w);
  if (a.out_bf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + off) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(a.out) + off) = make_float4(v0, v1, v2, v3);
  }
}

// --------------------------------------------------------------------------
// The wgmma path
// --------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;                 // output pixels a tile: two consumers of 64
constexpr int kBK = 64;                  // K a stage: one 128-byte swizzled row of bf16
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr int kRingBytes = 160 * 1024;
constexpr int kEpiCols = 64;             // fp32 columns a consumer stages at a time
constexpr int kEpiRow = kEpiCols + 8;    // a staged row in floats (float2 stores hit no bank twice)
constexpr int kEpiBytes = 2 * 64 * kEpiRow * 4;
constexpr int kAlign = 1024;             // the 128-byte swizzle's atom

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = kBM * 128;
  static constexpr int STAGE_BYTES = A_BYTES + BN * 128;
  static constexpr int STAGES = kRingBytes / STAGE_BYTES;   // 5 (BN 128) or 6 (BN 64)
  static constexpr int SMEM = kAlign + STAGES * STAGE_BYTES + kEpiBytes + 2 * STAGES * 8;
  static_assert(SMEM <= kMaxSmemBytes, "shared memory");
};

struct Args {
  Epilogue epi;
  int m;              // batch * ho * wo
  int ho, wo, stride, pad, kw;
  int cblocks;        // cin / 64 (1 for a grouped conv: its span)
  int kt;             // K stages a tile: kh * kw * cblocks
  int n_tiles;        // channel tiles
  int tiles;          // pixel tiles * channel tiles
  int im2col;         // 0: the input is the (m, cin) matrix of a 1x1 stride-1 conv
  int spans;          // 1: a grouped conv over 64-channel spans (BN 64), whose tile at
                      // channels n0 .. n0 + 63 reads input channels n0 .. n0 + 63 alone
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// 128 output pixels' windows, starting at input pixel (w, h) of image n (the
// window's top-left corner: negative inside the padding), each at tap (r, s)
// of its window: channels c .. c + 63 of each.
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int c, int w, int h, int n, int s, int r) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
        "r"(n), "h"((uint16_t)s), "h"((uint16_t)r)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int BN, int RES>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const Args a) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  float* staged = reinterpret_cast<float*>(ring + C::STAGES * C::STAGE_BYTES);
  const uint32_t full0 = smem_u32(ring + C::STAGES * C::STAGE_BYTES + kEpiBytes);
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  const uint32_t ring0 = smem_u32(ring);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's expect_tx; TMA's bytes
      mbar_init(empty0 + 8 * s, 8);       // each consumer warp, once its wgmmas are done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int m0 = (tile / a.n_tiles) * kBM, n0 = (tile % a.n_tiles) * BN;
        int wi = 0, hi = 0, b = 0;
        if (a.im2col) {
          const int hw = a.ho * a.wo;
          b = m0 / hw;
          const int rem = m0 - b * hw, ho = rem / a.wo;
          hi = ho * a.stride - a.pad;
          wi = (rem - ho * a.wo) * a.stride - a.pad;
        }
        const int c0 = a.spans ? n0 : 0;   // a span's tile reads its own channels
        for (int kt = 0, rs = 0, cb = 0; kt < a.kt; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t dst = ring0 + stage * C::STAGE_BYTES;
          mbar_expect_tx(full, C::STAGE_BYTES);
          if (a.im2col) {
            const int r = rs / a.kw;
            tma_im2col(dst, &xmap, full, c0 + cb * kBK, wi, hi, b, rs - r * a.kw, r);
          } else {
            tma_2d(dst, &xmap, full, c0 + cb * kBK, m0);
          }
          tma_2d(dst + C::A_BYTES, &wmap, full, kt * kBK, n0);
          if (++cb == a.cblocks) { cb = 0; ++rs; }
          if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    using dirjax_wgmma::Wgmma;
    const int half = threadIdx.x / 128 - 1;           // this consumer's 64 pixels of a tile
    const int ctid = threadIdx.x & 127, warp = ctid >> 5, lane = ctid & 31;
    float* mine = staged + half * 64 * kEpiRow;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    // the epilogue's layout: a thread takes 4 channels of P staged rows, RPP
    // apart; its channels stay the same through a pass
    constexpr int CPR = kEpiCols / 4, RPP = 128 / CPR, P = 64 / RPP;
    const int c = (ctid % CPR) * 4, r0 = ctid / CPR;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int m0 = (tile / a.n_tiles) * kBM, n0 = (tile % a.n_tiles) * BN;
      const int mrow = m0 + 64 * half + r0;   // this thread's first row of the epilogue
      // the whole tile's scale, shift and residual, read while the wgmmas
      // run (a row past M reads row M - 1 and stores nothing): the epilogue
      // then waits on no load of its own
      constexpr int PASSES = BN / kEpiCols;
      static_assert(BN % kEpiCols == 0, "epilogue passes");
      typename Residual<RES>::Raw res[PASSES][P];
      float4 sc[PASSES], sh[PASSES];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        sc[p] = scale4(a.epi, n0 + kEpiCols * p + c);
        sh[p] = shift4(a.epi, n0 + kEpiCols * p + c);
#pragma unroll
        for (int i = 0; i < P; ++i)
          res[p][i] = Residual<RES>::load(a.epi, min(mrow + RPP * i, a.m - 1),
                                          n0 + kEpiCols * p + c);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < a.kt; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t sa = ring0 + stage * C::STAGE_BYTES + half * 64 * 128;
        const uint32_t sb = ring0 + stage * C::STAGE_BYTES + C::A_BYTES;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)    // 32 bytes of each row a k16 step
          Wgmma<BN>::run(acc, sw128(sa + 32 * k), sw128(sb + 32 * k));
        wgmma_commit();
        wgmma_wait_group<1>();   // the stage before this one has been read: release it
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == C::STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait_group<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // epilogue, kEpiCols channels a pass through this consumer's staging
      // rows (BN divides cout: every channel of the tile exists). Fragment j
      // (channels 8j .. 8j + 7) holds rows g and g + 8 of the warp's 16,
      // channels 8j + 2t and 8j + 2t + 1.
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int n = n0 + kEpiCols * p + c;
        named_sync(1 + half);   // the pass before has read the staging rows
#pragma unroll
        for (int jj = 0; jj < kEpiCols / 8; ++jj) {
          const int j = kEpiCols / 8 * p + jj, col = 8 * jj + 2 * t;
          *reinterpret_cast<float2*>(mine + (16 * warp + g) * kEpiRow + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(mine + (16 * warp + g + 8) * kEpiRow + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        named_sync(1 + half);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int m = mrow + RPP * i;
          if (m < a.m)
            store4(a.epi, *reinterpret_cast<const float4*>(mine + (r0 + RPP * i) * kEpiRow + c),
                   sc[p], sh[p], Residual<RES>::get(res[p][i]), m, n);
        }
      }
    }
  }
}

// The tensor-map encoders, looked up through the runtime's
// cudaGetDriverEntryPoint once per process (so that the library links
// nothing new).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

struct Encoders {
  EncodeTiled tiled = nullptr;
  EncodeIm2col im2col = nullptr;
};

void* entry_point(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn : nullptr;
}

const Encoders& encoders() {
  static const Encoders e = [] {
    Encoders r;
    r.tiled = reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
    r.im2col = reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
    return r;
  }();
  return e;
}

// A grouped convolution that the wgmma path takes over 64-channel spans: as
// many channels out as in, g = cin / groups dividing 64, cin a multiple of
// 64 (every grouped 3x3 of ResNeXt-101 32x4d: g = 4, 8, 16, 32). Its weights
// are packed (cout, kh, kw, 64): row n holds, at each tap, the 64 input
// channels of its span n / 64, zero outside n's own group, a block-diagonal
// 64 x 64 block a tap (ops/conv.py::span_weights). The zeros add exact zeros
// to the fp32 sums; the tensor work grows by 64 / g, which at g = 4 and 8
// still sits at or under the bytes (58 GFLOP, 0.059 ms, at ResNeXt's first
// stage against a 0.060 ms bound from its bytes).
bool spans(int cin, int cout, int groups) {
  return groups > 1 && cin == cout && cin % groups == 0 && 64 % (cin / groups) == 0 &&
         cin % 64 == 0;
}

// The tile width of the wgmma path for this shape, 0 where it does not take
// it (channels not multiples of 64, or grouped without spans). 128 rather
// than 256: a consumer thread holds its 64 accumulators and the tile's
// residual (another 64) at once, and at R101's stage 3 (M = 24,576)
// 128-wide tiles make 384 tiles a 256-channel conv, 2.9 waves of 132 SMs
// where 256-wide make 192, 1.45. A span is 64 wide.
int tile_width(int cin, int cout, int groups) {
  if (spans(cin, cout, groups)) return 64;
  if (groups != 1 || cin % 64 != 0 || cout % 64 != 0) return 0;
  return cout % 128 == 0 ? 128 : 64;
}

// K of a packed weight row on the wgmma path: every input channel, or a span's.
long long packed_k(int cin, int groups, int kh, int kw) {
  return (long long)kh * kw * (groups == 1 ? cin : kBK);
}

// A 2-D bf16 matrix of `rows` rows of `cols`, read in (box_rows, 64) boxes in
// the 128-byte swizzle.
cudaError_t encode_matrix(CUtensorMap* map, const void* base, long long rows, long long cols,
                          int box_rows) {
  if (encoders().tiled == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encoders().tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The NHWC input in im2col mode: 128 output pixels' windows a box, 64
// channels each, traversed with the convolution's stride over the box of
// window corners [-pad, dim + pad - k] (zero-filled outside the image).
cudaError_t encode_im2col(CUtensorMap* map, const void* x, int batch, int h, int w, int cin,
                          int kh, int kw, int stride, int pad) {
  if (encoders().im2col == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)w * cin * 2,
                                 (cuuint64_t)h * w * cin * 2};
  const int lower[2] = {-pad, -pad};                       // w, h
  const int upper[2] = {pad - (kw - 1), pad - (kh - 1)};
  const cuuint32_t steps[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const CUresult res = encoders().im2col(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, lower,
      upper, (cuuint32_t)kBK, (cuuint32_t)kBM, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The last kMapSlots input tensor maps, by what they encode: a forward
// meets the same activation buffers (the caching allocator hands them out
// again) at the same shapes call after call, and an encode costs the host
// microseconds. A map is a function of its key alone, so a hit is the map
// the encoder would make.
struct MapKey {
  const void* x;
  int batch, h, w, cin, kh, kw, stride, pad, im2col;
  bool operator==(const MapKey& o) const { return memcmp(this, &o, sizeof(*this)) == 0; }
};
constexpr int kMapSlots = 64;

cudaError_t input_map(CUtensorMap* map, const MapKey& key, long long m) {
  static std::mutex mu;
  static MapKey keys[kMapSlots];
  static CUtensorMap maps[kMapSlots];
  static int filled = 0, next = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < filled; ++i)
      if (keys[i] == key) {
        *map = maps[i];
        return cudaSuccess;
      }
  }
  const cudaError_t err =
      key.im2col ? encode_im2col(map, key.x, key.batch, key.h, key.w, key.cin, key.kh, key.kw,
                                 key.stride, key.pad)
                 : encode_matrix(map, key.x, m, key.cin, kBM);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapSlots;
  if (filled < kMapSlots) ++filled;
  return cudaSuccess;
}

constexpr int kMaxDevices = 64;

// The current device's SM count, read once a device: the persistent grids.
cudaError_t sm_count(int* sms) {
  static std::atomic<int> sms_on[kMaxDevices];   // 0: not yet known
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sms_on[dev].load(std::memory_order_acquire);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms_on[dev].store(*sms, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int BN, int RES>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const Args& a,
                   cudaStream_t stream) {
  auto kernel = conv_wgmma_kernel<BN, RES>;
  static OptInFlags opted;
  cudaError_t err = opt_in_once(kernel, Cfg<BN>::SMEM, Cfg<BN>::SMEM, opted);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  kernel<<<a.tiles < sms ? a.tiles : sms, kThreads, Cfg<BN>::SMEM, stream>>>(xmap, wmap, a);
  return cudaGetLastError();
}

}  // namespace wg

// --------------------------------------------------------------------------
// The stem path
// --------------------------------------------------------------------------

namespace stem {

constexpr int kTileH = 8, kTileW = 16;     // output pixels a tile: rows x columns
constexpr int kPix = kTileH * kTileW;      // 128: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 2;
constexpr int kCout = 64;
constexpr int kTapK = 4;                   // K a tap: the weights' channels, padded to 4
constexpr int kMaxKernel = 7;              // kh, kw at most
constexpr int kMaxStride = 2;
constexpr int kMaxTaps = kMaxKernel * kMaxKernel;
constexpr int kMaxSteps = (kTapK * kMaxTaps + 15) / 16;   // 13 k16 steps: K 196 padded to 208
constexpr int kBlocks = (16 * kMaxSteps + 63) / 64;       // the weights' 64-wide K blocks
constexpr int kBBlock = kCout * 128;
constexpr int kEpiRow = kCout + 8;         // a staged output row in floats
constexpr int kEpiBytes = kPix * kEpiRow * 4;
constexpr int kMaxRows = (kTileH - 1) * kMaxStride + kMaxKernel;   // 21 input rows a tile

bool takes(int cin, int cout, int groups, int kh, int kw, int stride) {
  return groups == 1 && cin <= kTapK && cout == kCout && kh <= kMaxKernel &&
         kw <= kMaxKernel && stride <= kMaxStride;
}

struct Args {
  const unsigned char* x;     // (batch, h, w, c) fp32 or bf16, as the caller holds it
  const __nv_bfloat16* w;     // (64, kh, kw, 4) bf16
  Epilogue epi;
  long long x_bytes;          // the input's bytes: no copy reads past them
  int h, w_in, c, ho, wo, kh, kw, stride, pad;
  int taps, ksteps;           // kh * kw; 4 * taps in k16 steps
  int rows, cols;             // a tile's input rows and columns (its windows' extent)
  int tiles_h, tiles_w, tiles;
  int slot;                   // bytes of a staged input row
};

// One tile: output rows ho0 .. ho0 + 7, columns wo0 .. wo0 + 15 of image b
// (those past the image computed and not stored), whose windows cover input
// rows hstart + [0, a.rows) and columns wstart + [0, a.cols); of those,
// columns [wlo, whi) lie in the image.
struct Tile {
  int b, ho0, wo0, hstart, wstart, wlo, whi;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int s) {
  Tile t;
  const int j = s % a.tiles_w, rest = s / a.tiles_w;
  t.ho0 = (rest % a.tiles_h) * kTileH;
  t.b = rest / a.tiles_h;
  t.wo0 = j * kTileW;
  t.hstart = t.ho0 * a.stride - a.pad;
  t.wstart = t.wo0 * a.stride - a.pad;
  t.wlo = max(t.wstart, 0);
  t.whi = min(t.wstart + a.cols, a.w_in);
  return t;
}

// Issue the copies of tile s's input rows into `rows` (a.rows staged rows of
// a.slot bytes): each row's run of [wlo, whi) pixels is contiguous in NHWC,
// copied in 16-byte cp.async chunks from the 16-byte boundary at or before
// its first byte, which lands delta[r] bytes into the staged row. Rows
// outside the image are not copied.
template <int ESIZE>
__device__ __forceinline__ void issue(const Args& a, int s, unsigned char* rows, int* delta,
                                      int tid) {
  const Tile t = tile_at(a, s);
  const int pbytes = a.c * ESIZE;
  const int len = max(t.whi - t.wlo, 0) * pbytes;
  const int nch = (len + 15) / 16 + 1;   // a row's chunks at most (a misaligned start: one more)
  for (int i = tid; i < a.rows * nch; i += kThreads) {
    const int r = i / nch, ch = i - r * nch;
    const int hi = t.hstart + r;
    if (hi < 0 || hi >= a.h || len == 0) continue;
    const long long first = ((long long)(t.b * a.h + hi) * a.w_in + t.wlo) * pbytes;
    const long long aligned = first & ~15LL;
    const int d = (int)(first - aligned);
    if (ch == 0) delta[r] = d;
    if (16 * ch >= d + len) continue;
    const long long off = aligned + 16LL * ch;
    const long long left = a.x_bytes - off;   // > 0: the chunk starts inside the row's run
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(rows + r * a.slot + 16 * ch)), "l"(a.x + off),
                 "r"(left < 16 ? (int)left : 16) : "memory");
  }
}

// Tile t's staged rows as the fragments read them: input row hstart + r,
// column wstart + q as 4 bf16 channels, 8 bytes at wide[r * a.cols + q],
// each value rounded to bf16 to nearest even (as .to(torch.bfloat16)); the
// channels past a.c and the rows and columns outside the image (the
// convolution's padding) are zero. Each input value is rounded once a tile.
template <bool F32>
__device__ __forceinline__ void widen_rows(const Args& a, const Tile& t,
                                           const unsigned char* rows, const int* delta,
                                           uint2* wide, int tid) {
  constexpr int ESIZE = F32 ? 4 : 2;
  const int pbytes = a.c * ESIZE;
  for (int i = tid; i < a.rows * a.cols; i += kThreads) {
    const int r = i / a.cols, col = t.wstart + (i - r * a.cols);
    uint2 v = make_uint2(0u, 0u);
    if ((unsigned)(t.hstart + r) < (unsigned)a.h && col >= t.wlo && col < t.whi) {
      const unsigned char* px = rows + r * a.slot + delta[r] + (col - t.wlo) * pbytes;
      if constexpr (F32) {
        const float* q = reinterpret_cast<const float*>(px);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(q[0], a.c > 1 ? q[1] : 0.f);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(a.c > 2 ? q[2] : 0.f, a.c > 3 ? q[3] : 0.f);
        v = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      } else {
        const uint16_t* q = reinterpret_cast<const uint16_t*>(px);
        v = make_uint2((uint32_t)q[0] | (a.c > 1 ? (uint32_t)q[1] << 16 : 0u),
                       (a.c > 2 ? (uint32_t)q[2] : 0u) | (a.c > 3 ? (uint32_t)q[3] << 16 : 0u));
      }
    }
    wide[i] = v;
  }
}

// This thread's wgmma A fragments, from the widened rows: the m16n8k16
// layout of the warp's 16 rows (tile pixels pa and pa + 8: output row
// pa / 16, columns pa % 16 and + 8), k16 step j holding taps 4j + (t4 >> 1)
// (registers 0, 1) and 4j + 2 + (t4 >> 1) (2, 3), channels c0 and c0 + 1 of
// each (k = 4 tap + c): one 4-byte load a register, the 8 rows of a warp's
// load 8 pixels a stride apart, on distinct banks. tap_off[tap] is the
// tap's byte offset in the widened rows, -1 past the taps (K's pad: zero).
__device__ __forceinline__ void load_fragments(const Args& a, const unsigned char* wide,
                                               const int* tap_off, int pa, int t4,
                                               uint32_t (&f)[kMaxSteps][4]) {
  const unsigned char* px0 =
      wide + ((pa / kTileW) * a.cols + pa % kTileW) * a.stride * 8 + 4 * (t4 & 1);
  const unsigned char* px1 = px0 + 8 * a.stride * 8;
#pragma unroll
  for (int j = 0; j < kMaxSteps; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = tap_off[4 * j + 2 * half + (t4 >> 1)];
      f[j][2 * half] = off >= 0 ? *reinterpret_cast<const uint32_t*>(px0 + off) : 0u;
      f[j][2 * half + 1] = off >= 0 ? *reinterpret_cast<const uint32_t*>(px1 + off) : 0u;
    }
  }
}

template <bool F32>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) stem_kernel(const Args a) {
  constexpr int ESIZE = F32 ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* tile = reinterpret_cast<float*>(sb + kBlocks * kBBlock);
  int* tap_off = reinterpret_cast<int*>(sb + kBlocks * kBBlock + kEpiBytes);   // [4 * kMaxSteps]
  int* delta = tap_off + 4 * kMaxSteps;                                        // [kMaxRows]
  unsigned char* rows = reinterpret_cast<unsigned char*>(delta + kMaxRows + 3);   // 16-aligned
  uint2* wide = reinterpret_cast<uint2*>(rows + a.rows * a.slot);
  const int tid = threadIdx.x;

  // the first tile's rows in flight while the weights are staged
  int s = blockIdx.x;
  issue<ESIZE>(a, s, rows, delta, tid);
  cp_async_commit();
  // each tap's offset in the widened rows; the weights in the 128-byte
  // swizzle, K zero-padded to the blocks' end, resident for the CTA's life
  // (rows of 4 * taps bf16: 8-byte aligned)
  for (int i = tid; i < 4 * kMaxSteps; i += kThreads)
    tap_off[i] = i < a.taps ? ((i / a.kw) * a.cols + i % a.kw) * 8 : -1;
  const int K = kTapK * a.taps;
  for (int i = tid; i < kCout * kBlocks * 8; i += kThreads) {
    const int n = i / (kBlocks * 8), ch = i - n * kBlocks * 8;
    const __nv_bfloat16* row = a.w + (long long)n * K + 8 * ch;
    uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
    if (8 * ch < K) lo = __ldg(reinterpret_cast<const uint2*>(row));
    if (8 * ch + 4 < K) hi = __ldg(reinterpret_cast<const uint2*>(row + 4));
    *reinterpret_cast<uint4*>(sb + (ch >> 3) * kBBlock + swz(n, ch & 7)) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  fence_async_smem();

  const int wgi = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2;
  const int t4 = lane & 3, pa = 64 * wgi + 16 * warp + g;
  // the epilogue: this thread's 4 channels of tile column x = tid >> 4, all
  // 8 rows (a warp stores two adjacent pixels' 64 channels: 256 bytes)
  const int c4 = (tid & 15) * 4, x = tid >> 4;
  const float4 sc = scale4(a.epi, c4), sh = shift4(a.epi, c4);
  const uint32_t b0 = smem_u32(sb);
  float acc[kCout / 2];
  for (; s < a.tiles; s += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();   // the tile's rows are in; the tile before is done with the rest
    const Tile t = tile_at(a, s);
    widen_rows<F32>(a, t, rows, delta, wide, tid);
    __syncthreads();   // the widened rows are written: the staged rows are free
    const int next = s + gridDim.x;
    if (next < a.tiles) issue<ESIZE>(a, next, rows, delta, tid);
    cp_async_commit();
    uint32_t f[kMaxSteps][4];
    load_fragments(a, reinterpret_cast<const unsigned char*>(wide), tap_off, pa, t4, f);

#pragma unroll
    for (int j = 0; j < kCout / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kCout / 2; ++j) pin(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kMaxSteps; ++j)   // a k16 step is 32 bytes of each weight row
      if (j < a.ksteps)
        dirjax_wgmma::Wgmma<kCout>::run(acc, f[j], sw128(b0 + (j >> 2) * kBBlock + 32 * (j & 3)));
    wgmma_commit();
    wgmma_wait_group<0>();
#pragma unroll
    for (int j = 0; j < kCout / 2; ++j) pin(acc[j]);

    // fragment j holds rows g and g + 8 of the warp's 16, channels 8j + 2t, + 1
    const int col0 = 2 * t4;
#pragma unroll
    for (int j = 0; j < kCout / 8; ++j) {
      *reinterpret_cast<float2*>(tile + pa * kEpiRow + 8 * j + col0) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(tile + (pa + 8) * kEpiRow + 8 * j + col0) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncthreads();   // the sums are staged; every thread's fragments are read
    if (t.wo0 + x < a.wo) {
      const int rows_in = min(kTileH, a.ho - t.ho0);
      const long long m0 = ((long long)t.b * a.ho + t.ho0) * a.wo + t.wo0 + x;
      for (int y = 0; y < rows_in; ++y) {
        const long long m = m0 + (long long)y * a.wo;
        store4(a.epi, *reinterpret_cast<const float4*>(tile + (y * kTileW + x) * kEpiRow + c4),
               sc, sh, residual4(a.epi, m, c4), m, c4);
      }
    }
  }
  cp_async_wait<0>();
}

cudaError_t launch(Args& a, int batch, int x_fp32, cudaStream_t stream) {
  const int esize = x_fp32 ? 4 : 2;
  a.taps = a.kh * a.kw;
  a.ksteps = (kTapK * a.taps + 15) / 16;
  a.rows = (kTileH - 1) * a.stride + a.kh;
  a.cols = (kTileW - 1) * a.stride + a.kw;
  a.tiles_h = (a.ho + kTileH - 1) / kTileH;
  a.tiles_w = (a.wo + kTileW - 1) / kTileW;
  const long long tiles = (long long)batch * a.tiles_h * a.tiles_w;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.slot = ((a.cols * a.c * esize + 15) / 16 + 1) * 16;
  const int smem = 1024 + kBlocks * kBBlock + kEpiBytes + 4 * (4 * kMaxSteps + kMaxRows + 3) +
                   a.rows * a.slot + a.rows * a.cols * 8;
  static OptInFlags opted[2];
  auto kernel = x_fp32 ? stem_kernel<true> : stem_kernel<false>;
  cudaError_t err = opt_in_once(kernel, kMaxSmemBytes / kCtasPerSm, smem, opted[x_fp32 ? 1 : 0]);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = wg::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int grid = a.tiles < kCtasPerSm * sms ? a.tiles : kCtasPerSm * sms;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace stem

}  // namespace

// The path a convolution of this shape takes, the rule dirjax_conv_fused
// follows: 128 or 64, the wgmma path at that tile width; 2, the wgmma path
// over a grouped convolution's 64-channel spans; 1, the stem path; 0, no
// path (dirjax_conv_fused refuses the shape).
extern "C" int dirjax_conv_path(int cin, int cout, int groups, int kh, int kw, int stride) {
  if (wg::spans(cin, cout, groups)) return 2;
  if (const int bn = wg::tile_width(cin, cout, groups)) return bn;
  return stem::takes(cin, cout, groups, kh, kw, stride) ? 1 : 0;
}

// The TMA tensor map of packed weights w (cout, kh, kw, cin / groups; a
// grouped conv over spans: (cout, kh, kw, 64)) for the wgmma path, written to
// map (128 bytes of host memory); all zeros for a shape the wgmma path does
// not take. Returns a cudaError_t.
extern "C" int dirjax_conv_weight_map(const void* w, int cin, int cout, int kh, int kw,
                                      int groups, void* map) {
  if (w == nullptr || map == nullptr || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      groups <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  memset(&m, 0, sizeof(m));
  const int bn = wg::tile_width(cin, cout, groups);
  if (bn) {
    const cudaError_t err = wg::encode_matrix(&m, w, cout, wg::packed_k(cin, groups, kh, kw), bn);
    if (err != cudaSuccess) return (int)err;
  }
  memcpy(map, &m, sizeof(m));
  return (int)cudaSuccess;
}

// x: (batch, h, w, cin) bf16, or fp32 where x_fp32 (the stem path only);
// w: (cout, kh, kw, cin / groups) bf16 ((cout, kh, kw, 64) for a grouped conv
// over spans, (64, kh, kw, 4) for the stem path: cin padded with zero
// channels), and wmap its dirjax_conv_weight_map (host memory; null: built
// here); scale, shift: (cout,) fp32 or null; residual: (batch, ho, wo, cout)
// of res_kind (0 none, 1 bf16, 2 fp32); relu: 0 none, 1 before the residual
// add, 2 after it; out: (batch, ho, wo, cout), bf16 if out_bf16 else fp32.
// cin / groups (but on the stem path) and cout / groups must be multiples of
// 4 and every pointer 16-byte aligned (the epilogue moves 4 channels at a
// time). The path follows from the shape (dirjax_conv_path); a shape no
// path takes returns cudaErrorInvalidValue. Returns a cudaError_t.
extern "C" int dirjax_conv_fused(const void* x, int x_fp32, const void* w, const void* wmap,
                                 const float* scale, const float* shift, const void* residual,
                                 int res_kind, int relu, void* out, int out_bf16, int batch,
                                 int h, int w_in, int cin, int cout, int kh, int kw, int stride,
                                 int pad, int groups, int ho, int wo, void* stream) {
  if (batch <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || groups <= 0 || ho <= 0 || wo <= 0 || cin % groups != 0 ||
      cout % groups != 0 || res_kind < 0 || res_kind > 2 || relu < 0 || relu > 2 ||
      (res_kind != 0 && residual == nullptr) || x == nullptr || w == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)batch * ho * wo;
  const int path = dirjax_conv_path(cin, cout, groups, kh, kw, stride);
  if (path == 0 || m > 0x7fffffffLL || (cout / groups) % 4 != 0 ||
      (path != 1 && (cin / groups) % 4 != 0) || (x_fp32 && path != 1))
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(residual) |
                          reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift);
  if (bases % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Epilogue epi;
  epi.scale = scale;
  epi.shift = shift;
  epi.residual = residual;
  epi.out = out;
  epi.res_kind = res_kind;
  epi.relu = relu;
  epi.out_bf16 = out_bf16;
  epi.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (path == 1) {
    stem::Args a;
    a.x = static_cast<const unsigned char*>(x);
    a.w = static_cast<const __nv_bfloat16*>(w);
    a.epi = epi;
    a.x_bytes = (long long)batch * h * w_in * cin * (x_fp32 ? 4 : 2);
    a.h = h;
    a.w_in = w_in;
    a.c = cin;
    a.ho = ho;
    a.wo = wo;
    a.kh = kh;
    a.kw = kw;
    a.stride = stride;
    a.pad = pad;
    return (int)stem::launch(a, batch, x_fp32, s);
  }

  const int bn = wg::tile_width(cin, cout, groups);
  alignas(64) CUtensorMap xmap, wm;
  if (wmap != nullptr) {
    memcpy(&wm, wmap, sizeof(wm));
  } else {
    const cudaError_t err =
        wg::encode_matrix(&wm, w, cout, wg::packed_k(cin, groups, kh, kw), bn);
    if (err != cudaSuccess) return (int)err;
  }
  wg::Args a;
  a.epi = epi;
  a.m = (int)m;
  a.ho = ho;
  a.wo = wo;
  a.stride = stride;
  a.pad = pad;
  a.kw = kw;
  a.spans = groups > 1;
  a.cblocks = a.spans ? 1 : cin / wg::kBK;
  a.kt = kh * kw * a.cblocks;
  a.n_tiles = (cout + bn - 1) / bn;
  const long long tiles = (m + wg::kBM - 1) / wg::kBM * a.n_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.im2col = !(kh == 1 && kw == 1 && stride == 1 && pad == 0);
  wg::MapKey key;
  memset(&key, 0, sizeof(key));   // the padding too: keys compare as bytes
  key.x = x;
  key.batch = batch;
  key.h = h;
  key.w = w_in;
  key.cin = cin;
  key.kh = kh;
  key.kw = kw;
  key.stride = stride;
  key.pad = pad;
  key.im2col = a.im2col;
  const cudaError_t err = wg::input_map(&xmap, key, m);
  if (err != cudaSuccess) return (int)err;
  switch (res_kind + 3 * (bn == 128)) {
    case 0: return (int)wg::launch<64, 0>(xmap, wm, a, s);
    case 1: return (int)wg::launch<64, 1>(xmap, wm, a, s);
    case 2: return (int)wg::launch<64, 2>(xmap, wm, a, s);
    case 3: return (int)wg::launch<128, 0>(xmap, wm, a, s);
    case 4: return (int)wg::launch<128, 1>(xmap, wm, a, s);
    default: return (int)wg::launch<128, 2>(xmap, wm, a, s);
  }
}

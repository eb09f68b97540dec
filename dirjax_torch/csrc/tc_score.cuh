// The tensor-core scoring routine of the top-k kernels, shared by topk.cu
// (K2, K3, K4: dense rows) and binary.cu (K5 and its rescore: packed sign
// codes): a persistent CTA walks work units of 128-row tiles against up to
// 256 queries, feeding wgmma from a cp.async ring of shared-memory stages.
// topk.cu's header describes the design; the bits modes are described at
// Mode below.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kRowsPerBlock = 8;                         // fine block (_RPB)

// Operand modes (database row x query). topk.cu's entry points take 0-3;
// binary.cu's K5 takes 4 and 5, whose rows are packed sign codes (LSB first:
// bit b of byte B is dimension 8B + b) that each warp unpacks in registers
// into the A fragments of its 16 rows, 128 d (16 bytes of a row) at a time:
//   4 (asymmetric): +-1 as bf16 against bf16 queries, the bf16 wgmma with A
//     from registers and fp32 accumulation; every product is exact.
//   5 (symmetric): +-1 as int8 against int8 +-1 queries (the wrapper
//     unpacks them), the s8 wgmma with A from registers and exact int32
//     sums: the score n_bits - 2 * hamming.
enum Mode { kF32 = 0, kBF16 = 1, kI8BF16 = 2, kI8I8 = 3, kBitsBF16 = 4, kBitsI8 = 5 };

template <int M>
constexpr bool kBits = M == kBitsBF16 || M == kBitsI8;

// --------------------------------------------------------------------------
// Tensor cores, fed by a cp.async ring
// --------------------------------------------------------------------------

constexpr int kTcThreads = 256;    // 8 warps
constexpr int kTcRows = 128;       // M: database rows per tile
constexpr int kSliceBytes = 128;   // bytes of one row per stage
constexpr int kMaxStages = 4;
constexpr int kMaxRingBytes = 192 * 1024;
constexpr int kMaxSmemBytes = 232448;   // a block's dynamic shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a slice of 128-byte rows: the
// 128-byte swizzle that wgmma reads.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kSliceBytes + ((c ^ (r & 7)) << 4);
}

// The same for mode 0's fp32 row slices, which only the warps read (four d
// a thread, 16 bytes): odd rows swap their 64-byte halves, so the 8 lanes of
// a 16-byte load phase (rows g and g + 1, chunks t of a half) meet 8
// different bank groups.
__device__ __forceinline__ int swz_f32(int r, int c) {
  return r * kSliceBytes + ((c ^ ((r & 1) << 2)) << 4);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the 16 bytes of `row` at byte `off` into shared `dst`, zero-filling
// past `len` bytes (and all 16 for a null row). `vec` is the widest copy the
// row's alignment allows: 16, 8, 4, or 1 (plain loads). A copy of 0 bytes
// still names a valid address, `base`.
__device__ __forceinline__ void copy_chunk(char* dst, const char* row, int off,
                                           int len, int vec, const char* base) {
  int valid = row == nullptr ? 0 : len - off;
  valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
  const char* src = valid > 0 ? row + off : base;
  const uint32_t s = smem_u32(dst);
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src), "r"(valid) : "memory");
  } else if (vec == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = valid - 8 * h;
      v = v < 0 ? 0 : (v > 8 ? 8 : v);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   ::"r"(s + 8 * h), "l"(v > 0 ? src + 8 * h : src), "r"(v) : "memory");
    }
  } else if (vec == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      int v = valid - 4 * h;
      v = v < 0 ? 0 : (v > 4 ? 4 : v);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   ::"r"(s + 4 * h), "l"(v > 0 ? src + 4 * h : src), "r"(v) : "memory");
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < valid; ++i)
      w[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Orders this thread's generic-proxy shared-memory writes (cp.async
// landings, plain stores) before the async proxy's wgmma reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups run.
template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler off accumulator registers while a wgmma owns them.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(int& x) { asm volatile("" : "+r"(x)::"memory"); }

// Descriptor of a K-major wgmma operand in the 128-byte swizzle: 8-row atoms
// of 1024 bytes (the stride byte offset; the leading one is unused). `addr`
// is an atom-aligned tile start plus the k step's byte offset (32 a step).
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// Two int8 (bytes 0 and 1 of w) -> one bf16 pair, exactly, on the
// full-rate ALUs (an int -> float convert runs at a fraction of their rate):
// byte b ^ 0x80 = b + 128 goes into the mantissa of 2^23, and subtracting
// 2^23 + 128 leaves b as an exact fp32. An integer |b| <= 128 is exact in
// bf16, whose bits are the fp32's top 16.
__device__ __forceinline__ uint32_t widen(uint32_t w) {
  const uint32_t biased = w ^ 0x8080u;   // bytes [b0 + 128, b1 + 128, 0, 0]
  const float f0 = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7541)) - 8388736.0f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// Two fp32 -> their bf16 pairs hi = bf16(x) and lo = bf16(x - hi), both
// rounded to nearest even (x - hi is exact in fp32); x in the low half, as a
// wgmma A fragment holds its lower k.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - back.x, y - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Bits 0 and 1 of x -> a bf16 pair of +-1 (+1 where the bit is set), bit 0
// in the low half: the multiply moves bit 0 to bit 15 and bit 1 to bit 31
// (the other products, at bits 16 and 30, are masked off), which flip the
// sign of -1 = 0xBF80.
__device__ __forceinline__ uint32_t pm1_bf16x2(uint32_t x) {
  return 0xBF80BF80u ^ (((x & 3u) * 0x40008000u) & 0x80008000u);
}

// Bits 0-3 of x -> four int8 +-1, bit k in byte k: the multiply puts bit k
// at bit 8k (no two of its products meet), and 0xFF ^ 0xFE = 0x01.
__device__ __forceinline__ uint32_t pm1_i8x4(uint32_t x) {
  return 0xFFFFFFFFu ^ ((((x & 15u) * 0x00204081u) & 0x01010101u) * 0xFEu);
}

__device__ __forceinline__ float score_of(float acc) { return acc; }
__device__ __forceinline__ float score_of(int acc) { return __int2float_rn(acc); }

// Tile shape of a mode and a query width BN (N of the wgmma), beside
// RESERVED bytes of shared memory the kernel keeps for itself. Each of the
// two warpgroups owns 64 of the 128 rows; warp w holds rows 16w..16w+15 of
// the tile as NT = BN/8 fragments of 8 queries (wgmma.cuh). A stage holds
// AMUL 128-byte slices of each row (A) and QMUL consecutive ones of each
// query (B): modes 1 and 3 one of each (64 and 128 d), mode 2 one of rows
// and two of queries (128 d). Mode 0 holds 32 d a slice pair
// (an fp32 row slice; a query slice of 32 hi and then 32 lo bf16), two
// pairs a stage where three such stages fit beside RESERVED, else one.
// The bits modes hold 128 d a slice of 16 bytes of each row (A_ROW,
// unswizzled: only the warps read them), with two bf16 query slices (mode 4)
// or one int8 one (mode 5) of the same d, and BITS_R such slices a stage:
// four (512 d) at N <= 16, where the per-stage work (a barrier, a wait for
// the wgmmas) weighs most and a quarter as much of it ran faster on the
// card in both modes; one at larger N, where two or four were no faster at
// some N and slower at others.
template <int M, int BN_, int RESERVED = 0>
struct Tc {
  static constexpr int MODE = M;
  static constexpr int BN = BN_;
  static constexpr int NT = BN / 8;
  static constexpr int A_ROW = kBits<M> ? 16 : kSliceBytes;   // bytes of a row a slice holds
  static constexpr int A_SLICE = kTcRows * A_ROW;
  static constexpr int ROOM = kMaxSmemBytes - RESERVED < kMaxRingBytes
                                  ? kMaxSmemBytes - RESERVED : kMaxRingBytes;
  static constexpr int F32_PAIRS = ROOM / (2 * (A_SLICE + BN * kSliceBytes)) >= 3 ? 2 : 1;
  static constexpr int BITS_R = BN <= 16 ? 4 : 1;   // bits modes: 128-d slices a stage
  static constexpr int AMUL = M == kF32 ? F32_PAIRS : kBits<M> ? BITS_R : 1;
  static constexpr int QMUL = M == kF32                      ? F32_PAIRS
                              : M == kI8BF16                 ? 2
                              : M == kBitsBF16               ? 2 * BITS_R
                              : M == kBitsI8                 ? BITS_R
                                                             : 1;
  static constexpr int KE = M == kF32 ? 32 * F32_PAIRS
                            : M == kBF16 ? 64
                            : kBits<M> ? 128 * BITS_R
                                       : 128;   // d a stage
  static constexpr int A_BYTES = A_SLICE * AMUL;
  static constexpr int B_BYTES = BN * kSliceBytes * QMUL;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = ROOM / STAGE_BYTES;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  using Acc = typename std::conditional<M == kI8I8 || M == kBitsI8, int, float>::type;
  static_assert(STAGES >= 2 && STAGE_BYTES % 1024 == 0, "tile shape");
};

// What every tensor-core kernel gives the ring: the operands' bytes and the
// widest copy their alignment allows.
struct Operands {
  const char* db;
  const char* q;
  long long n, nq;
  int d, row_bytes, q_bytes, row_vec, q_vec;
};

// The rows and queries whose chunks this thread copies for one tile: chunk
// e = threadIdx.x + i * 256 of a slice is 16-byte chunk e % A_CPR of row
// e / A_CPR (of a query: chunk e % 8 of query e / 8), in every slice of the
// stage. Work::row and Work::query name a row or query by its position in
// the tile, or return null for a zero operand; they run once a tile, not
// once a stage.
template <class C>
struct TileSrc {
  static constexpr int A_CPR = C::A_ROW / 16;                          // chunks of a row
  static constexpr int A_CHUNKS = kTcRows * A_CPR, B_CHUNKS = C::BN * 8;   // a slice
  static constexpr int A_IT = (A_CHUNKS + kTcThreads - 1) / kTcThreads;
  static constexpr int B_IT = (B_CHUNKS + kTcThreads - 1) / kTcThreads;
  const char* a[A_IT];
  const char* b[B_IT];

  template <class Work>
  __device__ __forceinline__ void set(const Work& w, long long unit, int tile) {
#pragma unroll
    for (int i = 0; i < A_IT; ++i)
      a[i] = w.row(unit, tile, ((threadIdx.x + i * kTcThreads) / A_CPR) % kTcRows);
#pragma unroll
    for (int i = 0; i < B_IT; ++i)
      b[i] = w.query(unit, ((threadIdx.x + i * kTcThreads) >> 3) % C::BN);
  }
};

// Stage `kb` (d values [kb*KE, kb*KE + KE)) of the tile `src` names into
// `stage`.
template <class C>
__device__ __forceinline__ void load_stage(char* stage, const TileSrc<C>& src,
                                           const Operands& o, int kb) {
  using S = TileSrc<C>;
#pragma unroll
  for (int s = 0; s < C::AMUL; ++s)
#pragma unroll
    for (int i = 0; i < S::A_IT; ++i) {
      const int e = threadIdx.x + i * kTcThreads;
      if (S::A_CHUNKS % kTcThreads != 0 && e >= S::A_CHUNKS) break;
      const int r = e / S::A_CPR, c = e % S::A_CPR;
      const int at = C::MODE == kF32 ? swz_f32(r, c) : kBits<C::MODE> ? r * C::A_ROW : swz(r, c);
      copy_chunk(stage + s * C::A_SLICE + at, src.a[i],
                 (kb * C::AMUL + s) * C::A_ROW + c * 16, o.row_bytes, o.row_vec, o.db);
    }
#pragma unroll
  for (int h = 0; h < C::QMUL; ++h)
#pragma unroll
    for (int i = 0; i < S::B_IT; ++i) {
      const int e = threadIdx.x + i * kTcThreads;
      if (S::B_CHUNKS % kTcThreads != 0 && e >= S::B_CHUNKS) break;
      const int r = e >> 3, c = e & 7;
      copy_chunk(stage + C::A_BYTES + h * C::BN * kSliceBytes + swz(r, c), src.b[i],
                 (kb * C::QMUL + h) * kSliceBytes + c * 16, o.q_bytes, o.q_vec, o.q);
    }
}

// The one scoring routine of K2-K5 and the rescores: starts adding one landed
// stage's products into the warpgroup's accumulators, d increasing; mma_wait
// ends it. Modes 1 and 3 issue one wgmma per 32 bytes of each row. In mode 2
// each warp widens its 16 int8 rows of the stage into the bf16 A fragments
// in registers, and the wgmma is the bf16 one with A from registers. In
// mode 0 each warp splits its 16 fp32 rows into hi and lo A fragments, and
// each k16 step issues hi.hi, hi.lo, lo.hi, lo.lo (query part second). In
// modes 4 and 5 each warp unpacks its 16 rows' bits into +-1 A fragments
// (bf16 pairs, or int8 quads) in registers.
template <int M, class C>
__device__ __forceinline__ void mma_issue(const char* stage,
                                          typename C::Acc (&acc)[C::NT * 4]) {
  using dirjax_wgmma::Wgmma;
  const uint32_t b = smem_u32(stage + C::A_BYTES);
  if constexpr (M == kF32) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);   // rows r, r + 8
    constexpr int kSteps = C::KE / 16;
    // k16 step j (d 16j..16j+15) splits into register set j % 2 while the
    // wgmmas of step j - 1 run; step j - 2, the set's last reader, is done
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      uint32_t(&h)[4] = hi[j & 1];
      uint32_t(&l)[4] = lo[j & 1];
      if (j >= 2) wgmma_wait_group<1>();
      // Thread t takes d 16j + 4t .. 4t + 3 of its rows (chunk c of fp32
      // slice j / 2) as the fragment's k 2t, 2t + 1, 2t + 8, 2t + 9; the
      // wrapper orders each query's 16 d alike (topk.py _split).
      const char* slice = stage + (j >> 1) * C::A_SLICE;
      const int c = 4 * (j & 1) + t;
      // the query slice of the same 32 d: 32 hi, then 32 lo
      const uint32_t qs = b + (j >> 1) * C::BN * kSliceBytes + 32 * (j & 1);
      const float4 top = *reinterpret_cast<const float4*>(slice + swz_f32(r, c));
      const float4 bot = *reinterpret_cast<const float4*>(slice + swz_f32(r + 8, c));
      split(top.x, top.y, h[0], l[0]);
      split(bot.x, bot.y, h[1], l[1]);
      split(top.z, top.w, h[2], l[2]);
      split(bot.z, bot.w, h[3], l[3]);
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < C::NT * 4; ++i) pin(acc[i]);
      }
      wgmma_fence();
      const uint64_t qhi = sw128(qs), qlo = sw128(qs + 64);
      Wgmma<C::BN>::run(acc, h, qhi);
      Wgmma<C::BN>::run(acc, h, qlo);
      Wgmma<C::BN>::run(acc, l, qhi);
      Wgmma<C::BN>::run(acc, l, qlo);
      if (j + 1 < kSteps) wgmma_commit();
    }
  } else if constexpr (M == kI8BF16) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);   // rows r, r + 8
    uint32_t a[kSliceBytes / 16][4];   // k16 step j: d 16j..16j+15, chunk j
#pragma unroll
    for (int j = 0; j < kSliceBytes / 16; ++j) {
      const char* top = stage + swz(r, j) + 2 * t;
      const char* bot = stage + swz(r + 8, j) + 2 * t;
      a[j][0] = widen(*reinterpret_cast<const uint16_t*>(top));       // d 2t, 2t+1
      a[j][1] = widen(*reinterpret_cast<const uint16_t*>(bot));
      a[j][2] = widen(*reinterpret_cast<const uint16_t*>(top + 8));   // d 2t+8, 2t+9
      a[j][3] = widen(*reinterpret_cast<const uint16_t*>(bot + 8));
    }
#pragma unroll
    for (int i = 0; i < C::NT * 4; ++i) pin(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSliceBytes / 16; ++j)   // queries: bf16 halves of 64 d
      Wgmma<C::BN>::run(acc, a[j], sw128(b + (j >> 2) * C::BN * kSliceBytes + 32 * (j & 3)));
  } else if constexpr (kBits<M>) {
    // slice s of the stage (d 128s .. 128s + 127 of it), rows r and r + 8:
    // 128 d as four 32-bit words, d 32w + i at bit i of word w; one 16-byte
    // load each (the 8 rows of a load phase are 128 contiguous bytes). A
    // slice unpacks into register set s % 2 while the wgmmas of the slice
    // before run; slice s - 2, the set's last reader, is done.
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
    constexpr int kSets = C::AMUL > 1 ? 2 : 1;
    constexpr int kK = M == kBitsBF16 ? 8 : 4;   // k steps of 128 d
    uint32_t a[kSets][kK][4];
#pragma unroll
    for (int s = 0; s < C::AMUL; ++s) {
      uint32_t(&f)[kK][4] = a[s % kSets];
      if (s >= 2) wgmma_wait_group<1>();
      const char* slice = stage + s * C::A_SLICE;
      const uint4 top4 = *reinterpret_cast<const uint4*>(slice + r * C::A_ROW);
      const uint4 bot4 = *reinterpret_cast<const uint4*>(slice + (r + 8) * C::A_ROW);
      const uint32_t top[4] = {top4.x, top4.y, top4.z, top4.w};
      const uint32_t bot[4] = {bot4.x, bot4.y, bot4.z, bot4.w};
      if constexpr (M == kBitsBF16) {
        // k16 step j: d 16j..16j+15, bits 16 (j % 2) .. of word j / 2; thread
        // t takes d 2t, 2t + 1 and 2t + 8, 2t + 9
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const int sh = 16 * (j & 1) + 2 * t;
          const uint32_t x = top[j >> 1] >> sh, y = bot[j >> 1] >> sh;
          f[j][0] = pm1_bf16x2(x);
          f[j][1] = pm1_bf16x2(y);
          f[j][2] = pm1_bf16x2(x >> 8);
          f[j][3] = pm1_bf16x2(y >> 8);
        }
      } else {
        // k32 step j: d 32j..32j+31, word j; thread t takes d 4t..4t+3 and
        // 4t + 16..4t + 19
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const uint32_t x = top[j] >> (4 * t), y = bot[j] >> (4 * t);
          f[j][0] = pm1_i8x4(x);
          f[j][1] = pm1_i8x4(y);
          f[j][2] = pm1_i8x4(x >> 16);
          f[j][3] = pm1_i8x4(y >> 16);
        }
      }
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < C::NT * 4; ++i) pin(acc[i]);
      }
      wgmma_fence();
      // the slice's queries: two bf16 query slices of 64 d (mode 4), one
      // int8 one of 128 d (mode 5)
#pragma unroll
      for (int j = 0; j < kK; ++j)
        Wgmma<C::BN>::run(acc, f[j], M == kBitsBF16
            ? sw128(b + (2 * s + (j >> 2)) * C::BN * kSliceBytes + 32 * (j & 3))
            : sw128(b + s * C::BN * kSliceBytes + 32 * j));
      if (s + 1 < C::AMUL) wgmma_commit();
    }
  } else {
    const uint32_t a = smem_u32(stage) + (threadIdx.x >> 7) * 64 * kSliceBytes;
#pragma unroll
    for (int i = 0; i < C::NT * 4; ++i) pin(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSliceBytes / 32; ++s)
      Wgmma<C::BN>::run(acc, sw128(a + 32 * s), sw128(b + 32 * s));
  }
  wgmma_commit();
}

template <class T, int K>
__device__ __forceinline__ void mma_wait(T (&acc)[K]) {
  wgmma_wait_group<0>();
#pragma unroll
  for (int i = 0; i < K; ++i) pin(acc[i]);
}

// A position in a CTA's walk: work unit, row tile of the unit, stage.
template <int kTiles>
struct Cursor {
  long long unit;
  int tile, kb;
  __device__ __forceinline__ void next(int nkb) {
    if (++kb == nkb) {
      kb = 0;
      if (++tile == kTiles) { tile = 0; unit += gridDim.x; }
    }
  }
};

// Runs the ring over this CTA's work units (unit = blockIdx.x + i*gridDim.x
// < w.units, each of Work::kTiles row tiles) and calls w.epilogue(unit, tile,
// acc, warp, lane) once a tile has seen every d. The ring does not drain
// between tiles or units. Every thread takes the same path, so epilogues
// may synchronise.
template <int M, class C, class Work>
__device__ __forceinline__ void score_tiles(char* ring, Work& w) {
  const int nkb = (w.ops.d + C::KE - 1) / C::KE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Cursor<Work::kTiles> ld{blockIdx.x, 0, 0}, cp{blockIdx.x, 0, 0};
  TileSrc<C> src;
  long long loaded = 0;
#pragma unroll 1
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (ld.unit < w.units) {
      if (ld.kb == 0) src.set(w, ld.unit, ld.tile);
      load_stage<C>(ring + s * C::STAGE_BYTES, src, w.ops, ld.kb);
      ld.next(nkb);
      ++loaded;
    }
    cp_async_commit();
  }
  // Mode 0 adds the products of each 64 d, and mode 4 those of each stage
  // (128 to 512 d), which start from 0 in `acc`, into `sum` with one fp32 add
  // rounded to nearest: the tensor cores' own accumulation loses more the
  // larger the sum it adds onto, and one accumulator over all 512 wgmmas of
  // a unit self-match at D = 2048 did not stay within 1e-5 (chip_smoke.py's
  // self-match cases). Mode 4's scores reach |q|_1 (tens for a projected
  // unit query), so its wgmmas over 2048 bits are summed alike.
  constexpr bool kStageSums = C::MODE == kF32 || C::MODE == kBitsBF16;
  typename C::Acc acc[C::NT * 4], sum[kStageSums ? C::NT * 4 : 1];
#pragma unroll
  for (int i = 0; i < C::NT * 4; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (kStageSums ? C::NT * 4 : 1); ++i) sum[i] = 0;
#pragma unroll 1
  for (long long it = 0; cp.unit < w.units; ++it) {
    cp_async_wait<C::STAGES - 2>();
    fence_async_smem();
    __syncthreads();   // stage `it` has landed; stage `it - 1` is free
    mma_issue<M, C>(ring + (it % C::STAGES) * C::STAGE_BYTES, acc);
    if (ld.unit < w.units) {   // copies into stage `it - 1` while the wgmmas run
      if (ld.kb == 0) src.set(w, ld.unit, ld.tile);
      load_stage<C>(ring + (loaded % C::STAGES) * C::STAGE_BYTES, src, w.ops, ld.kb);
      ld.next(nkb);
      ++loaded;
    }
    cp_async_commit();
    mma_wait(acc);
    // every stage in mode 4; in mode 0 every 64 d: one stage, or two of one
    // slice pair
    if constexpr (kStageSums) {
      if (C::MODE == kBitsBF16 || C::AMUL == 2 || (cp.kb & 1) || cp.kb == nkb - 1) {
#pragma unroll
        for (int i = 0; i < C::NT * 4; ++i) {
          sum[i] += acc[i];
          acc[i] = 0;
        }
      }
    }
    if (cp.kb == nkb - 1) {
      if constexpr (kStageSums) {
        w.template epilogue<C>(cp.unit, cp.tile, sum, warp, lane);
#pragma unroll
        for (int i = 0; i < C::NT * 4; ++i) sum[i] = 0;
      } else {
        w.template epilogue<C>(cp.unit, cp.tile, acc, warp, lane);
#pragma unroll
        for (int i = 0; i < C::NT * 4; ++i) acc[i] = 0;
      }
    }
    cp.next(nkb);
  }
  cp_async_wait<0>();
}

// K3 (and K5): a unit is (row tile, query group), the group fastest.
template <int BN>
struct FinemaxWork {
  static constexpr int kTiles = 1;
  static constexpr int kSharedBytes = 0;   // beside the ring
  Operands ops;
  const float* scales;
  long long blocks, qgroups, units;
  float* out;

  __device__ __forceinline__ const char* row(long long unit, int, int r) const {
    const long long i = unit / qgroups * kTcRows + r;
    return i < ops.n ? ops.db + i * ops.row_bytes : nullptr;
  }
  __device__ __forceinline__ const char* query(long long unit, int c) const {
    const long long i = unit % qgroups * BN + c;
    return i < ops.nq ? ops.q + i * ops.q_bytes : nullptr;
  }
  __device__ __forceinline__ float scaled(float s, long long r) const {
    if (r >= ops.n) return -INFINITY;
    return scales != nullptr ? __fmul_rn(s, scales[r]) : s;
  }
  // A fine block is 8 rows of one fragment: its maximum takes 3 shuffles.
  template <class C>
  __device__ __forceinline__ void epilogue(long long unit, int,
                                           typename C::Acc (&acc)[C::NT * 4], int warp,
                                           int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const long long q0 = unit % qgroups * BN + 2 * t;
    const long long r0 = unit / qgroups * kTcRows + warp * 16;
    const long long blk = r0 / kRowsPerBlock;   // rows r0..r0+7; blk + 1: r0+8..
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float top = scaled(score_of(acc[nt * 4 + e]), r0 + g);
        float bot = scaled(score_of(acc[nt * 4 + 2 + e]), r0 + 8 + g);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
          bot = fmaxf(bot, __shfl_xor_sync(0xffffffffu, bot, off));
        }
        const long long qi = q0 + nt * 8 + e;
        if (g == 0 && qi < ops.nq) {
          if (blk < blocks) out[qi * blocks + blk] = top;
          if (blk + 1 < blocks) out[qi * blocks + blk + 1] = bot;
        }
      }
  }
};

// K4 (and K5's rescore): a unit is one query's 16 candidate blocks; its
// queries are that one query, at its column q % BN of K3's (K5's) tile, and
// zeros. BN is the one K3 takes at this nq (by_query_width), so both issue
// the same wgmma shape.
template <int BN>
struct GatherWork {
  static constexpr int kTiles = 1;
  static constexpr int kSharedBytes = 0;
  Operands ops;
  const long long* bids;
  long long kf, cgroups, units;
  float* out;

  // first row of candidate c of query qi, or -1 outside the database
  __device__ __forceinline__ long long first_row(long long qi, long long c) const {
    if (c >= kf) return -1;
    const long long b = bids[qi * kf + c];
    return b >= 0 && b * kRowsPerBlock + kRowsPerBlock <= ops.n ? b * kRowsPerBlock : -1;
  }
  __device__ __forceinline__ const char* row(long long unit, int, int r) const {
    const long long r0 = first_row(unit / cgroups, unit % cgroups * 16 + r / kRowsPerBlock);
    return r0 < 0 ? nullptr : ops.db + (r0 + r % kRowsPerBlock) * ops.row_bytes;
  }
  __device__ __forceinline__ const char* query(long long unit, int c) const {
    const long long qi = unit / cgroups;
    return c == (int)(qi % BN) ? ops.q + qi * ops.q_bytes : nullptr;
  }
  template <class C>
  __device__ __forceinline__ void epilogue(long long unit, int,
                                           typename C::Acc (&acc)[C::NT * 4], int warp,
                                           int lane) const {
    const long long qi = unit / cgroups;
    const int col = (int)(qi % BN), g = lane >> 2, t = lane & 3;
    // rows g and g + 8 at column col, held by the lanes with 2t = col % 8
    // rounded down; picked with static indices, so acc stays in registers
    typename C::Acc top = 0, bot = 0;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (nt * 8 + 2 * t + e == col) {
          top = acc[nt * 4 + e];
          bot = acc[nt * 4 + 2 + e];
        }
    if (2 * t != (col & 6)) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + half * 8 + g;            // row of the 128
      const long long c = unit % cgroups * 16 + r / kRowsPerBlock;
      if (c < kf)
        out[(qi * kf + c) * kRowsPerBlock + r % kRowsPerBlock] =
            first_row(qi, c) >= 0 ? score_of(half ? bot : top) : NAN;
    }
  }
};

// The tile shape of a kernel: the ring takes what shared memory the Work's
// own bytes leave.
template <int M, int BN, class Work>
using TcOf = Tc<M, BN, Work::kSharedBytes>;

template <int M, int BN, class Work>
__global__ void __launch_bounds__(kTcThreads)
tc_kernel(Work w) {
  extern __shared__ __align__(1024) char smem[];
  using C = TcOf<M, BN, Work>;
  if constexpr (Work::kSharedBytes > 0) w.bind_shared(smem + C::RING_BYTES);
  score_tiles<M, C>(smem, w);
}

constexpr int kMaxDevices = 64;

// Launches tc_kernel<M, BN> with one CTA per free slot of every SM (as many
// as the occupancy calculator allows at its shared memory), at most one per
// unit. The opt-in to that shared memory and the slot count depend only on
// the instantiation and the device, so the first launch on a device works
// them out and later launches reuse them: a search pays one cudaGetDevice.
template <int M, int BN, class Work>
int launch_tc(Work w, cudaStream_t s) {
  auto* kernel = tc_kernel<M, BN, Work>;
  constexpr int smem = TcOf<M, BN, Work>::RING_BYTES + Work::kSharedBytes;
  static std::atomic<long long> slots_on[kMaxDevices];   // 0: not yet known
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  long long slots = slots_on[dev].load(std::memory_order_acquire);
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = (long long)sms * per_sm;
    slots_on[dev].store(slots, std::memory_order_release);
  }
  kernel<<<(unsigned)(w.units < slots ? w.units : slots), kTcThreads, smem, s>>>(w);
  return (int)cudaGetLastError();
}

// The widest cp.async (16, 8 or 4 bytes; else 1: plain loads) that every row
// starting at `base`, `row_bytes` apart, allows.
int vec_of(const void* base, long long row_bytes) {
  const unsigned long long a = (unsigned long long)(uintptr_t)base | (unsigned long long)row_bytes;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
}

template <int M>
Operands operands(const void* q, const void* db, long long nq, long long n, int d) {
  Operands o;
  o.db = static_cast<const char*>(db);
  o.q = static_cast<const char*>(q);
  o.n = n;
  o.nq = nq;
  o.d = d;
  // fp32, bf16 or int8 rows, or d bits
  o.row_bytes = kBits<M> ? d / 8 : d * (M == kF32 ? 4 : M == kBF16 ? 2 : 1);
  // int8 or bf16 queries; in mode 0 a hi and a lo bf16 for each of d
  // rounded up to 32
  o.q_bytes = M == kF32 ? (d + 31) / 32 * 128 : d * (M == kI8I8 || M == kBitsI8 ? 1 : 2);
  o.row_vec = vec_of(db, o.row_bytes);
  o.q_vec = vec_of(q, o.q_bytes);
  return o;
}

// A unit's query width at nq: the smallest wgmma N (8, 16, ..., MaxBN) that
// holds nq. K3, K4, K5 and its rescore go up to 256 (128 for int8 x bf16
// and fp32, whose 256-query stages would fit only two at a time in the ring,
// and for fp32 and asymmetric bits, which also hold a second set of N/2
// sums a thread); K2 up to 64, since a slab's scores for its queries live in
// shared memory.
template <int M>
constexpr int kMaxQueryWidth = M == kI8BF16 || M == kF32 || M == kBitsBF16 ? 128 : 256;

template <int MaxBN, int BN = 8, class F>
int by_query_width(long long nq, F launch) {
  if constexpr (BN < MaxBN) {
    if (nq > BN) return by_query_width<MaxBN, 2 * BN>(nq, launch);
  }
  return launch(std::integral_constant<int, BN>());
}

template <int M, int BN>
int launch_finemax_tc(const Operands& o, const float* scales, long long blocks,
                      float* out, cudaStream_t s) {
  FinemaxWork<BN> w;
  w.ops = o;
  w.scales = scales;
  w.blocks = blocks;
  w.qgroups = (o.nq + BN - 1) / BN;
  w.units = (blocks * kRowsPerBlock + kTcRows - 1) / kTcRows * w.qgroups;
  w.out = out;
  return launch_tc<M, BN>(w, s);
}

template <int M>
int launch_finemax(const void* q, const void* db, const float* scales,
                   long long nq, long long n, int d, long long blocks,
                   float* out, cudaStream_t s) {
  const Operands o = operands<M>(q, db, nq, n, d);
  return by_query_width<kMaxQueryWidth<M>>(nq, [&](auto bn) {
    return launch_finemax_tc<M, decltype(bn)::value>(o, scales, blocks, out, s);
  });
}

template <int M>
int launch_gather_scores(const void* q, const void* db, const long long* bids,
                         long long nq, long long n, int d, long long kf,
                         float* out, cudaStream_t s) {
  constexpr int kBlocks = kTcRows / kRowsPerBlock;   // 16 candidates a unit
  return by_query_width<kMaxQueryWidth<M>>(nq, [&](auto bn) {
    GatherWork<decltype(bn)::value> w;
    w.ops = operands<M>(q, db, nq, n, d);
    w.bids = bids;
    w.kf = kf;
    w.cgroups = (kf + kBlocks - 1) / kBlocks;
    w.units = nq * w.cgroups;
    w.out = out;
    return launch_tc<M, decltype(bn)::value>(w, s);
  });
}

}  // namespace

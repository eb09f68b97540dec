// ADC (asymmetric distance computation) kernels for Hopper (sm_90a): K6 of
// the PQ and IVF serving paths and its rescore.
//
// Replaces the TPU kernel of dirjax/ops/pq.py:
//   K6 dirjax_adc_finemax <- _adc_finemax_kernel (pq.py:441, launched by
//      _adc_finemax_pallas, pq.py:489): for each query and each `block`
//      consecutive rows of the uint8 codes (n rows x m subspaces), the
//      maximum of the ADC score sum_j LUT[q, j, code[r, j]]; rows >= n score
//      -inf. Written query-major (nq, blocks), as K3 and K5 write theirs.
//      `block` is 64 or 8 for PQ (pq.py:552-560), the slab for IVF, and 1 for
//      the dense small-corpus path (the maxima are then the scores).
//   dirjax_adc_gather_scores, the rescore: the counterpart of dirjax's XLA
//      phase C (pq.py:393-421, ivf.py:289-326), not of a TPU kernel. Per
//      query, it scores the `block` rows of each of kf candidate blocks ->
//      (nq, kf * block) raw scores; a block id outside [0, ceil(n / block))
//      yields NaN, a row >= n inside a valid block -inf (as in K6). PQ runs
//      it as phase C; IVF as its slab scorer (phase A: 128 slabs of 64 rows
//      a launch, whose maxima the wrapper takes) and as phase C.
//
// Containment (topk_pallas.py:24-29) needs the rescore to reproduce K6's
// maxima bit for bit. Both score a (row, query) pair as one fp32 accumulator
// that starts at 0 and takes adc_mac, __fadd_rn(acc, LUT value), for j = 0,
// 1, ... in increasing order; bf16 tables are widened to fp32 (exact) when
// they are staged. So both add the same fp32 values in the same order, and
// the plain versions in dirjax_torch/ops/pq.py do too: all three agree bit
// for bit, whatever their layouts.
//
// What bounds K6: at the serving shape (1,048,576 rows, m = 32, nq = 256)
// it reads 33.5 MB of codes and 0.5 MB (ksub 16) or 8.4 MB (ksub 256) of
// tables and does 8.6e9 table lookups and adds: 0.13 ms of fp32 adds, but a
// design that makes one shared-memory load per lookup has a floor of
// 8.6e9 / (132 SMs x 32 lanes a clock), about 1.0 ms at the card's maximum
// clock. (The TPU kernel turned the lookups into a one-hot x LUT
// contraction, 0.28 ms of bf16 tensor work at ksub 16; it would change the
// sums, so the rescore would have to share its matrix routine.) The design:
//   - Queries on the lanes: a CTA of 16 warps takes 32 queries, one a lane,
//     against 1024 rows a pass, 64 rows a warp, each lane holding its
//     query's 64 accumulators in registers. A row's code byte is the same
//     for every lane (one broadcast load gives four subspaces of a row), and
//     each lane reads its own query's table entry.
//   - Each lane's staged tables start `stride` words after the previous
//     lane's, with stride = 1 (mod 32): the 32 lookups of a warp, one table
//     entry of each query at the same code, fall in 32 different banks at
//     any ksub.
//   - Where the tables of all m subspaces fit the block's shared memory
//     (227 KB) as fp32 (m = 32 at ksub 16), they are staged once per query
//     group, bf16 ones widened, and the CTA walks every row range of the
//     group. Else (ksub 256) two buffers each hold `step` subspaces (as
//     many as fit, a power of two up to 16: 2 fp32 or 4 bf16 at ksub 256)
//     as they are stored, bf16 widened at the lookup, and the next step's
//     tables copy in with cp.async while this step adds; the accumulators
//     stay in registers across the steps of a pass, which keeps the order
//     of the adds.
//   - A pass takes its codes in chunks of 16 subspaces (16 bytes of each of
//     its 1024 rows), each copied in with cp.async into one of two buffers
//     while the chunk before adds.
//   - The maxima fold stays in the CTA: for the blocks the wrappers pass (1,
//     8, 64, and the default IVF slab of 64) a lane folds its own 64
//     accumulators in place and stores its 64 / block maxima; any other
//     block folds each row into its range's maxima with a shared-memory
//     atomic on an order-preserving integer key. A fold of every power of
//     two up to 64 in the lane, one inlined copy each, made ptxas spill
//     about 1 KB a thread in the hot loop.
//   - Persistent CTAs, one per SM, walk (query group, row range) units, the
//     range fastest, so a group's resident tables are staged once per CTA.
// What bounds the rescore: the candidate codes it reads, kf * block * m
// bytes a query (52 MB at nq = 256, k = 100, 64-row blocks: 0.016 ms at
// 3.35 TB/s), and at small nq the latency of those reads, since the work is
// a few MB (IVF's phase A at nq = 16: 128 slabs of 64 rows a query, 4.2 MB).
// Its lookups, one shared-memory load each, come to 52.4 M at that PQ shape
// (0.006 ms at 32 a clock on 132 SMs). The design, rows on the lanes:
//   - A CTA takes one query and upc of its candidate blocks; a query's kf
//     blocks split over as many CTAs as put about 8 on each SM (several at
//     nq = 16), but no CTA stages more table bytes than it reads codes. It
//     stages the blocks' row bases and the query's tables (widened to fp32)
//     once, behind one barrier; then there is none.
//   - Its (up to 8) warps walk the range's candidate rows, 32 a step, one a
//     lane: a warp step is half a 64-row block, or four 8-row ones. A lane
//     loads 32 code bytes of its row in 16-byte vectors (8, 4 or 1 where m
//     or the codes' alignment forbid), issued before the lookups of the
//     chunk before (the row's previous 32 subspaces, or the warp's previous
//     step), and keeps one fp32 accumulator through adc_mac, so the order of
//     the adds is K6's. Two rows a lane spilled registers and ran slower.
//   - At ksub 16 a subspace's 16 entries lie in 16 banks: a warp's lookups
//     meet no conflict. At ksub 256 two lanes whose codes agree mod 32 but
//     differ meet in one bank; the tables are not replicated.
//   - Tables larger than 96 KB (m * ksub * 4 bytes) are staged a multiple of
//     32 subspaces at a time; the partial sums wait in `out` between groups
//     (an fp32 store and load are exact), so the order holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "smem_opt_in.cuh"

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The one (row, query) step that K6 and the rescore share: add the table
// entry of this subspace's code, rounded once.
__device__ __forceinline__ void adc_mac(float& acc, const float* lut_j, int code) {
  acc = __fadd_rn(acc, lut_j[code]);
}

// --------------------------------------------------------------------------
// K6: queries on the lanes
// --------------------------------------------------------------------------

constexpr int kQ = 32;                        // queries a CTA, one a lane
constexpr int kK6Warps = 16;
constexpr int kK6Threads = 32 * kK6Warps;
constexpr int kRows = 64;                     // rows a lane scores a pass
constexpr int kPass = kK6Warps * kRows;       // rows a pass
constexpr int kChunk = 16;                    // subspaces of codes a chunk: 16 bytes a row
constexpr int kMaxBpc = 64;                   // blocks a range that folds in shared memory
constexpr int kK6Smem = 232448;               // a block's shared memory
constexpr int kCodeBytes = kPass * kChunk;    // one of two code buffers
constexpr int kFoldBytes = kMaxBpc * kQ * 4;
constexpr int kLutBytes = kK6Smem - 2 * kCodeBytes - kFoldBytes;   // the table buffers
// the key of -inf: float f orders as the int f >= 0 ? bits : bits ^ 0x7FFFFFFF
constexpr int kNegInfKey = static_cast<int>(0xFF800000u ^ 0x7FFFFFFFu);

template <typename LutT>
struct K6Args {
  const LutT* luts;        // (nq, m, ksub)
  const uint8_t* codes;    // (n, m)
  float* out;              // (nq, blocks)
  long long nq, n, block, bpc, blocks;
  int m, ksub;
  int step;     // streamed: subspaces of one table buffer, a power of two <= 16
  int stride;   // 4-byte words from one query's staged tables to the next: 1 (mod 32)
  bool async_tables;   // streamed tables copy in 4-byte words
  int code_vec;        // the widest code copy the layout allows: 16, 4, or 0 (bytes)
};

__device__ __forceinline__ int max_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// A staged table entry as fp32: fp32 as it is, bf16 widened (its bits are
// the fp32's top half).
__device__ __forceinline__ float entry(const float* t, int i) { return t[i]; }
__device__ __forceinline__ float entry(const __nv_bfloat16* t, int i) {
  return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(t)[i]) << 16);
}

// The (row, query) step of K6 on staged tables of either type: the same
// fp32 add as adc_mac.
template <typename T>
__device__ __forceinline__ void adc_add(float& acc, const T* lut_j, int code) {
  acc = __fadd_rn(acc, entry(lut_j, code));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Resident tables: all m subspaces of the CTA's 32 queries, widened to fp32,
// query q's m * ksub entries at lut_s[q * stride ...] (zeros past nq).
// Warp w copies queries w and w + 16, its lanes consecutive entries, so the
// loads coalesce and the 32 stores of a warp fall in 32 banks.
template <typename LutT>
__device__ __forceinline__ void stage_resident(float* lut_s, const K6Args<LutT>& a, long long q0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = a.m * a.ksub;
  for (int q = warp; q < kQ; q += kK6Warps) {
    const long long qi = q0 + q;
    const LutT* src = a.luts + qi * len;
    for (int e = lane; e < len; e += 32)
      lut_s[q * a.stride + e] = qi < a.nq ? widen(src[e]) : 0.0f;
  }
}

// Streamed tables: subspaces j0 .. j0+cn-1 of the CTA's 32 queries as they
// are stored (fp32 or bf16), query q's run at tab[q * stride words ...];
// asynchronously in 4-byte words (zero-filled past nq) where the runs are
// 4-byte aligned, else with plain loads. The same mapping as
// stage_resident.
template <typename LutT>
__device__ __forceinline__ void stage_streamed(LutT* tab, const K6Args<LutT>& a, long long q0,
                                               int j0, int cn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < kQ; q += kK6Warps) {
    const long long qi = q0 + q;
    const bool live = qi < a.nq;
    const LutT* src = a.luts + ((live ? qi : 0) * a.m + j0) * a.ksub;
    if (a.async_tables) {
      const uint32_t dst = smem_addr(tab) + 4u * q * a.stride;
      const int words = cn * a.ksub * (int)sizeof(LutT) / 4;
      for (int w = lane; w < words; w += 32)
        cp_async4(dst + 4u * w, reinterpret_cast<const char*>(src) + 4 * w, live);
    } else {
      LutT* dst = tab + q * a.stride * (4 / (int)sizeof(LutT));
      for (int e = lane; e < cn * a.ksub; e += 32) dst[e] = live ? src[e] : LutT(0.0f);
    }
  }
}

// Codes of the pass's rows p0 .. p0+1023, subspaces c0 .. c0+cc-1 (cc <=
// 16), to codes_s[row * 16 + t]: asynchronously where the code rows allow
// (zero-filled at rows >= live_end), else with plain byte loads.
template <typename LutT>
__device__ __forceinline__ void stage_chunk_codes(uint8_t* codes_s, const K6Args<LutT>& a,
                                            long long p0, long long live_end, int c0, int cc) {
  const uint32_t dst = smem_addr(codes_s);
  if (a.code_vec == 16) {
    for (int rl = threadIdx.x; rl < kPass; rl += kK6Threads) {
      const long long row = p0 + rl;
      const bool live = row < live_end;
      cp_async16(dst + rl * kChunk, a.codes + (live ? row : 0) * a.m + c0, live);
    }
  } else if (a.code_vec == 4) {
    const int words = (cc + 3) / 4;
    for (int e = threadIdx.x; e < kPass * words; e += kK6Threads) {
      const int rl = e / words, w = e % words;
      const long long row = p0 + rl;
      const bool live = row < live_end;
      cp_async4(dst + rl * kChunk + 4 * w, a.codes + (live ? row : 0) * a.m + c0 + 4 * w, live);
    }
  } else {
    for (int e = threadIdx.x; e < kPass * kChunk; e += kK6Threads) {
      const int t = e % kChunk;
      const long long row = p0 + e / kChunk;
      codes_s[e] = row < live_end && t < cc ? a.codes[row * a.m + c0 + t] : 0;
    }
  }
}

// Adds of subspaces off .. off+cn-1 of a code chunk, in order, to each of
// the lane's 64 rows: `lut` is the lane's table of subspace off, `codes`
// its warp's 64 rows of the chunk (16 bytes a row). One broadcast load
// gives four subspaces of a row; steps of 1 or 2 subspaces (off a
// multiple of cn) take theirs from one aligned word.
template <typename T>
__device__ __forceinline__ void add_codes(float (&acc)[kRows], const T* lut,
                                          const uint8_t* codes, int off, int cn, int ksub) {
  int t = 0;
#pragma unroll 1
  for (; t + 4 <= cn; t += 4) {
    const T* l0 = lut + t * ksub;
    const T* l1 = l0 + ksub;
    const T* l2 = l1 + ksub;
    const T* l3 = l2 + ksub;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + i * kChunk + off + t);
      adc_add(acc[i], l0, w & 0xFF);
      adc_add(acc[i], l1, (w >> 8) & 0xFF);
      adc_add(acc[i], l2, (w >> 16) & 0xFF);
      adc_add(acc[i], l3, w >> 24);
    }
  }
  if (t < cn) {   // 1-3 subspaces within one aligned word
    const int o = off + t, rem = cn - t, sh = 8 * (o & 3);
    const T* l0 = lut + t * ksub;
    const T* l1 = l0 + ksub;
    const T* l2 = l1 + ksub;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(codes + i * kChunk + (o & ~3)) >> sh;
      adc_add(acc[i], l0, w & 0xFF);
      if (rem > 1) adc_add(acc[i], l1, (w >> 8) & 0xFF);
      if (rem > 2) adc_add(acc[i], l2, (w >> 16) & 0xFF);
    }
  }
}

// Blocks whose maxima a lane folds from its own rows: those the wrappers
// pass (PQ's 64 and 8, the dense path's 1, IVF's default slab of 64). Any
// other block folds through shared memory.
__host__ __device__ constexpr bool lane_folds(long long block) {
  return block == 1 || block == 8 || block == 64;
}

// The maxima of a lane's rows r0 .. r0+63 (r0 a multiple of B, B dividing
// 64) for its query, stored to out_q (the query's row of out). They fold in
// place: acc is spent.
template <int B>
__device__ __forceinline__ void fold_store(float (&acc)[kRows], long long r0,
                                           long long live_end, long long blocks, float* out_q) {
  constexpr int kB = kRows / B;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r0 + i >= live_end) acc[i] = -INFINITY;
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int i = 1; i < B; ++i) acc[b * B] = fmaxf(acc[b * B], acc[b * B + i]);
  const long long blk0 = r0 / B;
  float* dst = out_q + blk0;
  if constexpr (kB % 4 == 0) {
    if (blk0 + kB <= blocks && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
      for (int b = 0; b < kB; b += 4)
        *reinterpret_cast<float4*>(dst + b) =
            make_float4(acc[b * B], acc[(b + 1) * B], acc[(b + 2) * B], acc[(b + 3) * B]);
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < kB; ++b)
    if (blk0 + b < blocks) dst[b] = acc[b * B];
}

// The same for any block: each of the lane's rows r0 + i < stop folds into
// the range's maxima fold_q[lb * 32], lb its block in the range from
// `base`, through one shared-memory atomic on an order-preserving key. A
// range holds fewer than 2^31 rows (the launcher checks), so 32 bits do.
__device__ __forceinline__ void fold_shared(const float (&acc)[kRows], long long r0,
                                            long long base, long long stop, long long live_end,
                                            long long block, int* fold_q) {
  const unsigned off = (unsigned)(r0 - base), blk = (unsigned)block;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r0 + i < stop)
      atomicMax(fold_q + (off + i) / blk * kQ, max_key(r0 + i < live_end ? acc[i] : -INFINITY));
}

struct K6Unit {
  long long g, b0, nb, base, end, live_end;   // rows from live_end on score -inf
};

template <typename LutT>
__device__ __forceinline__ K6Unit unit_of(const K6Args<LutT>& a, long long ranges, long long u) {
  K6Unit t;
  t.g = u / ranges;
  t.b0 = u % ranges * a.bpc;
  t.nb = min(a.bpc, a.blocks - t.b0);
  t.base = t.b0 * a.block;
  t.end = t.base + t.nb * a.block;
  t.live_end = min(t.end, a.n);
  return t;
}

// K6. Persistent CTAs walk units (query group of 32, range of bpc whole
// blocks), the range fastest; a range is one pass of 1024 rows where a lane
// folds the block, else bpc <= 64 blocks in as many passes as they take. A pass
// takes the m subspaces in chunks of 16 whose codes copy in (cp.async, two
// buffers) during the chunk before. Resident tables (kResident) are staged
// once per query group; streamed ones come `step` subspaces at a time into
// two buffers, the next step's copying in while this step adds.
template <typename LutT, bool kResident>
__global__ void __launch_bounds__(kK6Threads, 1)
adc_finemax_kernel(const K6Args<LutT> a) {
  using T = typename std::conditional<kResident, float, LutT>::type;   // staged entries
  extern __shared__ __align__(16) unsigned char smem[];
  const int tab_bytes = kQ * a.stride * 4;
  T* const tab0 = reinterpret_cast<T*>(smem);
  T* const tab1 = reinterpret_cast<T*>(smem + tab_bytes);
  uint8_t* const code0 = smem + (kResident ? 1 : 2) * tab_bytes;
  uint8_t* const code1 = code0 + kCodeBytes;
  int* const fold_s = reinterpret_cast<int*>(code1 + kCodeBytes);   // kMaxBpc x kQ
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ranges = (a.blocks + a.bpc - 1) / a.bpc;
  const long long units = (a.nq + kQ - 1) / kQ * ranges;
  const bool aligned = lane_folds(a.block);
  const int lane_entries = lane * a.stride * (4 / (int)sizeof(T));
  const int warp_codes = warp * kRows * kChunk;

  {   // the first chunk's codes and (streamed) the first step's tables
    const K6Unit un = unit_of(a, ranges, blockIdx.x);
    stage_chunk_codes(code0, a, un.base, un.live_end, 0, min(kChunk, a.m));
    if constexpr (!kResident) stage_streamed(tab0, a, un.g * kQ, 0, min(a.step, a.m));
    cp_async_commit();
    if (!aligned)
      for (int e = threadIdx.x; e < kMaxBpc * kQ; e += kK6Threads) fold_s[e] = kNegInfKey;
  }
  int cbuf = 0, tbuf = 0;
  long long staged = -1;   // resident: the query group whose tables are staged
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const K6Unit un = unit_of(a, ranges, u);
    const bool last_unit = u + gridDim.x >= units;
    for (long long p0 = un.base; p0 < un.end; p0 += kPass) {
      const bool last_pass = p0 + kPass >= un.end;
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
      for (int c0 = 0; c0 < a.m; c0 += kChunk) {
        const int cc = min(kChunk, a.m - c0);
        cp_async_wait_all();
        __syncthreads();   // this chunk's codes (and first tables) have landed; the last
                           // chunk's readers are done
        if constexpr (kResident) {
          if (staged != un.g) {
            stage_resident(reinterpret_cast<float*>(tab0), a, un.g * kQ);
            staged = un.g;
            __syncthreads();
          }
        }
        // the next chunk's codes: of this pass, the next pass, or the next unit
        const bool more = c0 + kChunk < a.m || !last_pass || !last_unit;
        if (more) {
          if (c0 + kChunk < a.m) {
            stage_chunk_codes(cbuf ? code0 : code1, a, p0, un.live_end, c0 + kChunk,
                        min(kChunk, a.m - c0 - kChunk));
          } else if (!last_pass) {
            stage_chunk_codes(cbuf ? code0 : code1, a, p0 + kPass, un.live_end, 0, min(kChunk, a.m));
          } else {
            const K6Unit nu = unit_of(a, ranges, u + gridDim.x);
            stage_chunk_codes(cbuf ? code0 : code1, a, nu.base, nu.live_end, 0, min(kChunk, a.m));
          }
        }
        cp_async_commit();
        const uint8_t* codes = (cbuf ? code1 : code0) + warp_codes;
        if constexpr (kResident) {
          add_codes(acc, tab0 + lane_entries + c0 * a.ksub, codes, 0, cc, a.ksub);
        } else {
          for (int j0 = c0; j0 < c0 + cc; j0 += a.step) {
            const int cn = min(a.step, c0 + cc - j0);
            if (j0 > c0) {
              cp_async_wait_all();
              __syncthreads();   // this step's tables have landed; the last step's are free
            }
            // the next step's tables: of this chunk, or the next chunk's first
            if (j0 + cn < c0 + cc) {
              stage_streamed(tbuf ? tab0 : tab1, a, un.g * kQ, j0 + cn, min(a.step, c0 + cc - j0 - cn));
            } else if (more) {
              const int nj = c0 + kChunk < a.m ? c0 + kChunk : 0;
              const long long g = c0 + kChunk < a.m || !last_pass ? un.g : (u + gridDim.x) / ranges;
              stage_streamed(tbuf ? tab0 : tab1, a, g * kQ, nj, min(a.step, a.m - nj));
            }
            cp_async_commit();
            add_codes(acc, (tbuf ? tab1 : tab0) + lane_entries, codes, j0 - c0, cn, a.ksub);
            tbuf ^= 1;
          }
        }
        cbuf ^= 1;
      }
      const long long r0 = p0 + warp * kRows;
      const long long qi = un.g * kQ + lane;
      if (aligned) {
        if (qi < a.nq) {
          float* out_q = a.out + qi * a.blocks;
          if (a.block == 1) fold_store<1>(acc, r0, un.live_end, a.blocks, out_q);
          else if (a.block == 8) fold_store<8>(acc, r0, un.live_end, a.blocks, out_q);
          else fold_store<64>(acc, r0, un.live_end, a.blocks, out_q);
        }
      } else {
        fold_shared(acc, r0, un.base, min(p0 + kPass, un.end), un.live_end, a.block,
                    fold_s + lane);
      }
    }
    if (!aligned) {
      __syncthreads();   // the range's maxima are complete: write them out, reset
      for (int e = threadIdx.x; e < kMaxBpc * kQ; e += kK6Threads) {
        const long long q = un.g * kQ + (e & (kQ - 1));
        if (e < un.nb * kQ && q < a.nq) a.out[q * a.blocks + un.b0 + e / kQ] = key_float(fold_s[e]);
        fold_s[e] = kNegInfKey;
      }
    }
  }
  cp_async_wait_all();
}

template <typename LutT, bool kResident>
int launch_k6(const K6Args<LutT>& a, int smem, cudaStream_t s) {
  auto* kernel = adc_finemax_kernel<LutT, kResident>;
  static OptInFlags opted;   // the ceiling is kK6Smem: no K6 launch asks for more
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = opt_in_once(kernel, kK6Smem, smem, opted);
  if (err != cudaSuccess) return (int)err;
  const long long units = (a.nq + kQ - 1) / kQ * ((a.blocks + a.bpc - 1) / a.bpc);
  kernel<<<(unsigned)(units < sms ? units : sms), kK6Threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// 4-byte words from one query's staged tables to the next, for `j`
// subspaces of `esz`-byte entries: what they take, rounded up to 32, plus 1.
int k6_stride(int j, int ksub, int esz) { return ((j * ksub * esz + 3) / 4 + 31) / 32 * 32 + 1; }

template <typename LutT>
int launch_adc_finemax(const LutT* luts, const uint8_t* codes, long long nq, long long n, int m,
                       int ksub, long long block, long long blocks, float* out, cudaStream_t s) {
  K6Args<LutT> a;
  a.luts = luts;
  a.codes = codes;
  a.out = out;
  a.nq = nq;
  a.n = n;
  a.block = block;
  a.blocks = blocks;
  a.m = m;
  a.ksub = ksub;
  const long long per_pass = kPass / block;
  a.bpc = lane_folds(block) ? per_pass : per_pass < 1 ? 1 : per_pass < kMaxBpc ? per_pass : kMaxBpc;
  if (a.bpc * block > 0x7fffffffLL) return (int)cudaErrorInvalidValue;   // fold_shared's 32 bits
  const uintptr_t c = reinterpret_cast<uintptr_t>(codes);
  a.code_vec = m % 16 == 0 && c % 16 == 0 ? 16 : m % 4 == 0 && c % 4 == 0 ? 4 : 0;
  // Resident when every table of 32 queries fits as fp32; else two buffers
  // of `step` subspaces each (a power of two, so a step's codes lie in one
  // aligned word or whole words), stored as they come.
  constexpr int kEsz = (int)sizeof(LutT);
  const int resident_stride = k6_stride(m, ksub, 4);
  if (kQ * resident_stride * 4 <= kLutBytes) {
    a.step = kChunk;
    a.stride = resident_stride;
    a.async_tables = false;
    return launch_k6<LutT, true>(a, kQ * a.stride * 4 + 2 * kCodeBytes + kFoldBytes, s);
  }
  int j = 1;
  while (j < kChunk && 2 * kQ * 4 * k6_stride(2 * j, ksub, kEsz) <= kLutBytes) j *= 2;
  a.step = j;
  a.stride = k6_stride(j, ksub, kEsz);
  a.async_tables = ksub * kEsz % 4 == 0 && reinterpret_cast<uintptr_t>(luts) % 4 == 0;
  return launch_k6<LutT, false>(a, 2 * kQ * a.stride * 4 + 2 * kCodeBytes + kFoldBytes, s);
}

// --------------------------------------------------------------------------
// The rescore: rows on the lanes
// --------------------------------------------------------------------------

constexpr int kRsWarps = 8;                  // warps of a CTA, at most
constexpr int kRsChunk = 32;                 // subspaces a lane loads ahead: 32 bytes a row
constexpr int kRsWords = kRsChunk / 4;
constexpr int kRsLutBudget = 96 * 1024;      // staged fp32 tables a CTA, at most
constexpr int kRsMaxUnits = 4096;            // candidate blocks a CTA, at most
constexpr int kRsCtasPerSm = 8;              // the grid the split of kf aims at
// a CTA's shared memory, at most: the block row bases, then the tables
constexpr int kRsMaxSmem = ((8 * kRsMaxUnits + 15) & ~15) + kRsLutBudget;

struct RsArgs {
  const void* luts;        // (nq, m, ksub) fp32 or bf16
  const uint8_t* codes;    // (n, m)
  const long long* bids;   // (nq, kf)
  float* out;              // (nq, kf * block)
  long long nq, n, kf, nb;   // nb = ceil(n / block)
  int block, m, ksub;
  int jg;     // subspaces staged at once: m, or a multiple of 32
  int upc;    // candidate blocks a CTA
  int cpq;    // CTAs a query
};

// The kRsChunk (or fewer, `len`) code bytes of one row from `p` into w,
// byte t at bits 8 (t % 4) of w[t / 4]: VEC-byte loads (the row and the
// codes allow them) or bytes.
template <int VEC>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[kRsWords], const uint8_t* p, int len) {
  if constexpr (VEC == 16) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (16 * k < len) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
        w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
      }
  } else if constexpr (VEC == 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (8 * k < len) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + k);
        w[2 * k] = v.x; w[2 * k + 1] = v.y;
      }
  } else if constexpr (VEC == 4) {
#pragma unroll
    for (int k = 0; k < kRsWords; ++k)
      if (4 * k < len) w[k] = __ldg(reinterpret_cast<const uint32_t*>(p) + k);
  } else {
#pragma unroll
    for (int k = 0; k < kRsWords; ++k) w[k] = 0u;
#pragma unroll
    for (int t = 0; t < kRsChunk; ++t)
      if (t < len) w[t >> 2] |= static_cast<uint32_t>(__ldg(p + t)) << (8 * (t & 3));
  }
}

// adc_mac for the chunk's `len` subspaces in increasing order; `lut` is the
// staged fp32 table of the chunk's first subspace.
template <int KSUB>
__device__ __forceinline__ void add_chunk(float& acc, const uint32_t (&w)[kRsWords],
                                          const float* lut, int ksub_rt, int len) {
  const int ksub = KSUB ? KSUB : ksub_rt;
  if (len == kRsChunk) {
#pragma unroll
    for (int t = 0; t < kRsChunk; ++t)
      adc_mac(acc, lut + t * ksub, (w[t >> 2] >> (8 * (t & 3))) & 0xFF);
  } else {
#pragma unroll
    for (int t = 0; t < kRsChunk; ++t)
      if (t < len) adc_mac(acc, lut + t * ksub, (w[t >> 2] >> (8 * (t & 3))) & 0xFF);
  }
}

// A lane's row of one step: flat candidate row f = 32 * step + lane of the
// CTA's range, with its codes (live), or past n inside a valid block (-inf),
// or in an invalid block (NaN), or past the range.
enum RsState { kLive = 0, kPastN = 1, kInvalid = 2, kNone = 3 };

struct RsRow {
  const uint8_t* ptr;   // the row's codes from subspace j0 (live rows)
  int state;
};

__device__ __forceinline__ RsRow row_of(const RsArgs& a, const long long* base_s, int rows, int f,
                                        int j0) {
  RsRow r = {a.codes, kNone};
  if (f >= rows) return r;
  const int u = f / a.block;
  const long long base = base_s[u];
  const long long row = base + (f - u * a.block);
  r.state = base < 0 ? kInvalid : row >= a.n ? kPastN : kLive;
  if (r.state == kLive) r.ptr = a.codes + row * a.m + j0;
  return r;
}

// Stage tables j0 .. j0+jn-1 of query qi, widened to fp32, to lut_s: 16-byte
// loads where the run is aligned.
template <typename LutT>
__device__ __forceinline__ void stage_tables(float* lut_s, const RsArgs& a, long long qi, int j0,
                                             int jn) {
  const LutT* src = static_cast<const LutT*>(a.luts) + (qi * a.m + j0) * a.ksub;
  const int count = jn * a.ksub;
  constexpr int kPer = 16 / (int)sizeof(LutT);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = count / kPer;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + v);
      if constexpr (sizeof(LutT) == 4) {
        *reinterpret_cast<uint4*>(lut_s + 4 * v) = raw;
      } else {
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        float4 lo, hi;
        lo.x = __uint_as_float(w[0] << 16); lo.y = __uint_as_float(w[0] & 0xFFFF0000u);
        lo.z = __uint_as_float(w[1] << 16); lo.w = __uint_as_float(w[1] & 0xFFFF0000u);
        hi.x = __uint_as_float(w[2] << 16); hi.y = __uint_as_float(w[2] & 0xFFFF0000u);
        hi.z = __uint_as_float(w[3] << 16); hi.w = __uint_as_float(w[3] & 0xFFFF0000u);
        *reinterpret_cast<float4*>(lut_s + 8 * v) = lo;
        *reinterpret_cast<float4*>(lut_s + 8 * v + 4) = hi;
      }
    }
    done = vecs * kPer;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) lut_s[e] = widen(src[e]);
}

// The rescore. CTA x takes query x / cpq and its candidate blocks [u0, u0 +
// upc), u0 = (x % cpq) * upc: it stages their row bases and the query's
// tables (widened to fp32) once, then its warps walk the range's flat
// candidate rows 32 at a time, one a lane. A lane loads kRsChunk code bytes
// of its row in 16-byte vectors (where m and the codes allow), the next
// chunk's (or the next step's first) loads issued before this chunk's
// lookups, and keeps one fp32 accumulator (adc_mac, j increasing). Tables larger than kRsLutBudget are staged jg
// subspaces at a time; the partial sums wait in `out` (an fp32 store and
// load are exact) between groups, so the order of the adds holds.
template <typename LutT, int VEC, int KSUB>
__global__ void __launch_bounds__(32 * kRsWarps, 4)
adc_rescore_kernel(const RsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* const base_s = reinterpret_cast<long long*>(smem);   // upc row bases, -1 invalid
  float* const lut_s = reinterpret_cast<float*>(smem + ((8 * a.upc + 15) & ~15));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long long qi = blockIdx.x / a.cpq;
  const long long u0 = (long long)(blockIdx.x % a.cpq) * a.upc;
  const int units = (int)min((long long)a.upc, a.kf - u0);
  const int rows = units * a.block;
  const int steps = (rows + 31) / 32;
  float* const out = a.out + qi * (a.kf * a.block) + u0 * a.block;
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    const long long b = a.bids[qi * a.kf + u0 + i];
    base_s[i] = b >= 0 && b < a.nb ? b * a.block : -1;
  }
  for (int j0 = 0; j0 < a.m; j0 += a.jg) {
    const int jn = min(a.jg, a.m - j0);
    const bool first = j0 == 0, last = j0 + jn == a.m;
    if (!first) __syncthreads();   // every warp is done with the last group's tables
    stage_tables<LutT>(lut_s, a, qi, j0, jn);
    __syncthreads();
    int step = warp;
    if (step >= steps) continue;
    RsRow r = row_of(a, base_s, rows, 32 * step + lane, j0), rn = r;
    uint32_t cur[kRsWords], nxt[kRsWords] = {};
    if (r.state == kLive) load_chunk<VEC>(cur, r.ptr, min(kRsChunk, jn));
    while (true) {
      const int f = 32 * step + lane;
      float acc = !first && r.state == kLive ? out[f] : 0.0f;
      for (int c = 0; c < jn; c += kRsChunk) {
        // the next loads: this row's next chunk, or the next step's row's first
        if (c + kRsChunk < jn) {
          if (r.state == kLive) load_chunk<VEC>(nxt, r.ptr + c + kRsChunk, min(kRsChunk, jn - c - kRsChunk));
        } else if (step + nwarps < steps) {
          rn = row_of(a, base_s, rows, f + 32 * nwarps, j0);
          if (rn.state == kLive) load_chunk<VEC>(nxt, rn.ptr, min(kRsChunk, jn));
        }
        if (r.state == kLive) add_chunk<KSUB>(acc, cur, lut_s + c * a.ksub, a.ksub, min(kRsChunk, jn - c));
#pragma unroll
        for (int k = 0; k < kRsWords; ++k) cur[k] = nxt[k];
      }
      if (r.state == kLive) {
        out[f] = acc;
      } else if (last && r.state != kNone) {
        out[f] = r.state == kInvalid ? NAN : -INFINITY;
      }
      step += nwarps;
      if (step >= steps) break;
      r = rn;
    }
  }
}

template <typename LutT, int VEC>
cudaError_t launch_rescore_vec(const RsArgs& a, int warps, int smem, cudaStream_t s) {
  const int which = a.ksub == 16 ? 0 : a.ksub == 256 ? 1 : 2;
  void (*kernel)(const RsArgs) = which == 0   ? &adc_rescore_kernel<LutT, VEC, 16>
                                 : which == 1 ? &adc_rescore_kernel<LutT, VEC, 256>
                                              : &adc_rescore_kernel<LutT, VEC, 0>;
  static OptInFlags opted[3];   // one set of flags per kernel above
  cudaError_t err = opt_in_once(kernel, kRsMaxSmem, smem, opted[which]);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(a.nq * a.cpq), 32 * warps, smem, s>>>(a);
  return cudaGetLastError();
}

// The rescore's geometry: tables staged whole where they fit kRsLutBudget
// (else jg subspaces, a multiple of 32, at a time); a query's kf blocks
// split over cpq CTAs so the grid holds about kRsCtasPerSm CTAs an SM, but
// no CTA stages more table bytes than it reads codes; 16-byte code loads
// where m and the codes allow, else 8, 4 or 1.
template <typename LutT>
int launch_rescore(const void* luts, const uint8_t* codes, const long long* bids, long long nq,
                   long long n, int m, int ksub, long long block, long long kf, float* out,
                   cudaStream_t s) {
  if (block > (1 << 24) || nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  RsArgs a;
  a.luts = luts;
  a.codes = codes;
  a.bids = bids;
  a.out = out;
  a.nq = nq;
  a.n = n;
  a.kf = kf;
  a.nb = (n + block - 1) / block;
  a.block = (int)block;
  a.m = m;
  a.ksub = ksub;
  const long long table_bytes = 4LL * m * ksub;
  a.jg = table_bytes <= kRsLutBudget ? m : kRsLutBudget / (4 * ksub) / kRsChunk * kRsChunk;
  long long cpq = ((long long)kRsCtasPerSm * sms + nq - 1) / nq;
  const long long by_tables = kf * block * m / table_bytes;   // CTAs whose codes outweigh the tables
  cpq = cpq < by_tables ? cpq : by_tables;
  cpq = cpq < kf ? cpq : kf;
  cpq = cpq > 1 ? cpq : 1;
  long long upc = (kf + cpq - 1) / cpq;
  upc = upc < kRsMaxUnits ? upc : kRsMaxUnits;
  while (upc > 1 && upc * block > (1LL << 30)) upc /= 2;   // a CTA's rows index in 32 bits
  if (upc * block > (1LL << 30)) return (int)cudaErrorInvalidValue;
  a.upc = (int)upc;
  a.cpq = (int)((kf + upc - 1) / upc);
  if (nq * a.cpq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long steps = (upc * block + 31) / 32;
  const int warps = (int)(steps < kRsWarps ? steps : kRsWarps);
  const int smem = ((8 * a.upc + 15) & ~15) + 4 * a.jg * ksub;
  const uintptr_t c = reinterpret_cast<uintptr_t>(codes);
  if (m % 16 == 0 && c % 16 == 0) return (int)launch_rescore_vec<LutT, 16>(a, warps, smem, s);
  if (m % 8 == 0 && c % 8 == 0) return (int)launch_rescore_vec<LutT, 8>(a, warps, smem, s);
  if (m % 4 == 0 && c % 4 == 0) return (int)launch_rescore_vec<LutT, 4>(a, warps, smem, s);
  return (int)launch_rescore_vec<LutT, 1>(a, warps, smem, s);
}

bool bad_operands(long long nq, long long n, int m, int ksub, long long block) {
  return nq <= 0 || n <= 0 || m <= 0 || ksub <= 0 || ksub > 256 || block <= 0;
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns the
// launch error (cudaSuccess == 0). Arguments are checked by the Python
// wrappers (dirjax_torch/ops/pq.py); these reject only what would mis-launch.

// K6: luts (nq, m, ksub) fp32 (lut_bf16 = 0) or bf16 (1); codes (n, m)
// uint8; out (nq, ceil(n / block)) fp32.
extern "C" int dirjax_adc_finemax(const void* luts, int lut_bf16, const void* codes, long long nq,
                                  long long n, int m, int ksub, long long block, float* out,
                                  void* stream) {
  if (bad_operands(nq, n, m, ksub, block)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  return lut_bf16 ? launch_adc_finemax(static_cast<const __nv_bfloat16*>(luts), c, nq, n, m, ksub,
                                       block, blocks, out, s)
                  : launch_adc_finemax(static_cast<const float*>(luts), c, nq, n, m, ksub, block,
                                       blocks, out, s);
}

// The rescore: bids (nq, kf) int64 block ids, out (nq, kf * block) fp32.
extern "C" int dirjax_adc_gather_scores(const void* luts, int lut_bf16, const void* codes,
                                        const long long* bids, long long nq, long long n, int m,
                                        int ksub, long long block, long long kf, float* out,
                                        void* stream) {
  if (bad_operands(nq, n, m, ksub, block) || kf <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  return lut_bf16
             ? launch_rescore<__nv_bfloat16>(luts, c, bids, nq, n, m, ksub, block, kf, out, s)
             : launch_rescore<float>(luts, c, bids, nq, n, m, ksub, block, kf, out, s);
}

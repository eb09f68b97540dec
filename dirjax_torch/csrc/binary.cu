// Binary-code scoring kernels for Hopper (sm_90a): K5 of the binary serving
// path and its asymmetric rescore.
//
// Replaces the TPU kernel of dirjax/ops/binary.py:
//   K5 dirjax_bits_finemax <- _bits_finemax_kernel (binary.py:357, launched by
//      _bits_finemax_call): streams the packed codes (n rows of W 32-bit
//      words, LSB first: bit b of word w is dim 32w + b) once and writes only
//      the maximum score over each 8 consecutive rows (a fine block),
//      query-major (nq, blocks); rows >= n score -inf. Two scores:
//        symmetric  (asym = 0): packed query words, n_bits - 2 * sum_w
//          popc(q_w ^ r_w), exact; it equals dirjax's +-1 int8 dot;
//        asymmetric (asym = 1): bf16 projected queries; per bit d, + or -
//          float(q_d) into an fp32 accumulator.
//   dirjax_bits_gather_scores, the asymmetric rescore: the counterpart of
//      dirjax's XLA _bits_finish_asym (binary.py:513), not of a TPU kernel.
//      Per query, it reads the 8 rows of each candidate fine block named by
//      `bids` (2 KB contiguous at 2048 bits) and rescores them -> (nq, kf*8).
//
// Containment (topk_pallas.py:24-29) needs the rescore to reproduce K5's
// asymmetric maxima bit for bit. Both score a (row, query) pair through the
// one routine `bits_mac`: one fp32 accumulator per pair, from 0, fed
// fmaf(+-1, q_d, acc) for d = 0, 1, ... in increasing order (a +-1 factor
// makes the fma round once, exactly as acc +- q_d does). Words past W enter
// as zero query values in both kernels and leave the sum unchanged.
//
// What bounds K5: at the serving shape (1,048,576 rows x 2048 bits, nq = 256)
// it reads 268 MB of codes (0.08 ms at 3.35 TB/s) against 5.5e11 +-1
// products: 0.54 ms on the int8 tensor cores (symmetric), 1.09 ms on the
// bf16 ones (asymmetric). This first design runs on the CUDA cores: each
// thread owns one fine block (8 rows) x TN queries of accumulators; the block
// stages a few code words of 128 rows and of up to 128 queries (asymmetric:
// the bits' query values, widened to fp32) in shared memory. Symmetric does
// one __popc per (row, query, word) at 16 per SM per clock (1.7e10 of them,
// >= 4.2 ms); asymmetric one fp32 fma per (row, query, bit), >= 16 ms.
// Unpacking to int8/bf16 fragments for wgmma is later work. The rescore is
// bound by reading its candidate rows (nq * kf * 8 rows of n_bits / 8 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerBlock = 8;                         // fine block
constexpr int kFineBlocks = 16;                          // fine blocks per tile
constexpr int kTileRows = kFineBlocks * kRowsPerBlock;   // 128 rows per tile
constexpr int kQueryGroups = 16;                         // thread rows per tile
constexpr int kThreads = kFineBlocks * kQueryGroups;     // 256
constexpr int kSymWords = 16;                            // words per stage
constexpr int kAsymWords = 2;                            // words per stage
constexpr int kGatherThreads = 128;                      // rescore: 16 blocks
constexpr int kGatherWords = 8;                          // rescore words/stage
constexpr int kMaxGridY = 65535;

// +1.0f where bit b of `word` is set, -1.0f where it is clear.
__device__ __forceinline__ float sign_of(uint32_t word, int b) {
  return __uint_as_float(0xbf800000u ^ ((word << (31 - b)) & 0x80000000u));
}

// The one asymmetric (row, query) step that K5 and the rescore share:
// acc += (bit b of the row's word ? +q : -q), rounded once.
__device__ __forceinline__ void bits_mac(float& acc, uint32_t word, int b, float q) {
  acc = fmaf(sign_of(word, b), q, acc);
}

template <bool kAsym, int TN> struct Stage;

// Symmetric staging: kSymWords code words of 128 rows and of the queries.
template <int TN> struct Stage<false, TN> {
  static constexpr int kWords = kSymWords;
  static constexpr int kQ = kQueryGroups * TN;
  uint32_t a[kWords][kTileRows + 1];
  uint32_t b[kWords][kQ + 1];
};

// Asymmetric staging: kAsymWords code words of 128 rows and the query values
// of their 32 * kAsymWords bits, widened to fp32.
template <int TN> struct Stage<true, TN> {
  static constexpr int kWords = kAsymWords;
  static constexpr int kQ = kQueryGroups * TN;
  uint32_t a[kWords][kTileRows + 1];
  float b[32 * kWords][kQ + 1];
};

// K5. Grid (ceil(nq / (16*TN)), min(row tiles, 65535)); blocks stride over
// the row tiles. Thread (tx, ty) owns rows t*128 + tx*8 + i (i < 8) against
// queries q0 + ty*TN + j (j < TN). out is (nq, blocks) fp32.
template <bool kAsym, int TN>
__global__ void __launch_bounds__(kThreads)
bits_finemax_kernel(const void* __restrict__ qv, const uint32_t* __restrict__ db,
                    long long nq, long long n, int words, long long blocks,
                    float* __restrict__ out) {
  using S = Stage<kAsym, TN>;
  using Acc = typename std::conditional<kAsym, float, int>::type;
  __shared__ S sm;
  const int tid = threadIdx.x;
  const int tx = tid % kFineBlocks;
  const int ty = tid / kFineBlocks;
  const long long q0 = (long long)blockIdx.x * S::kQ;
  const long long tiles = (blocks + kFineBlocks - 1) / kFineBlocks;
  const int n_bits = 32 * words;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long row0 = t * kTileRows;
    Acc acc[kRowsPerBlock][TN];
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

    for (int w0 = 0; w0 < words; w0 += S::kWords) {
      for (int e = tid; e < kTileRows * S::kWords; e += kThreads) {
        const int rl = e / S::kWords, w = e % S::kWords;
        const long long row = row0 + rl;
        // a thread's 8 rows are 16 words apart: the 16 fine blocks of a warp
        // read 16 consecutive words
        sm.a[w][(rl % kRowsPerBlock) * kFineBlocks + rl / kRowsPerBlock] =
            (row < n && w0 + w < words) ? db[row * words + w0 + w] : 0u;
      }
      if constexpr (kAsym) {
        const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qv);
        constexpr int kBits = 32 * S::kWords;
        for (int e = tid; e < S::kQ * kBits; e += kThreads) {
          const int ql = e / kBits, d = e % kBits;
          const long long qi = q0 + ql;
          const int col = 32 * w0 + d;
          sm.b[d][ql] = (qi < nq && col < n_bits) ? __bfloat162float(q[qi * n_bits + col])
                                                  : 0.0f;
        }
      } else {
        const uint32_t* q = static_cast<const uint32_t*>(qv);
        for (int e = tid; e < S::kQ * S::kWords; e += kThreads) {
          const int ql = e / S::kWords, w = e % S::kWords;
          const long long qi = q0 + ql;
          sm.b[w][ql] = (qi < nq && w0 + w < words) ? q[qi * words + w0 + w] : 0u;
        }
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < S::kWords; ++w) {
        uint32_t a[kRowsPerBlock];
#pragma unroll
        for (int i = 0; i < kRowsPerBlock; ++i) a[i] = sm.a[w][i * kFineBlocks + tx];
        if constexpr (kAsym) {
#pragma unroll 4
          for (int b = 0; b < 32; ++b) {
            float qb[TN];
#pragma unroll
            for (int j = 0; j < TN; ++j) qb[j] = sm.b[32 * w + b][ty * TN + j];
#pragma unroll
            for (int i = 0; i < kRowsPerBlock; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) bits_mac(acc[i][j], a[i], b, qb[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const uint32_t qw = sm.b[w][ty * TN + j];
#pragma unroll
            for (int i = 0; i < kRowsPerBlock; ++i) acc[i][j] += __popc(a[i] ^ qw);
          }
        }
      }
      __syncthreads();
    }

    const long long blk = t * kFineBlocks + tx;
    if (blk >= blocks) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long qi = q0 + ty * TN + j;
      if (qi >= nq) continue;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kRowsPerBlock; ++i) {
        if (blk * kRowsPerBlock + i < n) {
          float s;
          if constexpr (kAsym) s = acc[i][j];
          else s = __int2float_rn(n_bits - 2 * acc[i][j]);
          m = fmaxf(m, s);
        }
      }
      out[qi * blocks + blk] = m;
    }
  }
}

// The rescore. Grid (nq, ceil(kf / 16)); thread t scores row t % 8 of
// candidate fine block t / 8 of this block's 16. A block id outside the rows
// (or one whose 8 rows pass n) yields NaN: the caller never asks for one.
__global__ void __launch_bounds__(kGatherThreads)
bits_gather_scores_kernel(const __nv_bfloat16* __restrict__ q,
                          const uint32_t* __restrict__ db,
                          const long long* __restrict__ bids, long long nq,
                          long long n, int words, long long kf,
                          float* __restrict__ out) {
  constexpr int kBlocks = kGatherThreads / kRowsPerBlock;
  constexpr int kBits = 32 * kGatherWords;
  __shared__ uint32_t rs[kGatherThreads][kGatherWords + 1];
  __shared__ float qs[kBits];
  __shared__ long long first_row[kBlocks];
  const int t = threadIdx.x;
  const long long qi = blockIdx.x;
  const long long c0 = (long long)blockIdx.y * kBlocks;
  const int n_bits = 32 * words;
  if (t < kBlocks) {
    long long r = -1;
    if (c0 + t < kf) {
      const long long b = bids[qi * kf + c0 + t];
      if (b >= 0 && b * kRowsPerBlock + kRowsPerBlock <= n) r = b * kRowsPerBlock;
    }
    first_row[t] = r;
  }
  __syncthreads();
  float acc = 0.0f;
  for (int w0 = 0; w0 < words; w0 += kGatherWords) {
    for (int e = t; e < kBits; e += kGatherThreads) {
      const int col = 32 * w0 + e;
      qs[e] = col < n_bits ? __bfloat162float(q[qi * n_bits + col]) : 0.0f;
    }
    for (int e = t; e < kGatherThreads * kGatherWords; e += kGatherThreads) {
      const int rl = e / kGatherWords, w = e % kGatherWords;
      const long long r0 = first_row[rl / kRowsPerBlock];
      rs[rl][w] = (r0 >= 0 && w0 + w < words)
                      ? db[(r0 + rl % kRowsPerBlock) * words + w0 + w]
                      : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kGatherWords; ++w) {
      const uint32_t word = rs[t][w];
#pragma unroll 8
      for (int b = 0; b < 32; ++b) bits_mac(acc, word, b, qs[32 * w + b]);
    }
    __syncthreads();
  }
  if (c0 + t / kRowsPerBlock < kf) {
    out[qi * kf * kRowsPerBlock + c0 * kRowsPerBlock + t] =
        first_row[t / kRowsPerBlock] >= 0 ? acc : NAN;
  }
}

unsigned grid_y(long long units) {
  return (unsigned)(units < kMaxGridY ? units : kMaxGridY);
}

template <bool kAsym>
int launch_bits_finemax(const void* q, const uint32_t* db, long long nq,
                        long long n, int words, long long blocks, float* out,
                        cudaStream_t s) {
  const unsigned gy = grid_y((blocks + kFineBlocks - 1) / kFineBlocks);
  if (nq <= kQueryGroups) {
    bits_finemax_kernel<kAsym, 1><<<dim3((unsigned)((nq + 15) / 16), gy), kThreads, 0, s>>>(
        q, db, nq, n, words, blocks, out);
  } else if (nq <= 4 * kQueryGroups) {
    bits_finemax_kernel<kAsym, 4><<<dim3((unsigned)((nq + 63) / 64), gy), kThreads, 0, s>>>(
        q, db, nq, n, words, blocks, out);
  } else {
    bits_finemax_kernel<kAsym, 8><<<dim3((unsigned)((nq + 127) / 128), gy), kThreads, 0, s>>>(
        q, db, nq, n, words, blocks, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns the
// launch error (cudaSuccess == 0). Arguments are checked by the Python
// wrappers (dirjax_torch/ops/binary.py); these reject only what would
// mis-launch.

// K5: q is (nq, words) uint32 packed codes (asym = 0) or (nq, 32 * words)
// bf16 (asym = 1); db is (n, words) uint32; out is (nq, blocks), blocks >=
// ceil(n / 8).
extern "C" int dirjax_bits_finemax(const void* q, const void* db, int asym,
                                   long long nq, long long n, int words,
                                   long long blocks, float* out, void* stream) {
  if (nq <= 0 || n <= 0 || words <= 0 || blocks * kRowsPerBlock < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* codes = static_cast<const uint32_t*>(db);
  return asym ? launch_bits_finemax<true>(q, codes, nq, n, words, blocks, out, s)
              : launch_bits_finemax<false>(q, codes, nq, n, words, blocks, out, s);
}

// The rescore: q is (nq, 32 * words) bf16, bids (nq, kf) int64, out
// (nq, kf * 8) fp32.
extern "C" int dirjax_bits_gather_scores(const void* q, const void* db,
                                         const long long* bids, long long nq,
                                         long long n, int words, long long kf,
                                         float* out, void* stream) {
  constexpr long long kBlocks = kGatherThreads / kRowsPerBlock;
  if (nq <= 0 || n <= 0 || words <= 0 || kf <= 0 ||
      (kf + kBlocks - 1) / kBlocks > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nq, (unsigned)((kf + kBlocks - 1) / kBlocks));
  bits_gather_scores_kernel<<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint32_t*>(db), bids,
      nq, n, words, kf, out);
  return (int)cudaGetLastError();
}

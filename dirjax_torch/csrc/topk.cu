// Top-k scoring kernels for Hopper (sm_90a): the dense serving path's K2, K3
// and K4.
//
// Replaces the TPU kernels of dirjax/ops/topk_pallas.py:
//   K2 dirjax_fused_topk    <- _kernel (launched by _fused): per database slab,
//      scores against a group of queries, then k rounds of max -> lowest
//      index -> knock-out. Writes (nq, slabs*k) values and int64 indices,
//      -inf/-1 where a slab has fewer than k live rows.
//   K3 dirjax_finemax       <- _finemax_kernel / _scaled_finemax_kernel
//      (launched by _finemax_phase1): streams the database once and writes
//      only the maximum score over each 8 consecutive rows (a fine block),
//      query-major (nq, blocks), after an optional per-row scale; rows >= n
//      score -inf. The (nq, n) score matrix never exists.
//   K4 dirjax_gather_scores <- _gather_score_kernel (launched by
//      _gather_scores): per query, reads the 8 rows of each candidate fine
//      block named by `bids` and rescores them -> raw (nq, kf*8).
//
// Operand modes (database row x query), as _score_dot fixes them:
//   0 fp32 x fp32, 1 bf16 x bf16, 2 int8 x bf16 (fp32 accumulation; the
//   int8 value and every product are exact in fp32), 3 int8 x int8 (exact
//   int32 accumulation, then one round to fp32).
//
// Containment (topk_pallas.py:24-29) needs K4's rescored rows to reproduce
// K3's maxima bit for bit. Both score a (row, query) pair through the one
// routine `mac` below: one accumulator per pair, starting at 0, fed by fmaf
// (or an exact int32 multiply-add) over d = 0, 1, ... in increasing order,
// and padded with zero operands to a multiple of kChunk in both kernels.
// K3 applies the int8 row scale after the dot as one fp32 multiply, which is
// what the caller's finish step does to K4's raw scores.
//
// What bounds them: at the serving shape (n = 1M rows of D = 2048 bf16,
// nq = 256) K3 reads 4.3 GB (>= 1.3 ms at 3.35 TB/s) against 1.07 TFLOP.
// This first design runs that on the CUDA cores (fp32 FMA, ~67 TFLOP/s peak,
// so >= 16 ms): each thread owns one fine block (8 rows) x TN queries of
// accumulators, and the block stages 16-wide d slices of 128 rows and up to
// 128 queries in shared memory, widened to the compute type. Tensor cores
// (wmma/wgmma) and a TMA pipeline are later work. K4 is bound by the reads
// of its candidate rows (nq * kf * 8 rows), and K2 by the same contraction
// as K3 (queries are taken 16 to a block, so a slab is re-read from L2 once
// per query group; the grid runs the groups of one slab side by side).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;                         // fine block (_RPB)
constexpr int kFineBlocks = 16;                          // fine blocks per tile
constexpr int kTileRows = kFineBlocks * kRowsPerBlock;   // 128 rows per tile
constexpr int kQueryGroups = 16;                         // thread rows per tile
constexpr int kThreads = kFineBlocks * kQueryGroups;     // 256
constexpr int kChunk = 16;                               // d values per stage
constexpr int kSlab = 512;                               // K2 rows per slab
constexpr int kGatherThreads = 128;                      // K4: 16 fine blocks
constexpr int kMaxGridY = 65535;

enum Mode { kF32 = 0, kBF16 = 1, kI8BF16 = 2, kI8I8 = 3 };

template <int M> struct Traits;
template <> struct Traits<kF32> {
  using R = float; using Q = float; using C = float; using Acc = float;
};
template <> struct Traits<kBF16> {
  using R = __nv_bfloat16; using Q = __nv_bfloat16; using C = float; using Acc = float;
};
template <> struct Traits<kI8BF16> {
  using R = int8_t; using Q = __nv_bfloat16; using C = float; using Acc = float;
};
template <> struct Traits<kI8I8> {
  using R = int8_t; using Q = int8_t; using C = int; using Acc = int;
};

// Exact widening of an operand to the compute type.
template <typename C> struct Widen;
template <> struct Widen<float> {
  __device__ static float of(float v) { return v; }
  __device__ static float of(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float of(int8_t v) { return static_cast<float>(v); }
};
template <> struct Widen<int> {
  __device__ static int of(int8_t v) { return static_cast<int>(v); }
};

// The one (row, query) contraction step that K2, K3 and K4 share.
__device__ __forceinline__ void mac(float& acc, float row, float query) {
  acc = fmaf(row, query, acc);
}
__device__ __forceinline__ void mac(int& acc, int row, int query) {
  acc += row * query;
}
__device__ __forceinline__ float score_of(float acc) { return acc; }
__device__ __forceinline__ float score_of(int acc) { return __int2float_rn(acc); }

// acc[i][j] = score of row row0 + tx*8 + i against query q0 + ty*TN + j, for
// the 128-row x (16*TN)-query tile of one thread block. Rows >= n, queries
// >= nq and d >= D enter as zero operands. Ends with a barrier, so the
// staging buffers may be reused at once.
template <int M, int TN>
struct TileScorer {
  using R = typename Traits<M>::R;
  using Q = typename Traits<M>::Q;
  using C = typename Traits<M>::C;
  using Acc = typename Traits<M>::Acc;
  static constexpr int kQ = kQueryGroups * TN;

  // a[d][(r % 8) * 16 + r / 8]: a thread's 8 rows are 16 words apart, so the
  // 16 fine blocks of a warp read 16 consecutive words. Row stride 129 keeps
  // the transposing stores free of bank conflicts.
  struct Smem {
    C a[kChunk][kTileRows + 1];
    C b[kChunk][kQ + 1];
  };

  __device__ __forceinline__ static void run(
      Smem& sm, const R* __restrict__ db, const Q* __restrict__ q, long long n,
      long long nq, int d, long long row0, long long q0,
      Acc (&acc)[kRowsPerBlock][TN]) {
    const int tid = threadIdx.x;
    const int tx = tid % kFineBlocks;
    const int ty = tid / kFineBlocks;
#pragma unroll
    for (int i = 0; i < kRowsPerBlock; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

    for (int d0 = 0; d0 < d; d0 += kChunk) {
      for (int e = tid; e < kTileRows * kChunk; e += kThreads) {
        const int rl = e / kChunk, dd = e % kChunk;
        const long long row = row0 + rl;
        const int col = d0 + dd;
        sm.a[dd][(rl % kRowsPerBlock) * kFineBlocks + rl / kRowsPerBlock] =
            (row < n && col < d) ? Widen<C>::of(db[row * d + col]) : C(0);
      }
      for (int e = tid; e < kQ * kChunk; e += kThreads) {
        const int ql = e / kChunk, dd = e % kChunk;
        const long long qi = q0 + ql;
        const int col = d0 + dd;
        sm.b[dd][ql] = (qi < nq && col < d) ? Widen<C>::of(q[qi * d + col]) : C(0);
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < kChunk; ++dd) {
        C a[kRowsPerBlock], b[TN];
#pragma unroll
        for (int i = 0; i < kRowsPerBlock; ++i) a[i] = sm.a[dd][i * kFineBlocks + tx];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sm.b[dd][ty * TN + j];
#pragma unroll
        for (int i = 0; i < kRowsPerBlock; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) mac(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }
  }
};

// K3. Grid (ceil(nq / (16*TN)), min(row tiles, 65535)); blocks stride over
// the row tiles. out is (nq, blocks) fp32, block b = rows [8b, 8b + 8).
template <int M, int TN>
__global__ void __launch_bounds__(kThreads)
finemax_kernel(const typename Traits<M>::Q* __restrict__ q,
               const typename Traits<M>::R* __restrict__ db,
               const float* __restrict__ scales, long long nq, long long n,
               int d, long long blocks, float* __restrict__ out) {
  using S = TileScorer<M, TN>;
  __shared__ typename S::Smem sm;
  const int tx = threadIdx.x % kFineBlocks;
  const int ty = threadIdx.x / kFineBlocks;
  const long long q0 = (long long)blockIdx.x * S::kQ;
  const long long tiles = (blocks + kFineBlocks - 1) / kFineBlocks;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    typename S::Acc acc[kRowsPerBlock][TN];
    S::run(sm, db, q, n, nq, d, t * kTileRows, q0, acc);
    const long long blk = t * kFineBlocks + tx;
    if (blk >= blocks) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long qi = q0 + ty * TN + j;
      if (qi >= nq) continue;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kRowsPerBlock; ++i) {
        const long long row = blk * kRowsPerBlock + i;
        if (row < n) {
          float s = score_of(acc[i][j]);
          if (scales != nullptr) s = __fmul_rn(s, scales[row]);
          m = fmaxf(m, s);
        }
      }
      out[qi * blocks + blk] = m;
    }
  }
}

// K2. Grid (ceil(nq / 16), min(slabs, 65535)): the query groups of one slab
// are neighbours in launch order, so they share the slab through L2. Each
// block scores 16 queries against a 512-row slab into shared memory, then
// each warp selects for 2 of the queries.
template <int M>
__global__ void __launch_bounds__(kThreads)
fused_topk_kernel(const typename Traits<M>::Q* __restrict__ q,
                  const typename Traits<M>::R* __restrict__ db, long long nq,
                  long long n, int d, int k, long long slabs,
                  float* __restrict__ vals, long long* __restrict__ idxs) {
  using S = TileScorer<M, 1>;
  __shared__ typename S::Smem sm;
  __shared__ float scores[kQueryGroups][kSlab + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kFineBlocks;
  const int ty = tid / kFineBlocks;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q0 = (long long)blockIdx.x * kQueryGroups;
  for (long long slab = blockIdx.y; slab < slabs; slab += gridDim.y) {
    for (int pass = 0; pass < kSlab / kTileRows; ++pass) {
      const long long row0 = slab * kSlab + pass * kTileRows;
      typename S::Acc acc[kRowsPerBlock][1];
      S::run(sm, db, q, n, nq, d, row0, q0, acc);
#pragma unroll
      for (int i = 0; i < kRowsPerBlock; ++i) {
        const int c = tx * kRowsPerBlock + i;
        scores[ty][pass * kTileRows + c] =
            row0 + c < n ? score_of(acc[i][0]) : -INFINITY;
      }
    }
    __syncthreads();
    for (int ql = warp; ql < kQueryGroups; ql += kThreads / 32) {
      const long long qi = q0 + ql;
      if (qi >= nq) continue;
      float* s = scores[ql];
      float* v_out = vals + (qi * slabs + slab) * k;
      long long* i_out = idxs + (qi * slabs + slab) * k;
      for (int r = 0; r < k; ++r) {
        float best = -INFINITY;
        int arg = 0x7fffffff;
        for (int c = lane; c < kSlab; c += 32) {  // increasing c: ties keep the first
          const float v = s[c];
          if (v > best) { best = v; arg = c; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
          if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
        }
        const bool live = best > -INFINITY;
        if (lane == 0) {
          v_out[r] = best;
          i_out[r] = live ? slab * kSlab + arg : -1;
        }
        if (live && lane == (arg & 31)) s[arg] = -INFINITY;  // knock out
        __syncwarp();
      }
    }
    __syncthreads();  // the next slab overwrites the scores
  }
}

// K4. Grid (nq, ceil(kf / 16)); thread t scores row t % 8 of candidate fine
// block t / 8 of this block's 16. A block id outside the rows (or one whose
// 8 rows pass n) yields NaN: the caller never asks for one.
template <int M>
__global__ void __launch_bounds__(kGatherThreads)
gather_scores_kernel(const typename Traits<M>::Q* __restrict__ q,
                     const typename Traits<M>::R* __restrict__ db,
                     const long long* __restrict__ bids, long long nq,
                     long long n, int d, long long kf, float* __restrict__ out) {
  using C = typename Traits<M>::C;
  constexpr int kBlocks = kGatherThreads / kRowsPerBlock;
  __shared__ C rs[kGatherThreads][kChunk + 1];
  __shared__ C qs[kChunk];
  __shared__ long long first_row[kBlocks];
  const int t = threadIdx.x;
  const long long qi = blockIdx.x;
  const long long c0 = (long long)blockIdx.y * kBlocks;
  if (t < kBlocks) {
    long long r = -1;
    if (c0 + t < kf) {
      const long long b = bids[qi * kf + c0 + t];
      if (b >= 0 && b * kRowsPerBlock + kRowsPerBlock <= n) r = b * kRowsPerBlock;
    }
    first_row[t] = r;
  }
  __syncthreads();
  typename Traits<M>::Acc acc = 0;
  for (int d0 = 0; d0 < d; d0 += kChunk) {
    if (t < kChunk) qs[t] = d0 + t < d ? Widen<C>::of(q[qi * d + d0 + t]) : C(0);
    for (int e = t; e < kGatherThreads * kChunk; e += kGatherThreads) {
      const int rl = e / kChunk, dd = e % kChunk;
      const long long r0 = first_row[rl / kRowsPerBlock];
      const int col = d0 + dd;
      rs[rl][dd] = (r0 >= 0 && col < d)
                       ? Widen<C>::of(db[(r0 + rl % kRowsPerBlock) * d + col])
                       : C(0);
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kChunk; ++dd) mac(acc, rs[t][dd], qs[dd]);
    __syncthreads();
  }
  if (c0 + t / kRowsPerBlock < kf) {
    out[qi * kf * kRowsPerBlock + c0 * kRowsPerBlock + t] =
        first_row[t / kRowsPerBlock] >= 0 ? score_of(acc) : NAN;
  }
}

unsigned grid_y(long long units) {
  return (unsigned)(units < kMaxGridY ? units : kMaxGridY);
}

template <int M>
int launch_finemax(const void* q, const void* db, const float* scales,
                   long long nq, long long n, int d, long long blocks,
                   float* out, cudaStream_t s) {
  using Q = typename Traits<M>::Q;
  using R = typename Traits<M>::R;
  const Q* qp = static_cast<const Q*>(q);
  const R* dbp = static_cast<const R*>(db);
  const unsigned gy = grid_y((blocks + kFineBlocks - 1) / kFineBlocks);
  if (nq <= kQueryGroups) {
    finemax_kernel<M, 1><<<dim3((unsigned)((nq + 15) / 16), gy), kThreads, 0, s>>>(
        qp, dbp, scales, nq, n, d, blocks, out);
  } else if (nq <= 4 * kQueryGroups) {
    finemax_kernel<M, 4><<<dim3((unsigned)((nq + 63) / 64), gy), kThreads, 0, s>>>(
        qp, dbp, scales, nq, n, d, blocks, out);
  } else {
    finemax_kernel<M, 8><<<dim3((unsigned)((nq + 127) / 128), gy), kThreads, 0, s>>>(
        qp, dbp, scales, nq, n, d, blocks, out);
  }
  return (int)cudaGetLastError();
}

template <int M>
int launch_fused_topk(const void* q, const void* db, long long nq, long long n,
                      int d, int k, float* vals, long long* idxs,
                      cudaStream_t s) {
  using Q = typename Traits<M>::Q;
  using R = typename Traits<M>::R;
  const long long slabs = (n + kSlab - 1) / kSlab;
  const dim3 grid((unsigned)((nq + kQueryGroups - 1) / kQueryGroups), grid_y(slabs));
  fused_topk_kernel<M><<<grid, kThreads, 0, s>>>(
      static_cast<const Q*>(q), static_cast<const R*>(db), nq, n, d, k, slabs,
      vals, idxs);
  return (int)cudaGetLastError();
}

template <int M>
int launch_gather_scores(const void* q, const void* db, const long long* bids,
                         long long nq, long long n, int d, long long kf,
                         float* out, cudaStream_t s) {
  using Q = typename Traits<M>::Q;
  using R = typename Traits<M>::R;
  constexpr int kBlocks = kGatherThreads / kRowsPerBlock;
  const dim3 grid((unsigned)nq, (unsigned)((kf + kBlocks - 1) / kBlocks));
  gather_scores_kernel<M><<<grid, kGatherThreads, 0, s>>>(
      static_cast<const Q*>(q), static_cast<const R*>(db), bids, nq, n, d, kf, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns the
// launch error (cudaSuccess == 0). Arguments are checked by the Python
// wrappers (dirjax_torch/ops/topk.py); these reject only what would
// mis-launch.

// K2: vals/idxs are (nq, ceil(n / 512) * k). Modes 0 and 1 only.
extern "C" int dirjax_fused_topk(const void* q, const void* db, int mode,
                                 long long nq, long long n, int d, int k,
                                 float* vals, long long* idxs, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: return launch_fused_topk<kF32>(q, db, nq, n, d, k, vals, idxs, s);
    case kBF16: return launch_fused_topk<kBF16>(q, db, nq, n, d, k, vals, idxs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3: out is (nq, blocks), blocks >= ceil(n / 8); scales is (n,) fp32 or null.
extern "C" int dirjax_finemax(const void* q, const void* db, const float* scales,
                              int mode, long long nq, long long n, int d,
                              long long blocks, float* out, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || blocks * kRowsPerBlock < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: return launch_finemax<kF32>(q, db, scales, nq, n, d, blocks, out, s);
    case kBF16: return launch_finemax<kBF16>(q, db, scales, nq, n, d, blocks, out, s);
    case kI8BF16: return launch_finemax<kI8BF16>(q, db, scales, nq, n, d, blocks, out, s);
    case kI8I8: return launch_finemax<kI8I8>(q, db, scales, nq, n, d, blocks, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4: bids is (nq, kf) int64, out is (nq, kf * 8) fp32.
extern "C" int dirjax_gather_scores(const void* q, const void* db,
                                    const long long* bids, int mode,
                                    long long nq, long long n, int d,
                                    long long kf, float* out, void* stream) {
  if (nq <= 0 || n <= 0 || d <= 0 || kf <= 0 ||
      (kf + kGatherThreads / kRowsPerBlock - 1) / (kGatherThreads / kRowsPerBlock) > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: return launch_gather_scores<kF32>(q, db, bids, nq, n, d, kf, out, s);
    case kBF16: return launch_gather_scores<kBF16>(q, db, bids, nq, n, d, kf, out, s);
    case kI8BF16: return launch_gather_scores<kI8BF16>(q, db, bids, nq, n, d, kf, out, s);
    case kI8I8: return launch_gather_scores<kI8I8>(q, db, bids, nq, n, d, kf, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

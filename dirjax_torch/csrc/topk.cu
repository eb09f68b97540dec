// Top-k scoring kernels for Hopper (sm_90a): the dense serving path's K2, K3
// and K4.
//
// Replaces the TPU kernels of dirjax/ops/topk_pallas.py:
//   K2 dirjax_fused_topk    <- _kernel (launched by _fused): per database slab
//      of 512 rows, scores against a group of queries, then the top-k with
//      ties to the lower index. Writes (nq, slabs*k) values and int64
//      indices, -inf/-1 where a slab has fewer than k live rows.
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
//   int8 value and every product are exact), 3 int8 x int8 (exact int32
//   accumulation, then one round to fp32).
//
// What bounds them. At the serving shape (n = 1M rows of D = 2048, nq = 256)
// K2 and K3 read the rows once (4.3 GB bf16, >= 1.3 ms at 3.35 TB/s; int8
// half that; fp32 8.6 GB, 2.6 ms) against 5.5e11 multiply-adds (1.1 ms of
// bf16 tensor-core peak, 0.56 ms int8, 4.4 ms for the four bf16 products
// of fp32): near the ridge, so both the stream and the contraction must
// run at rate. At nq <= 16 they are bound by the bytes alone. K4 is bound
// by the reads of its candidate rows (nq * kf * 8 rows). Within this
// design, at large nq each stage re-stages its queries from L2 beside the
// rows (48 KB per 128 x 256 x 64 step), so L2 -> SM traffic rather than HBM
// or the tensor cores sets K3's pace in bf16; K2 takes at most 64 queries a
// unit (the slab's scores live in shared memory), so at nq = 256 four query
// groups stream every slab from L2, and its k selection rounds add to that.
//
// The design (score_tiles and mma_issue in tc_score.cuh, one routine for
// every mode and all three kernels, which binary.cu's K5 shares):
//   - Tensor cores: wgmma (wgmma.cuh) m64nNk16 bf16 -> fp32 (modes 0-2)
//     and m64nNk32 s8 -> s32 (mode 3). Database rows are the M side (two
//     warpgroups of 64 rows make a 128-row tile), queries the N side
//     (N = 8 ... 256 by nq), so both are K-major as stored. Modes 1 and 3
//     read both operands from shared memory. Mode 2 copies the int8 rows
//     at half the bytes and widens them to bf16 in registers (exact:
//     |v| <= 127) as the A operand of the same bf16 wgmma, with B still
//     from shared memory.
//   - Mode 0 (fp32) splits both operands in two bf16 parts, x = hi + lo + r
//     with hi = bf16(x) and lo = bf16(x - hi), both rounded to nearest
//     (|r| <= 2^-17 |x|). Each warp loads its 16 rows' fp32 values from the
//     stage (16 bytes a thread, in a layout of their own that no load phase
//     meets twice in a bank) and splits them in registers (A), one k16 step
//     while the wgmmas of the step before run; the queries come split by
//     the wrapper, 32 hi and then 32 lo bf16 in each 128-byte query slice
//     (B). Every k16 step issues hi.hi, hi.lo, lo.hi and lo.lo, in that
//     order: each product is exact, and the sum misses a.b by the residuals
//     alone (< 1e-6 for unit rows at D = 2048, as tests/test_torch_topk.py
//     models it; dropping lo.lo would not do: its terms all have one sign in
//     a self-match). The products of each 64 d start from 0 and are added
//     into the running score with one rounded fp32 add (score_tiles), since
//     the tensor cores' accumulation drifts with the size of what it adds
//     onto; that second set of sums caps N at 128. A stage holds 64 d (two
//     fp32 slices of each row and two query slices), or 32 d where three
//     such stages would not fit (K2 at N = 64, beside its slab scores).
//   - Staging: a ring of up to 4 shared-memory stages, each one or two
//     128-byte slices of every row of the tile and of its queries, fed by
//     cp.async (16 bytes a thread; 8 or 4 with zero-fill where a row's
//     bytes are not 16-byte aligned, e.g. int8 at D = 200; plain loads below
//     4) and laid out in the 128-byte swizzle (16-byte chunk c of row r at
//     c ^ (r % 8)) that wgmma reads without bank conflicts. The copies of
//     the next stages are in flight while a stage multiplies. Rows >= n,
//     queries >= nq and d >= D are zero-filled by the copy itself; the
//     database is never padded.
//   - Grid: persistent CTAs (as many as fit on the SMs) walk work units
//     (row tile, query group) with the query group fastest, so the groups
//     of one row tile run side by side and HBM delivers each row once (at
//     nq <= 256 in modes 1 and 3 there is one group); the ring runs across
//     unit boundaries. A unit takes the smallest N that holds nq, so small
//     nq does no wasted tensor work and streams with its small stages.
//   - K3: a fine block is 8 rows of one accumulator fragment, so its
//     maximum is three shuffles; the optional scale is one __fmul_rn after
//     the dot. K2: a unit is a 512-row slab (4 tiles, N <= 64); each tile's
//     scores go to shared memory, then one warp per query keeps its 16
//     scores in registers and takes k rounds of a warp argmax over the
//     lanes' cached maxima (only the lane that lost its maximum rescans),
//     with no barrier between rounds; its ring gets what shared memory the
//     scores leave. K4: a unit is one query's
//     16 candidate blocks (128 gathered rows) against that query alone, at
//     its column q % N of the N that K3 takes at the same nq.
//
// Containment (topk_pallas.py:24-29) needs K4's rescored rows to reproduce
// K3's maxima bit for bit. Both score a (row, query) pair through
// mma_issue: the same wgmma instructions and shape (K4 picks N by K3's
// rule, by_query_width, and puts the query in K3's column), fed the same
// operand values (in mode 0 the same split), over d in the same 16- (or
// 32-) wide steps into one fp32 (or int32) accumulator that starts at 0
// (in mode 0 one for each 64 d, summed alike: both keep no shared memory
// beside the ring, so their stages match), zero-padded alike past D. K3 applies the int8 row scale after the dot as
// one fp32 multiply, which is what the caller's finish step does to K4's
// raw scores.

#include "tc_score.cuh"

namespace {

constexpr int kSlab = 512;                               // K2 rows per slab

// K2: a unit is (512-row slab, query group), the group fastest; its 4 tiles
// leave their scores in shared memory, then each warp selects for every 8th
// query of the group.
template <int BN>
struct FusedTopkWork {
  static constexpr int kTiles = kSlab / kTcRows;
  static constexpr int kLd = kSlab + 1;   // scores row stride, in floats
  static constexpr int kSharedBytes = BN * kLd * (int)sizeof(float);
  Operands ops;
  long long slabs, qgroups, units;
  int k;
  float* vals;
  long long* idxs;
  float* scores;   // shared: [BN][kLd]

  __device__ __forceinline__ void bind_shared(char* p) { scores = reinterpret_cast<float*>(p); }

  __device__ __forceinline__ const char* row(long long unit, int tile, int r) const {
    const long long i = unit / qgroups * kSlab + tile * kTcRows + r;
    return i < ops.n ? ops.db + i * ops.row_bytes : nullptr;
  }
  __device__ __forceinline__ const char* query(long long unit, int c) const {
    const long long i = unit % qgroups * BN + c;
    return i < ops.nq ? ops.q + i * ops.q_bytes : nullptr;
  }
  template <class C>
  __device__ __forceinline__ void epilogue(long long unit, int tile,
                                           typename C::Acc (&acc)[C::NT * 4], int warp,
                                           int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const long long slab = unit / qgroups;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = tile * kTcRows + warp * 16 + half * 8 + g;
      const bool live = slab * kSlab + c < ops.n;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          scores[(nt * 8 + 2 * t + e) * kLd + c] =
              live ? score_of(acc[nt * 4 + 2 * half + e]) : -INFINITY;
    }
    if (tile != kTiles - 1) return;
    __syncthreads();
    constexpr int kWarps = kTcThreads / 32;
    for (int ql = threadIdx.x >> 5; ql < BN; ql += kWarps * kPair) {
      int pair[kPair];
#pragma unroll
      for (int i = 0; i < kPair; ++i) pair[i] = ql + i * kWarps;
      select(unit, pair, lane);
    }
    __syncthreads();   // the next slab's scores overwrite these
  }

  // Top-k of 512 scores per query, ties to the lower row, for kPair queries
  // at once (their shuffle chains interleave): lane l holds rows l + 32j
  // and a mask of those already taken (the scores themselves are never
  // written, so they stay in registers); each round the lanes' cached
  // maxima meet in a warp argmax, and only the lane that gave up its
  // maximum rescans. Result r is kept by lane r % 32 and written 32 at a
  // time.
  static constexpr int kPair = 2;
  static constexpr int kPer = kSlab / 32;   // scores a lane holds

  __device__ __forceinline__ static void rescan(const float (&v)[kPer], unsigned taken,
                                                int lane, float& best, int& arg) {
    best = -INFINITY;
    arg = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kPer; ++j)   // increasing j: ties keep the first
      if (!(taken >> j & 1u) && v[j] > best) { best = v[j]; arg = lane + 32 * j; }
  }

  // the queries of this group at positions ql[i] < BN
  __device__ __forceinline__ void select(long long unit, const int (&ql)[kPair],
                                         int lane) const {
    const long long slab = unit / qgroups;
    float v[kPair][kPer], mine[kPair], keep_v[kPair];
    int mine_at[kPair], end[kPair];
    unsigned taken[kPair];
    long long keep_i[kPair], out0[kPair];
    bool live[kPair];
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      const long long qi = unit % qgroups * BN + ql[i];
      live[i] = ql[i] < BN && qi < ops.nq;
      out0[i] = (qi * slabs + slab) * k;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        v[i][j] = live[i] ? scores[ql[i] * kLd + lane + 32 * j] : -INFINITY;
      taken[i] = 0u;
      rescan(v[i], 0u, lane, mine[i], mine_at[i]);
      keep_v[i] = -INFINITY;
      keep_i[i] = -1;
      end[i] = live[i] ? k : 0;
    }
    for (int r = 0; r < k; ++r) {
      float best[kPair];
      int arg[kPair];
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        best[i] = live[i] ? mine[i] : -INFINITY;
        arg[i] = mine_at[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < kPair; ++i) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
          const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
          if (ob > best[i] || (ob == best[i] && oa < arg[i])) { best[i] = ob; arg[i] = oa; }
        }
      bool any = false;
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        if (!live[i]) continue;
        if (!(best[i] > -INFINITY)) {   // the slab has no live row left
          live[i] = false;
          end[i] = r;
          continue;
        }
        any = true;
        if (lane == (r & 31)) { keep_v[i] = best[i]; keep_i[i] = slab * kSlab + arg[i]; }
        if ((r & 31) == 31) {
          vals[out0[i] + r - 31 + lane] = keep_v[i];
          idxs[out0[i] + r - 31 + lane] = keep_i[i];
        }
        if (lane == (arg[i] & 31)) {   // take the winner, rescan this lane
          taken[i] |= 1u << (arg[i] >> 5);
          rescan(v[i], taken[i], lane, mine[i], mine_at[i]);
        }
      }
      if (!any) break;
    }
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      if (!(ql[i] < BN && unit % qgroups * BN + ql[i] < ops.nq)) continue;
      const int base = end[i] & ~31;   // results [base, end) are still with the lanes
      if (lane < end[i] - base) {
        vals[out0[i] + base + lane] = keep_v[i];
        idxs[out0[i] + base + lane] = keep_i[i];
      }
      for (int r = end[i] + lane; r < k; r += 32) {
        vals[out0[i] + r] = -INFINITY;
        idxs[out0[i] + r] = -1;
      }
    }
  }
};

constexpr int kMaxFusedQueryWidth = 64;

template <int M, int BN>
int launch_fused_topk_tc(const Operands& o, int k, float* vals, long long* idxs,
                         cudaStream_t s) {
  FusedTopkWork<BN> w;
  w.ops = o;
  w.slabs = (o.n + kSlab - 1) / kSlab;
  w.qgroups = (o.nq + BN - 1) / BN;
  w.units = w.slabs * w.qgroups;
  w.k = k;
  w.vals = vals;
  w.idxs = idxs;
  w.scores = nullptr;   // bound by the kernel
  return launch_tc<M, BN>(w, s);
}

template <int M>
int launch_fused_topk(const void* q, const void* db, long long nq, long long n,
                      int d, int k, float* vals, long long* idxs,
                      cudaStream_t s) {
  const Operands o = operands<M>(q, db, nq, n, d);
  return by_query_width<kMaxFusedQueryWidth>(nq, [&](auto bn) {
    return launch_fused_topk_tc<M, decltype(bn)::value>(o, k, vals, idxs, s);
  });
}

}  // namespace

// Each entry point launches on `stream`, does not synchronise, and returns the
// launch error (cudaSuccess == 0). Arguments are checked by the Python
// wrappers (dirjax_torch/ops/topk.py); these reject only what would
// mis-launch. In mode 0, `db` is (n, d) fp32 and `q` the split queries,
// (nq, d32 / 32, 2, 32) bf16 with d32 = d rounded up to 32 (zeros past d):
// for each 32 d the hi parts bf16(q), then the lo parts bf16(q - hi), each
// 16 d in the order [0 1 4 5 8 9 12 13 2 3 6 7 10 11 14 15] (mma_issue).

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
  if (nq <= 0 || n <= 0 || d <= 0 || kf <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32: return launch_gather_scores<kF32>(q, db, bids, nq, n, d, kf, out, s);
    case kBF16: return launch_gather_scores<kBF16>(q, db, bids, nq, n, d, kf, out, s);
    case kI8BF16: return launch_gather_scores<kI8BF16>(q, db, bids, nq, n, d, kf, out, s);
    case kI8I8: return launch_gather_scores<kI8I8>(q, db, bids, nq, n, d, kf, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
//      yields NaN, a row >= n inside a valid block -inf (as in K6).
//
// Containment (topk_pallas.py:24-29) needs the rescore to reproduce K6's
// maxima bit for bit. Both score a (row, query) pair through the one routine
// `adc_mac`: one fp32 accumulator, from 0, fed __fadd_rn(acc, LUT value) for
// j = 0, 1, ... in increasing order. bf16 tables are widened to fp32 (exact)
// when they are staged, so both kernels add the same fp32 values in the same
// order; the plain versions in dirjax_torch/ops/pq.py do too.
//
// What bounds K6: at the serving shape (1,048,576 rows, m = 32, ksub = 16,
// nq = 256) it reads 33.5 MB of codes and 0.5 MB of tables (0.01 ms at
// 3.35 TB/s) and does 8.6e9 table lookups and adds. The TPU kernel turned the
// lookups into a one-hot x LUT contraction (2 * nq * n * m * ksub =
// 2.75e11 bf16 operations, 0.28 ms on the tensor cores); this first design
// keeps the lookups: a CTA stages the tables of a group of QG queries in
// shared memory (as fp32) and each thread owns one row of a 256-row pass,
// so a warp's 32 lookups for one (query, subspace) hit one table row:
// conflict-free at ksub = 16 (16 words in 16 banks), about 3-4-way at
// ksub = 256 (bank conflicts of random lookups; later work). At 32 lookups
// per SM per clock the lookups alone take >= 1.2 ms. Where the tables of QG
// queries do not fit kLutBudget (ksub = 256 with large m), they are staged
// one subspace group at a time, so every (m, ksub) with ksub <= 256 runs here.
// The one-hot tensor-core form and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // rows per pass, one per thread
constexpr int kCodeStride = kThreads + 4;   // staged bytes per subspace (pad: no bank conflicts)
constexpr int kLutBudget = 64 * 1024;       // bytes of fp32 tables staged at once
constexpr int kMaxJg = 128;                 // subspaces staged at once (bounds the code tile)
constexpr int kTargetCtas = 1024;           // K6: CTAs in flight, over all query groups
constexpr int kGatherRowsPerCta = 4 * kThreads;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The one (row, query) step that K6 and the rescore share: add the table
// entry of this subspace's code, rounded once.
__device__ __forceinline__ void adc_mac(float& acc, const float* lut_j, int code) {
  acc = __fadd_rn(acc, lut_j[code]);
}

// Stage the tables of queries q0 .. q0+qg-1, subspaces j0 .. j0+jn-1 into
// lut_s[(q * jg + jj) * ksub + c] as fp32 (0 past nq).
template <typename LutT>
__device__ void stage_luts(float* lut_s, const LutT* __restrict__ luts, long long q0, int qg,
                           long long nq, int m, int ksub, int jg, int j0, int jn) {
  const int span = jn * ksub;
  for (int e = threadIdx.x; e < qg * span; e += kThreads) {
    const int q = e / span, rem = e % span;
    const long long qi = q0 + q;
    lut_s[q * jg * ksub + rem] =
        qi < nq ? widen(luts[(qi * m + j0) * ksub + rem]) : 0.0f;
  }
}

// Stage codes[rows[rl], j0 .. j0+jn-1] into codes_s[jj * kCodeStride + rl]
// for the kThreads rows of a pass; a row < 0 stages zeros.
__device__ void stage_codes(uint8_t* codes_s, const uint8_t* __restrict__ codes,
                            const long long* row_s, int m, int j0, int jn) {
  for (int e = threadIdx.x; e < kThreads * jn; e += kThreads) {
    const int rl = e / jn, jj = e % jn;
    const long long row = row_s[rl];
    codes_s[jj * kCodeStride + rl] = row >= 0 ? codes[row * m + j0 + jj] : 0;
  }
}

// K6. Grid (CTAs over row ranges, CTAs over query groups of QG); both walk
// grid-stride, so any nq and n launch. A range is bpc whole fine blocks
// (bpc * block rows); the CTA walks them in passes of kThreads rows, thread t
// owning row p0 + t against the QG queries of its group, and folds each
// pass's scores into the range's maxima in shared memory.
template <typename LutT, int QG>
__global__ void __launch_bounds__(kThreads)
adc_finemax_kernel(const LutT* __restrict__ luts, const uint8_t* __restrict__ codes,
                   long long nq, long long n, int m, int ksub, int jg, long long block,
                   long long bpc, long long blocks, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);                       // QG * jg * ksub
  float* sc = lut_s + QG * jg * ksub;                                  // QG * kThreads
  float* fmax_s = sc + QG * kThreads;                                  // QG * bpc
  long long* row_s = reinterpret_cast<long long*>(                     // kThreads
      lut_s + ((QG * (jg * ksub + kThreads + bpc) + 1) & ~1LL));
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(row_s + kThreads);    // jg * kCodeStride
  const int t = threadIdx.x;
  const long long groups = (nq + QG - 1) / QG;
  const long long ranges = (blocks + bpc - 1) / bpc;
  const bool resident = jg >= m;   // every table of the group fits: stage once per group
  for (long long qgi = blockIdx.y; qgi < groups; qgi += gridDim.y) {
    const long long q0 = qgi * QG;
    bool staged = false;
    for (long long rg = blockIdx.x; rg < ranges; rg += gridDim.x) {
      const long long b0 = rg * bpc;
      const long long nb = min(bpc, blocks - b0);
      const long long base = b0 * block;
      const long long end = base + nb * block;
      for (long long e = t; e < QG * nb; e += kThreads) fmax_s[(e / nb) * bpc + e % nb] = -INFINITY;
      for (long long p0 = base; p0 < end; p0 += kThreads) {
        const long long row = p0 + t;
        const bool live = row < end && row < n;
        float acc[QG];
#pragma unroll
        for (int q = 0; q < QG; ++q) acc[q] = 0.0f;
        for (int j0 = 0; j0 < m; j0 += jg) {
          const int jn = min(jg, m - j0);
          __syncthreads();   // the previous readers of the staged tiles are done
          row_s[t] = live ? row : -1;
          if (!(resident && staged)) stage_luts(lut_s, luts, q0, QG, nq, m, ksub, jg, j0, jn);
          __syncthreads();
          stage_codes(codes_s, codes, row_s, m, j0, jn);
          __syncthreads();
          staged = true;
          for (int jj = 0; jj < jn; ++jj) {
            const int c = codes_s[jj * kCodeStride + t];
#pragma unroll
            for (int q = 0; q < QG; ++q) adc_mac(acc[q], lut_s + (q * jg + jj) * ksub, c);
          }
        }
#pragma unroll
        for (int q = 0; q < QG; ++q) sc[q * kThreads + t] = live ? acc[q] : -INFINITY;
        __syncthreads();
        // fold this pass into the maxima of the blocks it touches; each
        // (query, block) pair has one owner per pass
        const long long stop = min(p0 + kThreads, end);
        const long long lb0 = (p0 - base) / block;
        const long long nlb = (stop - 1 - base) / block - lb0 + 1;
        for (long long e = t; e < QG * nlb; e += kThreads) {
          const int q = (int)(e / nlb);
          const long long lb = lb0 + e % nlb;
          const long long lo = max(p0, base + lb * block);
          const long long hi = min(stop, base + (lb + 1) * block);
          float mx = fmax_s[q * bpc + lb];
          for (long long r = lo; r < hi; ++r) mx = fmaxf(mx, sc[q * kThreads + (r - p0)]);
          fmax_s[q * bpc + lb] = mx;
        }
      }
      __syncthreads();
      for (long long e = t; e < QG * nb; e += kThreads) {
        const long long q = e / nb, lb = e % nb;
        if (q0 + q < nq) out[(q0 + q) * blocks + b0 + lb] = fmax_s[q * bpc + lb];
      }
      __syncthreads();
    }
  }
}

// The rescore. Grid (nq, ceil(kf * block / kGatherRowsPerCta)); the CTA
// stages its query's tables and scores its share of the query's candidate
// rows in passes of kThreads, one row per thread.
template <typename LutT>
__global__ void __launch_bounds__(kThreads)
adc_gather_scores_kernel(const LutT* __restrict__ luts, const uint8_t* __restrict__ codes,
                         const long long* __restrict__ bids, long long nq, long long n, int m,
                         int ksub, int jg, long long block, long long kf,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);                       // jg * ksub
  long long* row_s = reinterpret_cast<long long*>(lut_s + ((jg * ksub + 1) & ~1));
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(row_s + kThreads);    // jg * kCodeStride
  const int t = threadIdx.x;
  const long long qi = blockIdx.x;
  const long long total = kf * block;
  const long long c_end = min(total, ((long long)blockIdx.y + 1) * kGatherRowsPerCta);
  const long long db_blocks = (n + block - 1) / block;
  const bool resident = jg >= m;
  bool staged = false;
  for (long long p0 = (long long)blockIdx.y * kGatherRowsPerCta; p0 < c_end; p0 += kThreads) {
    const long long ci = p0 + t;
    long long row = -2;   // -2: no candidate (past c_end or an invalid block id)
    if (ci < c_end) {
      const long long b = bids[qi * kf + ci / block];
      if (b >= 0 && b < db_blocks) row = b * block + ci % block;
    }
    float acc = 0.0f;
    for (int j0 = 0; j0 < m; j0 += jg) {
      const int jn = min(jg, m - j0);
      __syncthreads();
      row_s[t] = row >= 0 && row < n ? row : -1;
      if (!(resident && staged)) stage_luts(lut_s, luts, qi, 1, nq, m, ksub, jg, j0, jn);
      __syncthreads();
      stage_codes(codes_s, codes, row_s, m, j0, jn);
      __syncthreads();
      staged = true;
      for (int jj = 0; jj < jn; ++jj) adc_mac(acc, lut_s + jj * ksub, codes_s[jj * kCodeStride + t]);
    }
    if (ci < c_end) out[qi * total + ci] = row < 0 ? NAN : (row < n ? acc : -INFINITY);
  }
}

// Queries per CTA and subspaces staged at once: QG the smallest power of two
// >= nq up to 16, halved until its tables fit kLutBudget; jg what then fits.
void geometry(long long nq, int m, int ksub, int* qg, int* jg) {
  int g = 1;
  while (g < 16 && g < nq) g *= 2;
  while (g > 1 && (long long)g * m * ksub * 4 > kLutBudget) g /= 2;
  int j = kLutBudget / (g * ksub * 4);
  j = j < m ? j : m;
  *qg = g;
  *jg = j < kMaxJg ? j : kMaxJg;
}

template <typename LutT, int QG>
int launch_finemax(const LutT* luts, const uint8_t* codes, long long nq, long long n, int m,
                   int ksub, int jg, long long block, long long blocks, float* out,
                   cudaStream_t s) {
  const long long bpc = block >= kThreads ? 1 : kThreads / block;
  const size_t smem = sizeof(float) * ((QG * (jg * ksub + kThreads + bpc) + 1) & ~1LL) +
                      sizeof(long long) * kThreads + (size_t)jg * kCodeStride;
  auto kernel = adc_finemax_kernel<LutT, QG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long gy = (nq + QG - 1) / QG;   // past kMaxGridY, CTAs walk the groups
  gy = gy < kMaxGridY ? gy : kMaxGridY;
  const long long ranges = (blocks + bpc - 1) / bpc;
  long long gx = (kTargetCtas + gy - 1) / gy;
  gx = gx < ranges ? gx : ranges;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem, s>>>(
      luts, codes, nq, n, m, ksub, jg, block, bpc, blocks, out);
  return (int)cudaGetLastError();
}

template <typename LutT>
int finemax_dispatch(const void* luts, const uint8_t* codes, long long nq, long long n, int m,
                     int ksub, long long block, long long blocks, float* out, cudaStream_t s) {
  int qg, jg;
  geometry(nq, m, ksub, &qg, &jg);
  const LutT* l = static_cast<const LutT*>(luts);
  switch (qg) {
    case 16: return launch_finemax<LutT, 16>(l, codes, nq, n, m, ksub, jg, block, blocks, out, s);
    case 8: return launch_finemax<LutT, 8>(l, codes, nq, n, m, ksub, jg, block, blocks, out, s);
    case 4: return launch_finemax<LutT, 4>(l, codes, nq, n, m, ksub, jg, block, blocks, out, s);
    case 2: return launch_finemax<LutT, 2>(l, codes, nq, n, m, ksub, jg, block, blocks, out, s);
    default: return launch_finemax<LutT, 1>(l, codes, nq, n, m, ksub, jg, block, blocks, out, s);
  }
}

template <typename LutT>
int gather_dispatch(const void* luts, const uint8_t* codes, const long long* bids, long long nq,
                    long long n, int m, int ksub, long long block, long long kf, float* out,
                    cudaStream_t s) {
  int qg, jg;
  geometry(1, m, ksub, &qg, &jg);
  const size_t smem = sizeof(float) * (size_t)((jg * ksub + 1) & ~1) +
                      sizeof(long long) * kThreads + (size_t)jg * kCodeStride;
  auto kernel = adc_gather_scores_kernel<LutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long gy = (kf * block + kGatherRowsPerCta - 1) / kGatherRowsPerCta;
  if (gy > kMaxGridY || nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)nq, (unsigned)gy), kThreads, smem, s>>>(
      static_cast<const LutT*>(luts), codes, bids, nq, n, m, ksub, jg, block, kf, out);
  return (int)cudaGetLastError();
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
  return lut_bf16 ? finemax_dispatch<__nv_bfloat16>(luts, c, nq, n, m, ksub, block, blocks, out, s)
                  : finemax_dispatch<float>(luts, c, nq, n, m, ksub, block, blocks, out, s);
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
             ? gather_dispatch<__nv_bfloat16>(luts, c, bids, nq, n, m, ksub, block, kf, out, s)
             : gather_dispatch<float>(luts, c, bids, nq, n, m, ksub, block, kf, out, s);
}

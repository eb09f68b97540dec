// Binary-code scoring kernels for Hopper (sm_90a): K5 of the binary serving
// path and its asymmetric rescore, on the tensor-core routine of the dense
// top-k kernels (tc_score.cuh, modes 4 and 5).
//
// Replaces the TPU kernel of dirjax/ops/binary.py:
//   K5 dirjax_bits_finemax <- _bits_finemax_kernel (binary.py:357, launched by
//      _bits_finemax_call): streams the packed codes (n rows of n_bits sign
//      bits, LSB first: bit b of byte B is dimension 8B + b) once and writes
//      only the maximum score over each 8 consecutive rows (a fine block),
//      query-major (nq, blocks); rows >= n score -inf. Two scores:
//        symmetric  (asym = 0): int8 +-1 queries (the wrapper unpacks the
//          packed query codes once), the +-1 dot n_bits - 2 * hamming in
//          exact int32 sums;
//        asymmetric (asym = 1): bf16 projected queries against the +-1 code,
//          fp32 sums.
//   dirjax_bits_gather_scores, the asymmetric rescore: the counterpart of
//      dirjax's XLA _bits_finish_asym (binary.py:513), not of a TPU kernel.
//      Per query, it rescores the 8 rows of each candidate fine block named
//      by `bids` -> (nq, kf*8); NaN for a block not wholly inside the codes.
//
// As the TPU kernel does, both unpack the codes to +-1 and contract them on
// the matrix unit: K5 is K3's tensor-core routine (persistent CTAs walking
// 128-row tiles x query groups of N = 8 ... 256, a cp.async ring, the
// fine-block maxima epilogue) with rows of packed bits. A stage holds one
// slice of 128 d, or four (512 d) at N <= 16: 16 bytes of each row and the
// queries' 128 d a slice. Each warp unpacks its 16 rows' bits slice by slice
// into +-1 A fragments in registers (bf16 pairs, or int8 quads), and the
// wgmma takes the queries from shared memory (m64nNk16 bf16 -> fp32 with
// N <= 128, or m64nNk32 s8 -> s32 with N <= 256).
//
// What bounds K5: at the serving shape (1,048,576 rows x 2048 bits, nq = 256)
// it reads 268 MB of codes (0.08 ms at 3.35 TB/s) against 5.5e11 +-1
// products: 0.56 ms on the int8 tensor cores (symmetric), 1.1 ms on the bf16
// ones (asymmetric). Within this design each 128-row tile restages its
// queries from L2 (nq * n_bits * 2 bytes asymmetric: as K3 bf16 does, 8.6 GB
// in all at nq = 256), which sets the pace at large nq. At small nq each
// wgmma with A from registers costs the SM about 70 cycles whatever N and k
// (measured on the H100: 0.54 ms asymmetric, 0.31 ms symmetric at nq = 1,
// one such wgmma per 2 KB of unpacked A); four accumulator chains a
// warpgroup, and an unpack into a swizzled shared-memory A for the wgmma to
// read, did not beat it. The rescore is bound by its candidate rows
// (nq * kf * 8 rows of n_bits / 8 bytes).

// Containment (topk_pallas.py:24-29) needs the rescore to reproduce K5's
// asymmetric maxima bit for bit. Both score through mma_issue in mode 4: the
// same wgmma shape and stage (the rescore takes K5's N at the same nq and
// puts its query in K5's column), the same unpacked operands, the same 16-d
// steps into an accumulator that starts at 0 each stage, the same fp32 add
// of each stage's sum into the score, zero-filled alike past n_bits.

#include "tc_score.cuh"

// Each entry point launches on `stream`, does not synchronise, and returns the
// launch error (cudaSuccess == 0). Arguments are checked by the Python
// wrappers (dirjax_torch/ops/binary.py); these reject only what would
// mis-launch.

// K5: q is (nq, 32 * words) int8 +-1 (asym = 0) or bf16 (asym = 1); db is
// (n, words) uint32 codes; out is (nq, blocks), blocks >= ceil(n / 8).
extern "C" int dirjax_bits_finemax(const void* q, const void* db, int asym,
                                   long long nq, long long n, int words,
                                   long long blocks, float* out, void* stream) {
  if (nq <= 0 || n <= 0 || words <= 0 || blocks * kRowsPerBlock < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bits = 32 * words;
  return asym ? launch_finemax<kBitsBF16>(q, db, nullptr, nq, n, bits, blocks, out, s)
              : launch_finemax<kBitsI8>(q, db, nullptr, nq, n, bits, blocks, out, s);
}

// The rescore: q is (nq, 32 * words) bf16, bids (nq, kf) int64, out
// (nq, kf * 8) fp32.
extern "C" int dirjax_bits_gather_scores(const void* q, const void* db,
                                         const long long* bids, long long nq,
                                         long long n, int words, long long kf,
                                         float* out, void* stream) {
  if (nq <= 0 || n <= 0 || words <= 0 || kf <= 0) return (int)cudaErrorInvalidValue;
  return launch_gather_scores<kBitsBF16>(q, db, bids, nq, n, 32 * words, kf, out,
                                         static_cast<cudaStream_t>(stream));
}

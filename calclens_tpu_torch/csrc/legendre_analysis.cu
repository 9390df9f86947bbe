// Legendre analysis of the spherical-harmonic transform (map -> alm), f32.
//
// Replaces the Pallas TPU kernel calclens_tpu/sht/pallas_legendre.py::
// _analysis_kernel (wrappers _analysis_alm, analysis_pallas).  It computes
//
//   alm[l, m] = sum_j lambda_lm(theta_j) * S_{l mod 2}[m, j]
//
// over the northern ring pairs j, where S0 = (m even ? E : O) and
// S1 = (m even ? O : E) are the quadrature-folded even/odd ring-pair sums,
// i.e. E for even l - m and O for odd l - m.  lambda_lm comes from the
// scaled three-term recurrence in l: the diagonal seed lambda_mm is taken
// directly in log2 space (stored value in [2^-32, 2^32) times 2^(64 k)),
// and a per-element scale counter k rescales by 2^-64 whenever |p| > 2^32;
// lambda = p for k == 0, p * 2^-64 for k == -1 and 0 below (the
// reference's plmgen rescaling and lmin cutoff).  A tile whose cutoff mcut
// (transforms.m_cutoff on the tile's largest sin theta) lies at or below m
// contributes nothing to the row and is skipped.
//
// What bounds it on the H100: instruction issue.  The inputs (E, O) are
// read once and alm is written once; per (l, m, j) element the function
// needs the recurrence's 4 operations, rounded one by one as the twin
// rounds them (no FMA), and 2 FMAs (re, im): 6 issue slots.  The sum runs
// over j, across threads, so a cross-thread reduction comes on top.
// Design: a block is one m row and walks that row's 512-ring tiles in
// order; each of its 128 threads carries the recurrence of 4 rings of the
// tile (one warp: 128 consecutive rings) in registers and sums their
// products locally.
//  - The seed row l == m is peeled off the loop; a warp then runs its
//    degrees in groups of 16, each in one of three modes chosen by a vote
//    after the previous group (legendre_common.cuh's analysis_sweep, which
//    K4 shares; this file supplies the partial sums): the recurrence alone
//    while every ring's lambda is 0 (scale k <= -2), then the careful
//    recurrence (rescale test, scale factor), then, once all its rings are
//    at k == 0, the bare 4-operation recurrence.  All three give the
//    twin's bits.
//  - Degrees are unrolled by 2, so E (even l - m) or O (odd) is chosen at
//    compile time; the last chunk is padded with zero degrees.
//  - The cross-thread sum is taken once per 16 degrees, not per degree:
//    each thread stores its (re, im) partial of every degree in shared
//    memory (rows padded so that both the stores and the float4 reads of
//    the sum are free of bank conflicts), then 8 threads per degree sum the
//    degree's 128 partials and 3 shuffles combine them.  The partials are
//    double-buffered: one barrier per 16 degrees.
//  - The 512-ring tiles of a degree are combined in a fixed order: tile
//    by tile, the block's thread that sums a degree adds that tile's sum
//    to the degree's alm element (a load, an add, a store: no other block
//    touches the row, and the same thread holds the element in every
//    tile).  So alm is the same bits on every run, and a row's bits depend
//    only on that row's inputs, not on the launch's m0 or nm; the TPU
//    kernel's j grid axis adds its tiles in order too.  The rows run
//    longest first (m = m0 first: the most degrees and the most tiles
//    below the cutoff), so the short rows fill the tail of the launch.
//    The combine moves 16 B per (m, l, tile) below the cutoff (alm's re
//    and im read and written).
//  - The recurrence coefficients of 128 degrees are computed once per tile
//    into shared memory instead of two square roots per degree in every
//    thread.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::diag_seed;
using calclens::Rings;

constexpr int kThreads = 128;                       // threads per block
constexpr int kRings = 4;                           // rings per thread
constexpr int kTileJ = kThreads * kRings;  // 512 rings: the mcut tile
constexpr int kChunkL = kThreads;          // degrees per coefficient chunk
constexpr int kRedL = 16;  // degrees per cross-thread sum and per vote
// floats per degree row of the partials: kThreads (re, im) pairs + 16, so
// the 8 threads that read one row in a quarter-warp hit distinct banks
constexpr int kRedRow = 2 * kThreads + 16;
constexpr int kRowVec = 2 * kThreads / 4;      // float4 of partials per row
constexpr int kSumThreads = kThreads / kRedL;  // threads summing one degree

struct Analysis : Rings<kRings> {
  float er[kRings], ei[kRings], orr[kRings], oi[kRings];

  // P = (l - m) mod 2: the degree's partial (re, im) of this thread's rings
  template <int P>
  __device__ __forceinline__ void emit(float* red, const float (&lam)[kRings],
                                       const float (&)[kRings]) {
    const float(&sr)[kRings] = P ? orr : er;
    const float(&si)[kRings] = P ? oi : ei;
    float pr = lam[0] * sr[0], pim = lam[0] * si[0];
#pragma unroll
    for (int q = 1; q < kRings; ++q) {
      pr += lam[q] * sr[q];
      pim += lam[q] * si[q];
    }
    *reinterpret_cast<float2*>(red) = make_float2(pr, pim);
  }

  __device__ __forceinline__ void emit_zero(float* red) {
    *reinterpret_cast<float2*>(red) = make_float2(0.0f, 0.0f);
  }
};

// kRowOffset: the rows start at m0 > 0 (a rank's block of m rows); without
// it m is blockIdx.x, the one-device code, which ptxas schedules 5 % faster
// than the same sweep with a runtime offset (chip_smoke.py phase 6 and
// tools/legendre_variants.py on an H100)
template <bool kRowOffset>
__global__ void __launch_bounds__(kThreads)
legendre_analysis_kernel(const float* __restrict__ ere,
                         const float* __restrict__ eim,
                         const float* __restrict__ ore,
                         const float* __restrict__ oim,
                         const float* __restrict__ cth,
                         const float* __restrict__ ln_sth,
                         const float* __restrict__ logc,
                         const int* __restrict__ mcut,
                         float* __restrict__ alm_re,  // [nm, nl], zeroed
                         float* __restrict__ alm_im,
                         int nl, int J, int m0) {
  const int mr = blockIdx.x;  // input and output row; m = m0 + mr
  const int m = kRowOffset ? m0 + mr : mr;

  __shared__ __align__(16) float2 coef[kChunkL];  // (a, b) per degree
  __shared__ __align__(16) float red[2][kRedL][kRedRow];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const float mf = static_cast<float>(m);
  const float logc_m = logc[mr];
  float* const row_re = alm_re + static_cast<size_t>(mr) * nl;
  float* const row_im = alm_im + static_cast<size_t>(mr) * nl;

  // the cross-thread sum of one block of kRedL degrees: thread t sums
  // every kSumThreads-th float4 of row t / kSumThreads
  const int sum_row = t / kSumThreads;
  const int sum_col = t % kSumThreads;

  const int ntiles = (J + kTileJ - 1) / kTileJ;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (m >= mcut[jt]) continue;  // whole (m, tile) below f32 significance

    Analysis s;
    float sv[kRings];
    int sk[kRings];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      // warp w holds rings 128 w .. 128 w + 127 of the tile
      const int j = jt * kTileJ + (t >> 5) * (32 * kRings) + q * 32 + lane;
      s.er[q] = s.ei[q] = s.orr[q] = s.oi[q] = 0.0f;
      s.c[q] = 0.0f;
      sv[q] = 0.0f;
      sk[q] = 0;
      if (j < J) {
        const size_t o = static_cast<size_t>(mr) * J + j;
        s.er[q] = ere[o];
        s.ei[q] = eim[o];
        s.orr[q] = ore[o];
        s.oi[q] = oim[o];
        s.c[q] = cth[j];
        diag_seed(logc_m, mf, ln_sth[j], sv[q], sk[q]);
      }
    }

    int buf = 0;
    calclens::analysis_sweep<kRedL, kRedRow>(
        s, coef, m, nl, sv, sk, [&] { return &red[buf][0][2 * t]; },
        [&](int lb, bool) {
          // this thread's alm element of the block, read before the
          // barrier so that its latency overlaps the wait
          const int l = lb + sum_row;
          const bool mine = sum_col == 0 && l < nl;
          float ar = 0.0f, ai = 0.0f;
          if (mine) {
            ar = row_re[l];
            ai = row_im[l];
          }
          __syncthreads();  // the partials of these kRedL degrees are stored
          const float4* row =
              reinterpret_cast<const float4*>(&red[buf][sum_row][0]);
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int v = sum_col; v < kRowVec; v += kSumThreads) {
            const float4 x = row[v];
            sr += x.x + x.z;
            si += x.y + x.w;
          }
#pragma unroll
          for (int off = kSumThreads / 2; off > 0; off >>= 1) {
            sr += __shfl_xor_sync(0xffffffffu, sr, off);
            si += __shfl_xor_sync(0xffffffffu, si, off);
          }
          if (mine) {
            row_re[l] = __fadd_rn(ar, sr);
            row_im[l] = __fadd_rn(ai, si);
          }
          buf ^= 1;  // the next block of partials goes to the other buffer
        });
  }
}

}  // namespace

// E/O real and imaginary planes [nm, J] of the m rows m0 .. m0 + nm - 1;
// cth, ln_sth [J]; logc [nm] (of those rows);
// mcut [ceil(J / 512)] int32; alm_re/alm_im [nm, nl] (TRANSPOSED, zeroed by
// the caller).  One block per row, row 0 (the longest) first.  Returns
// cudaGetLastError() after the launch.
extern "C" int legendre_analysis_launch(
    const float* ere, const float* eim, const float* ore, const float* oim,
    const float* cth, const float* ln_sth, const float* logc, const int* mcut,
    float* alm_re, float* alm_im, int nl, int nm, int J, int m0,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m0 != 0) {
    legendre_analysis_kernel<true><<<nm, kThreads, 0, s>>>(
        ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im, nl, J,
        m0);
  } else {
    legendre_analysis_kernel<false><<<nm, kThreads, 0, s>>>(
        ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im, nl, J,
        0);
  }
  return static_cast<int>(cudaGetLastError());
}

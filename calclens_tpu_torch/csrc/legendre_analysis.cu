// Legendre analysis of the spherical-harmonic transform (map -> alm), f32.
//
// Replaces the Pallas TPU kernel calclens_tpu/sht/pallas_legendre.py::
// _analysis_kernel (wrappers _analysis_alm, analysis_pallas).  It computes
//
//   alm[l, m] = sum_j lambda_lm(theta_j) * S_{l mod 2}[m, j]
//
// over the northern ring pairs j, where S0 = (m even ? E : O) and
// S1 = (m even ? O : E) are the quadrature-folded even/odd ring-pair sums.
// lambda_lm comes from the scaled three-term recurrence in l: the diagonal
// seed lambda_mm is taken directly in log2 space (stored value in
// [2^-32, 2^32) times 2^(64 k)), and a per-element scale counter k rescales
// by 2^-64 whenever |p| > 2^32; lambda = p for k == 0, p * 2^-64 for
// k == -1 and 0 below (the reference's plmgen rescaling and lmin cutoff).
// Blocks whose m lies at or beyond the j-tile's turning-point cutoff mcut
// (transforms.m_cutoff on the tile's largest sin theta) contribute nothing
// and exit at once.
//
// What bounds it on the H100: per (l, m, j) the recurrence costs ~4 FP32
// ops and the contraction 4 FMAs, but the sum runs over j, i.e. ACROSS
// threads, once per degree l.  A per-l block reduction is the limit, not
// memory: the inputs (E, O) are read once and alm is written once.
// Design: a block is one m times a 512-ring tile; each of its 128 threads
// carries the recurrence of 4 rings in registers and sums their products
// locally, so one warp-shuffle tree (5 steps for re and im) serves 4
// rings.  The warps' partial sums for 128 degrees wait in shared memory
// and are summed by one thread per degree; the 512-ring tiles of a degree
// are combined with atomicAdd into the zeroed alm buffer.  So for J > 512
// (HEALPix order >= 9) the order of the final f32 sums can change from run
// to run and the last bits of alm with it; for J <= 512 the kernel is
// deterministic.  The recurrence coefficients of 128 degrees are computed
// once per block into shared memory instead of two square roots per degree
// in every thread.  The triangular skip (no work for l < m) is the loop's
// start at l = m.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::coeffs;
using calclens::diag_seed;
using calclens::lam_step;

constexpr int kThreads = 128;                     // threads per block
constexpr int kRingsPerThread = 4;
constexpr int kTileJ = kThreads * kRingsPerThread;  // 512 rings: the mcut tile
constexpr int kChunkL = 128;                      // degrees per shared chunk
constexpr int kWarps = kThreads / 32;

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
                         int nl, int J) {
  const int jt = blockIdx.x;
  const int m = blockIdx.y;
  if (m >= mcut[jt]) return;  // whole (m, tile) below f32 significance

  __shared__ float coef_a[kChunkL];
  __shared__ float coef_b[kChunkL];
  __shared__ float red_re[kWarps][kChunkL];
  __shared__ float red_im[kWarps][kChunkL];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float mf = static_cast<float>(m);
  const bool m_even = (m & 1) == 0;
  const float logc_m = logc[m];

  float s0r[kRingsPerThread], s0i[kRingsPerThread];
  float s1r[kRingsPerThread], s1i[kRingsPerThread];
  float c[kRingsPerThread], pp[kRingsPerThread], pc[kRingsPerThread];
  float sv[kRingsPerThread];
  int k[kRingsPerThread], sk[kRingsPerThread];
#pragma unroll
  for (int q = 0; q < kRingsPerThread; ++q) {
    const int j = jt * kTileJ + q * kThreads + t;
    s0r[q] = s0i[q] = s1r[q] = s1i[q] = 0.0f;
    c[q] = 0.0f;
    sv[q] = 0.0f;
    sk[q] = 0;
    if (j < J) {
      const size_t o = static_cast<size_t>(m) * J + j;
      const float er = ere[o], ei = eim[o], orr = ore[o], oi = oim[o];
      s0r[q] = m_even ? er : orr;
      s0i[q] = m_even ? ei : oi;
      s1r[q] = m_even ? orr : er;
      s1i[q] = m_even ? oi : ei;
      c[q] = cth[j];
      diag_seed(logc_m, mf, ln_sth[j], sv[q], sk[q]);
    }
    pp[q] = pc[q] = 0.0f;
    k[q] = 0;
  }

  for (int l0 = m; l0 < nl; l0 += kChunkL) {
    const int nc = min(kChunkL, nl - l0);
    __syncthreads();  // the previous chunk's readers are done
    if (t < nc) {
      coeffs(static_cast<float>(l0 + t), mf, coef_a[t], coef_b[t]);
    }
    __syncthreads();
    for (int i = 0; i < nc; ++i) {
      const int l = l0 + i;
      const float a = coef_a[i];
      const float b = coef_b[i];
      const bool odd = (l & 1) != 0;
      float pr = 0.0f, pim = 0.0f;
#pragma unroll
      for (int q = 0; q < kRingsPerThread; ++q) {
        // l == m is the diagonal seed row (a block-uniform branch)
        const float lam = lam_step(l == m, a, b, c[q], sv[q], sk[q], pp[q],
                                   pc[q], k[q]);
        pr += lam * (odd ? s1r[q] : s0r[q]);
        pim += lam * (odd ? s1i[q] : s0i[q]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, off);
        pim += __shfl_xor_sync(0xffffffffu, pim, off);
      }
      if (lane == 0) {
        red_re[warp][i] = pr;
        red_im[warp][i] = pim;
      }
    }
    __syncthreads();
    if (t < nc) {
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sr += red_re[w][t];
        si += red_im[w][t];
      }
      const size_t o = static_cast<size_t>(m) * nl + l0 + t;
      atomicAdd(alm_re + o, sr);
      atomicAdd(alm_im + o, si);
    }
  }
}

}  // namespace

// E/O real and imaginary planes [nm, J]; cth, ln_sth [J]; logc [nm];
// mcut [ceil(J / 512)] int32; alm_re/alm_im [nm, nl] (TRANSPOSED, zeroed by
// the caller).  Returns cudaGetLastError() after the launch.
extern "C" int legendre_analysis_launch(
    const float* ere, const float* eim, const float* ore, const float* oim,
    const float* cth, const float* ln_sth, const float* logc, const int* mcut,
    float* alm_re, float* alm_im, int nl, int nm, int J, void* stream) {
  const dim3 grid((J + kTileJ - 1) / kTileJ, nm);
  legendre_analysis_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im, nl, J);
  return static_cast<int>(cudaGetLastError());
}

// Legendre analysis by stored lambda (K4), f32: K1's function by another
// route.
//
// Replaces the Pallas TPU kernel calclens_tpu/sht/pallas_legendre.py::
// _analysis_dot_kernel (wrapper analysis_pallas under CALCLENS_ANA_DOT=1).
// It computes, like K1 (legendre_analysis.cu),
//
//   alm[l, m] = sum_j lambda_lm(theta_j) * S_{l mod 2}[m, j]
//
// with S0 = (m even ? E : O), S1 = (m even ? O : E), the same recurrence
// (legendre_common.cuh, direct log2-space seed, so the same lambda bits as
// K1) and K1's per-512-ring-tile turning-point cutoff.  What differs is the
// route: the recurrence first STORES lambda for a block of degrees, then the
// block is contracted over the rings against the parity-resolved sources.
// The TPU kernel held a [32 m, 128 l, 512 j] lambda tile (8 MB of VMEM) and
// contracted it on the MXU at HIGHEST precision; a Hopper block has 227 KB
// of shared memory, so the tile here is one m times 16 degrees times 512
// rings (33 KB), and the contraction stays in FP32 FMA on the CUDA cores
// (TF32 would lose the digits that the comparison with K1 needs; tensor
// cores are later work).
//
// What bounds it on the H100: per (l, m, j) the recurrence costs ~4 FP32
// ops, one shared-memory store and, in the contraction, one load and two
// FMAs (the parity picks two of the four sources); E and O are read once and
// alm is written once, so memory does not bound it.  The shared-memory
// traffic of the stored tile and the per-block barriers are the cost of the
// route over K1's.
// Design: a block is one m times a 512-ring tile (blocks at or beyond the
// tile's cutoff exit at once).  Each of its 128 threads runs the recurrence
// for 4 rings (j = q * 128 + t, coalesced) and stores lambda for 16 degrees
// into the tile; after a barrier, 8 threads share each degree's two dot
// products (re, im) over the 512 rings, strided by 8, and a 3-step
// warp-shuffle tree sums them.  Rows are padded to 520 floats so the four
// degrees a warp reads hit distinct banks.  The 512-ring tiles of a degree
// are combined with atomicAdd into the zeroed alm buffer, as in K1: for
// J > 512 the last bits of alm can change from run to run.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::coeffs;
using calclens::diag_seed;
using calclens::lam_step;

constexpr int kThreads = 128;
constexpr int kRingsPerThread = 4;
constexpr int kTileJ = kThreads * kRingsPerThread;  // 512 rings: the mcut tile
constexpr int kBlockL = 16;                 // degrees stored per contraction
constexpr int kStride = kTileJ + 8;         // padded row (bank spread)
constexpr int kSplit = kThreads / kBlockL;  // threads per degree's dot

static_assert(kSplit == 8, "the shuffle tree below sums groups of 8 lanes");

__global__ void __launch_bounds__(kThreads)
legendre_analysis_dot_kernel(const float* __restrict__ ere,
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

  __shared__ float lam_s[kBlockL][kStride];
  __shared__ float src[4][kStride];  // S0 re, S0 im, S1 re, S1 im
  __shared__ float coef_a[kBlockL];
  __shared__ float coef_b[kBlockL];

  const int t = threadIdx.x;
  const float mf = static_cast<float>(m);
  const bool m_even = (m & 1) == 0;
  const float logc_m = logc[m];

  float c[kRingsPerThread], pp[kRingsPerThread], pc[kRingsPerThread];
  float sv[kRingsPerThread];
  int k[kRingsPerThread], sk[kRingsPerThread];
#pragma unroll
  for (int q = 0; q < kRingsPerThread; ++q) {
    const int jl = q * kThreads + t;
    const int j = jt * kTileJ + jl;
    float er = 0.0f, ei = 0.0f, orr = 0.0f, oi = 0.0f;
    c[q] = 0.0f;
    sv[q] = 0.0f;
    sk[q] = 0;
    if (j < J) {
      const size_t o = static_cast<size_t>(m) * J + j;
      er = ere[o];
      ei = eim[o];
      orr = ore[o];
      oi = oim[o];
      c[q] = cth[j];
      diag_seed(logc_m, mf, ln_sth[j], sv[q], sk[q]);
    }
    src[0][jl] = m_even ? er : orr;
    src[1][jl] = m_even ? ei : oi;
    src[2][jl] = m_even ? orr : er;
    src[3][jl] = m_even ? oi : ei;
    pp[q] = pc[q] = 0.0f;
    k[q] = 0;
  }

  const int deg = t / kSplit;  // the degree of the block this thread sums
  const int sub = t % kSplit;  // its share of the rings: sub, sub + 8, ...
  for (int l0 = m; l0 < nl; l0 += kBlockL) {
    const int nc = min(kBlockL, nl - l0);
    __syncthreads();  // the previous contraction is done with the tile
    if (t < nc) {
      coeffs(static_cast<float>(l0 + t), mf, coef_a[t], coef_b[t]);
    }
    __syncthreads();
    for (int i = 0; i < nc; ++i) {
      const float a = coef_a[i];
      const float b = coef_b[i];
#pragma unroll
      for (int q = 0; q < kRingsPerThread; ++q) {
        // l == m is the diagonal seed row (a block-uniform branch)
        lam_s[i][q * kThreads + t] = lam_step(l0 + i == m, a, b, c[q], sv[q],
                                              sk[q], pp[q], pc[q], k[q]);
      }
    }
    __syncthreads();
    float pr = 0.0f, pim = 0.0f;
    if (deg < nc) {
      const int par = (l0 + deg) & 1;
      const float* lr = lam_s[deg];
      const float* sr = src[2 * par];
      const float* si = src[2 * par + 1];
#pragma unroll 8
      for (int jj = sub; jj < kTileJ; jj += kSplit) {
        pr += lr[jj] * sr[jj];
        pim += lr[jj] * si[jj];
      }
    }
#pragma unroll
    for (int off = kSplit / 2; off > 0; off >>= 1) {
      pr += __shfl_xor_sync(0xffffffffu, pr, off);
      pim += __shfl_xor_sync(0xffffffffu, pim, off);
    }
    if (sub == 0 && deg < nc) {
      const size_t o = static_cast<size_t>(m) * nl + l0 + deg;
      atomicAdd(alm_re + o, pr);
      atomicAdd(alm_im + o, pim);
    }
  }
}

}  // namespace

// E/O real and imaginary planes [nm, J]; cth, ln_sth [J]; logc [nm];
// mcut [ceil(J / 512)] int32; alm_re/alm_im [nm, nl] (TRANSPOSED, zeroed by
// the caller).  Returns cudaGetLastError() after the launch.
extern "C" int legendre_analysis_dot_launch(
    const float* ere, const float* eim, const float* ore, const float* oim,
    const float* cth, const float* ln_sth, const float* logc, const int* mcut,
    float* alm_re, float* alm_im, int nl, int nm, int J, void* stream) {
  const dim3 grid((J + kTileJ - 1) / kTileJ, nm);
  legendre_analysis_dot_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im, nl, J);
  return static_cast<int>(cudaGetLastError());
}

// Legendre synthesis (alm -> ring values), f32: K2 with derivatives (16
// columns) and its potential-only form (4 columns).
//
// Replaces the Pallas TPU kernel calclens_tpu/sht/pallas_legendre_mx.py::
// _synth_mx_kernel (wrappers _synth_mx_raw, synthesis_pallas_mx, mx_prep),
// for ncol = 16 and ncol = 4.  It computes the raw columns
//
//   out[m, c, j] = sum_{l >= m} lambda_lm(theta_j) * s_c(l, m)
//
// with s in {a, l a, h, l(l+1) a} x {re, im} x {1, (-1)^l} (16 columns),
// where h_l = d_{l+1} a_{l+1} is the shifted stream of the summed-by-parts
// d_theta recurrence, or s in {a} x {re, im} x {1, (-1)^l} (4 columns, the
// potential alone: alm2map).  Outside the kernel, elementwise cot, 1/sin and
// m^2/sin^2 factors turn the columns into (qN, qS).  lambda_lm comes from
// the same scaled recurrence as the analysis kernel: diagonal seed in log2
// space, 2^-64 rescale with a scale counter, lambda = 0 below 2^-64 of the
// stored scale.
//
// What bounds it on the H100: FP32 arithmetic.  Per (l, m, j) the
// recurrence costs ~4 ops and the columns 8 FMAs (16 columns) or 2 (4
// columns): even and odd degrees are summed apart, so the (-1)^l columns are
// a difference at the end.  Nothing is reduced across threads and the
// output is written once.  The contraction stays in plain FP32 FMA on the
// CUDA cores: the summed-by-parts streams cancel by ~1/l after the
// cot / (1/sin) combination, which TF32 tensor-core inputs (10-bit
// mantissa) would turn into O(1) errors at high l.
// Design: one thread per (m, ring pair j), a block is one m times 128 rings.
// The block stages 128 degrees of its m's alm streams, pre-multiplied by l
// and l(l+1), together with the recurrence coefficients in shared memory
// (three float4 broadcast loads per degree, one for the potential alone), so
// a thread's inner loop is the recurrence plus the FMAs into register
// accumulators.  The triangular skip (no work for l < m) is the loop's start
// at l = m; blocks of small m (the longest) are launched first.  The column
// count is a template parameter: one source, two launchers, two counters.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::coeffs;
using calclens::diag_seed;
using calclens::lam_step;

constexpr int kThreads = 128;  // rings per block, one per thread
constexpr int kChunkL = 128;   // degrees per shared chunk (== kThreads)

// kStreams = 8 (16 columns, with derivatives) or 2 (4 columns, potential)
template <int kStreams>
__global__ void __launch_bounds__(kThreads)
legendre_synth_kernel(const float* __restrict__ a_re,  // [nm, nl]
                      const float* __restrict__ a_im,
                      const float* __restrict__ h_re,  // unused for 2 streams
                      const float* __restrict__ h_im,
                      const float* __restrict__ cth,
                      const float* __restrict__ ln_sth,
                      const float* __restrict__ logc,
                      float* __restrict__ out,  // [nm, 2 kStreams, J]
                      int nl, int J) {
  constexpr int kVec = kStreams == 8 ? 3 : 1;
  __shared__ float4 sh[kChunkL][kVec];

  const int t = threadIdx.x;
  const int j = blockIdx.x * kThreads + t;
  const int m = blockIdx.y;
  const float mf = static_cast<float>(m);
  const size_t row = static_cast<size_t>(m) * nl;

  float c = 0.0f, sv = 0.0f;
  int sk = 0;
  if (j < J) {
    c = cth[j];
    diag_seed(logc[m], mf, ln_sth[j], sv, sk);
  }
  float pp = 0.0f, pc = 0.0f;
  int k = 0;
  float ev[kStreams], od[kStreams];
#pragma unroll
  for (int i = 0; i < kStreams; ++i) ev[i] = od[i] = 0.0f;

  for (int l0 = m; l0 < nl; l0 += kChunkL) {
    const int nc = min(kChunkL, nl - l0);
    __syncthreads();  // the previous chunk's readers are done
    if (t < nc) {
      const int l = l0 + t;
      const float lf = static_cast<float>(l);
      float ca, cb;
      coeffs(lf, mf, ca, cb);
      const float ar = a_re[row + l], ai = a_im[row + l];
      sh[t][0] = make_float4(ca, cb, ar, ai);
      if constexpr (kStreams == 8) {
        const float hr = h_re[row + l], hi = h_im[row + l];
        const float l2 = __fmul_rn(lf, lf + 1.0f);
        sh[t][1] = make_float4(__fmul_rn(ar, lf), __fmul_rn(ai, lf), hr, hi);
        sh[t][2] = make_float4(__fmul_rn(ar, l2), __fmul_rn(ai, l2), 0.0f,
                               0.0f);
      }
    }
    __syncthreads();
    for (int i = 0; i < nc; ++i) {
      const int l = l0 + i;
      const float4 s0 = sh[i][0];
      // l == m is the diagonal seed row (a block-uniform branch)
      const float lam = lam_step(l == m, s0.x, s0.y, c, sv, sk, pp, pc, k);
      if (l & 1) {
        od[0] += s0.z * lam; od[1] += s0.w * lam;
        if constexpr (kStreams == 8) {
          const float4 s1 = sh[i][1];
          const float4 s2 = sh[i][2];
          od[2] += s1.x * lam; od[3] += s1.y * lam;
          od[4] += s1.z * lam; od[5] += s1.w * lam;
          od[6] += s2.x * lam; od[7] += s2.y * lam;
        }
      } else {
        ev[0] += s0.z * lam; ev[1] += s0.w * lam;
        if constexpr (kStreams == 8) {
          const float4 s1 = sh[i][1];
          const float4 s2 = sh[i][2];
          ev[2] += s1.x * lam; ev[3] += s1.y * lam;
          ev[4] += s1.z * lam; ev[5] += s1.w * lam;
          ev[6] += s2.x * lam; ev[7] += s2.y * lam;
        }
      }
    }
  }
  if (j < J) {
    float* o = out + static_cast<size_t>(m) * (2 * kStreams) * J + j;
#pragma unroll
    for (int i = 0; i < kStreams; ++i) {
      o[static_cast<size_t>(i) * J] = ev[i] + od[i];  // sum_l s lam
      o[static_cast<size_t>(i + kStreams) * J] =
          ev[i] - od[i];  // sum_l (-1)^l s lam
    }
  }
}

template <int kStreams>
int launch(const float* a_re, const float* a_im, const float* h_re,
           const float* h_im, const float* cth, const float* ln_sth,
           const float* logc, float* out, int nl, int nm, int J,
           void* stream) {
  const dim3 grid((J + kThreads - 1) / kThreads, nm);
  legendre_synth_kernel<kStreams>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          a_re, a_im, h_re, h_im, cth, ln_sth, logc, out, nl, J);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Streams a_re, a_im, h_re, h_im [nm, nl] (TRANSPOSED alm); cth, ln_sth [J];
// logc [nm]; out [nm, 16, J].  Returns cudaGetLastError() after the launch.
extern "C" int legendre_synth_launch(
    const float* a_re, const float* a_im, const float* h_re, const float* h_im,
    const float* cth, const float* ln_sth, const float* logc, float* out,
    int nl, int nm, int J, void* stream) {
  return launch<8>(a_re, a_im, h_re, h_im, cth, ln_sth, logc, out, nl, nm, J,
                   stream);
}

// The potential alone: a_re, a_im [nm, nl]; out [nm, 4, J] = {a_re, a_im}
// summed with weight 1, then with (-1)^l.
extern "C" int legendre_synth_phi_launch(
    const float* a_re, const float* a_im, const float* cth,
    const float* ln_sth, const float* logc, float* out, int nl, int nm,
    int J, void* stream) {
  return launch<2>(a_re, a_im, nullptr, nullptr, cth, ln_sth, logc, out, nl,
                   nm, J, stream);
}

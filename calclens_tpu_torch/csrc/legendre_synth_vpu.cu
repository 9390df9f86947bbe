// Legendre synthesis by l-parity buckets (K3), f32, with derivatives or the
// potential alone.
//
// Replaces the Pallas TPU kernel calclens_tpu/sht/pallas_legendre.py::
// _synth_kernel (wrapper synthesis_pallas).  Per (m, ring pair j) it sums
//
//   bucket[s][p] = sum_{l >= m, l = p mod 2} a_s(l, m) * L_s(l, m, theta_j)
//
// for the slots s = (a_re, a_im) x (lambda, lambda', lambda'') with
// derivatives (12 outputs) or (a_re, a_im) x lambda without (4 outputs),
// where, per degree, as the TPU kernel forms them,
//
//   lambda'  = l cot lambda_l - c_lm lambda_{l-1} / sin,
//   lambda'' = (m^2 / sin^2 - l(l+1)) lambda_l - cot lambda',
//   c_lm = sqrt((l^2 - m^2)(2l+1)/(2l-1)).
//
// Outside the kernel, qN = A + B and qS = s_m (A - B) (sht/legendre.py::
// q_from_buckets).  lambda_mm is seeded by the TPU kernel's chain of
// products from lambda_00 with its 2^-64 underflow rescale and counter
// (legendre_common.cuh::chain_step), not by K2's direct log2-space seed: the
// two round differently, and the polar recurrence amplifies that, so K3 is
// its own kernel and not K2 with another output layout.  Every operation
// that the plain twin performs as a separate tensor op is an explicitly
// rounded intrinsic here, so kernel and twin form the same lambda, lambda'
// and lambda'' bits and differ only in the order of the sums over l.
//
// What bounds it on the H100: FP32 arithmetic.  Per (l, m, j) the
// recurrence costs ~6 ops, lambda' and lambda'' ~9 more, and the buckets 6
// FMAs (2 and no derivative ops for the potential alone).  The function
// needs no more than K2's count: summed by parts, the lambda' and lambda''
// sums follow from sums of a lambda, l a lambda and l(l+1) a lambda, so
// K2's floor is K3's, and forming them per degree is the TPU kernel's route,
// kept for its bits.  Nothing is reduced across threads; the output is
// written once.  The TPU kernel swept
// every l for every m; here a thread advances the seed chain alone through
// l < m (two multiplies per degree, the chain factors computed once per
// block into shared memory) and starts the recurrence at l = m, which gives
// the same bits for less work.  Like the TPU kernel, K3 has no m cutoff.
// Design: one thread per (m, ring pair j), a block is one m times 128
// rings; the block stages 128 degrees of its m's alm row with the
// recurrence coefficients and c_lm in shared memory, so a thread's inner
// loop is the recurrence, the derivative forms and the FMAs into register
// buckets.  Blocks of small m (the longest) are launched first.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::chain_factor;
using calclens::chain_step;
using calclens::coeffs;
using calclens::corfac;
using calclens::kY00;
using calclens::lam_step;

constexpr int kThreads = 128;  // rings per block, one per thread
constexpr int kChunkL = 128;   // degrees per shared chunk (== kThreads)

template <bool kDerivs>
__global__ void __launch_bounds__(kThreads)
legendre_synth_vpu_kernel(const float* __restrict__ a_re,  // [nm, nl]
                          const float* __restrict__ a_im,
                          const float* __restrict__ cth,
                          const float* __restrict__ sth,
                          const float* __restrict__ cot,
                          const float* __restrict__ inv_sth,
                          float* __restrict__ out,  // [nm, 2 kAcc, J]
                          int nl, int J) {
  constexpr int kAcc = kDerivs ? 6 : 2;
  __shared__ float4 sh[kChunkL];  // a_lm, b_lm, a_re, a_im
  __shared__ float shc[kChunkL];  // chain factor, then c_lm

  const int t = threadIdx.x;
  const int j = blockIdx.x * kThreads + t;
  const int m = blockIdx.y;
  const float mf = static_cast<float>(m);
  const size_t row = static_cast<size_t>(m) * nl;
  const bool live = j < J;
  const float cj = live ? cth[j] : 0.0f;

  // the seed chain alone through l < m
  float sv = kY00;
  int sk = 0;
  {
    const float sj = live ? sth[j] : 0.0f;
    for (int l0 = 0; l0 < m; l0 += kChunkL) {
      const int nc = min(kChunkL, m - l0);
      __syncthreads();  // the previous chunk's readers are done
      if (t < nc) shc[t] = chain_factor(static_cast<float>(l0 + t));
      __syncthreads();
      for (int i = 0; i < nc; ++i) chain_step(sj, shc[i], sv, sk);
    }
  }

  float ct = 0.0f, iv = 0.0f, m2i2 = 0.0f;
  if (kDerivs && live) {
    ct = cot[j];
    iv = inv_sth[j];
    m2i2 = __fmul_rn(__fmul_rn(__fmul_rn(mf, mf), iv), iv);
  }
  float pp = 0.0f, pc = 0.0f;
  int k = 0;
  float ev[kAcc], od[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) ev[i] = od[i] = 0.0f;

  for (int l0 = m; l0 < nl; l0 += kChunkL) {
    const int nc = min(kChunkL, nl - l0);
    __syncthreads();  // the previous chunk's readers are done
    if (t < nc) {
      const int l = l0 + t;
      const float lf = static_cast<float>(l);
      float ca, cb;
      coeffs(lf, mf, ca, cb);
      sh[t] = make_float4(ca, cb, a_re[row + l], a_im[row + l]);
      if (kDerivs) {
        const float num = __fmul_rn(fmaxf(__fmul_rn(lf - mf, lf + mf), 0.0f),
                                    2.0f * lf + 1.0f);
        shc[t] = sqrtf(__fdiv_rn(num, fmaxf(2.0f * lf - 1.0f, 1.0f)));
      }
    }
    __syncthreads();
    for (int i = 0; i < nc; ++i) {
      const int l = l0 + i;
      const float4 s = sh[i];
      // l == m is the diagonal seed row (a block-uniform branch)
      const float lam = lam_step(l == m, s.x, s.y, cj, sv, sk, pp, pc, k);
      float v[kAcc / 2];  // lambda (, lambda', lambda'')
      v[0] = lam;
      if constexpr (kDerivs) {
        const float lf = static_cast<float>(l);
        const float lam_prev = __fmul_rn(pp, corfac(k));
        const float lamp =
            __fsub_rn(__fmul_rn(__fmul_rn(lf, ct), lam),
                      __fmul_rn(__fmul_rn(shc[i], lam_prev), iv));
        const float lampp = __fsub_rn(
            __fmul_rn(__fsub_rn(m2i2, __fmul_rn(lf, lf + 1.0f)), lam),
            __fmul_rn(ct, lamp));
        v[1] = lamp;
        v[2] = lampp;
      }
      // slot 2 q + (0, 1) = (a_re, a_im) x v[q]; separate arms keep the
      // buckets in registers
      if (l & 1) {
#pragma unroll
        for (int q = 0; q < kAcc / 2; ++q) {
          od[2 * q] += s.z * v[q];
          od[2 * q + 1] += s.w * v[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < kAcc / 2; ++q) {
          ev[2 * q] += s.z * v[q];
          ev[2 * q + 1] += s.w * v[q];
        }
      }
    }
  }
  if (live) {
    float* o = out + static_cast<size_t>(m) * (2 * kAcc) * J + j;
#pragma unroll
    for (int q = 0; q < kAcc; ++q) {
      o[static_cast<size_t>(2 * q) * J] = ev[q];      // bucket A: even l
      o[static_cast<size_t>(2 * q + 1) * J] = od[q];  // bucket B: odd l
    }
  }
}

}  // namespace

// a_re, a_im [nm, nl] (TRANSPOSED alm); cth, sth, cot, inv_sth [J];
// out [nm, 12, J] with derivatives, [nm, 4, J] without (column 2 s + p for
// slot s, l parity p).  Returns cudaGetLastError() after the launch.
extern "C" int legendre_synth_vpu_launch(
    const float* a_re, const float* a_im, const float* cth, const float* sth,
    const float* cot, const float* inv_sth, float* out, int nl, int nm, int J,
    int derivs, void* stream) {
  const dim3 grid((J + kThreads - 1) / kThreads, nm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (derivs) {
    legendre_synth_vpu_kernel<true><<<grid, kThreads, 0, s>>>(
        a_re, a_im, cth, sth, cot, inv_sth, out, nl, J);
  } else {
    legendre_synth_vpu_kernel<false><<<grid, kThreads, 0, s>>>(
        a_re, a_im, cth, sth, cot, inv_sth, out, nl, J);
  }
  return static_cast<int>(cudaGetLastError());
}

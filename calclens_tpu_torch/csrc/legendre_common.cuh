// The scaled lambda_lm recurrence shared by the two Legendre kernels.
//
// Every operation that the plain PyTorch twin (sht/legendre.py) performs as
// a separate tensor op is written here with an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot contract it
// into an FMA: the kernels and the twins then produce the same float32
// lambda bits.  That matters because the forward recurrence is
// ill-conditioned near the poles (a rounding difference grows by up to
// ~1/sin(theta) over the l sweep), so two evaluations that round
// differently disagree far above float32 epsilon in the polar rings even
// though neither is less accurate.
#pragma once

#include <cuda_runtime.h>

namespace calclens {

constexpr float kThBig = 4294967296.0f;            // 2^32
constexpr float kResc = 5.42101086242752217e-20f;  // 2^-64
constexpr float kHalfLn4Pi = 1.2655121234846454f;  // 0.5 ln(4 pi)
constexpr float kLog2e = 1.4426950408889634f;

// Diagonal seed lambda_mm = 2^log2lam, stored as val * 2^(64 k) with val in
// [2^-32, 2^32): a ceil-based window would give k = +1 near the equator
// (|lambda_mm| > 1 at large m) and the scale cutoff would drop those values.
__device__ __forceinline__ void diag_seed(float logc_m, float mf,
                                          float ln_sth, float& val, int& k) {
  const float log2lam = __fmul_rn(
      __fsub_rn(__fadd_rn(logc_m, __fmul_rn(mf, ln_sth)), kHalfLn4Pi),
      kLog2e);
  const float kf = floorf(__fmul_rn(__fadd_rn(log2lam, 32.0f), 1.0f / 64.0f));
  val = exp2f(__fsub_rn(log2lam, __fmul_rn(64.0f, kf)));
  k = static_cast<int>(kf);
}

// Recurrence coefficients a_lm, b_lm (l, m exact in float32).
__device__ __forceinline__ void coeffs(float lf, float mf, float& a,
                                       float& b) {
  const float den = fmaxf(__fmul_rn(lf - mf, lf + mf), 1.0f);
  const float num = __fmul_rn(2.0f * lf - 1.0f, 2.0f * lf + 1.0f);
  a = sqrtf(__fdiv_rn(num, den));
  const float bnum =
      fmaxf(__fmul_rn(lf - 1.0f - mf, lf - 1.0f + mf), 0.0f);
  const float bden =
      fmaxf(__fmul_rn(2.0f * lf - 3.0f, 2.0f * lf - 1.0f), 1.0f);
  b = sqrtf(__fdiv_rn(bnum, bden));
}

// One degree l of the scaled recurrence for one (m, ring): updates the
// state (pp, pc, k) and returns lambda_lm (0 below 2^-64 of the stored
// scale).  `seed_row` is l == m, where the diagonal seed (sv, sk) enters.
__device__ __forceinline__ float lam_step(bool seed_row, float a, float b,
                                          float c, float sv, int sk,
                                          float& pp, float& pc, int& k) {
  float nw;
  if (seed_row) {
    nw = sv;
    pp = 0.0f;
    k = sk;
  } else {
    nw = __fmul_rn(a, __fsub_rn(__fmul_rn(c, pc), __fmul_rn(b, pp)));
    pp = pc;
  }
  if (fabsf(nw) > kThBig) {
    nw = __fmul_rn(nw, kResc);
    pp = __fmul_rn(pp, kResc);
    ++k;
  }
  pc = nw;
  return __fmul_rn(nw, k == 0 ? 1.0f : (k == -1 ? kResc : 0.0f));
}

}  // namespace calclens

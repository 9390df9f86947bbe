// The scaled lambda_lm recurrence shared by the Legendre kernels.
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
constexpr float kY00 = 0.28209479177387814f;        // lambda_00 = 1/sqrt(4 pi)
constexpr float kTwo64 = 18446744073709551616.0f;  // 2^64

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

// K3's diagonal seed, a chain of products from lambda_00: one step takes
// lambda_ll to lambda_{l+1,l+1} = (lambda_ll sin theta) f_l with
// f_l = chain_factor(l) = sqrt((2l+3)/(2l+2)), rescaled by 2^64 (and the
// scale counter k down by one) when it falls below 2^-64.  The chain and the
// direct seed round differently, so K3's lambda differs from K2's in the
// last bits, which the polar recurrence amplifies.
__device__ __forceinline__ float chain_factor(float lf) {
  return sqrtf(__fdiv_rn(2.0f * lf + 3.0f, 2.0f * lf + 2.0f));
}

__device__ __forceinline__ void chain_step(float sth, float f, float& seed,
                                           int& k) {
  seed = __fmul_rn(__fmul_rn(seed, sth), f);
  if (seed < kResc) {
    seed = __fmul_rn(seed, kTwo64);
    --k;
  }
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

// The scale of a stored value with counter k: 1, 2^-64, or 0 below.
__device__ __forceinline__ float corfac(int k) {
  return k == 0 ? 1.0f : (k == -1 ? kResc : 0.0f);
}

// One degree l of the scaled recurrence for one (m, ring): updates the
// state (pp, pc, k) and returns lambda_lm (0 below 2^-64 of the stored
// scale); lambda_{l-1,m} is then pp * corfac(k).  `seed_row` is l == m,
// where the diagonal seed (sv, sk) enters.
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
  return __fmul_rn(nw, corfac(k));
}

// ---------------------------------------------------------------------------
// lam_step split for K1 and K2, whose threads carry R rings each.  Together
// the steps below give lam_step's bits; a kernel peels the seed row
// (l == m) off its loop, so no degree of the loop tests for it.
//
// The scale factor cf = corfac(k) is kept per ring and recomputed only when
// k changes.  A warp runs its degrees in one of three modes, chosen by a
// vote every few degrees (warp_mode); k only grows, so a warp goes from
// zero to careful to steady:
//  - zero: cf == 0 (k <= -2) on every ring of the warp, so lambda == 0 and
//    the sums are left alone: only the recurrence and its rescale;
//  - careful: lam_step's rescale test and lambda = value * cf;
//  - steady: cf == 1 (k == 0) on every ring: lambda == p exactly, and the
//    rescale cannot fire because |lambda_lm| <= sqrt((2l+1)/(4 pi)) < 2^6
//    << 2^32, so the bare rec_step (the TPU kernel's "steady" sweep,
//    calclens_tpu/sht/pallas_legendre_mx.py:224-239).
// ---------------------------------------------------------------------------

enum class Mode { kZero, kCareful, kSteady };

// The seed row of R rings: state from the diagonal seeds (sv, sk); returns
// lambda_mm in lam.
template <int R>
__device__ __forceinline__ void seed_rings(const float (&sv)[R],
                                           const int (&sk)[R], float (&pp)[R],
                                           float (&pc)[R], int (&k)[R],
                                           float (&cf)[R], float (&lam)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    pp[q] = 0.0f;
    pc[q] = sv[q];  // in [2^-32, 2^32): no rescale
    k[q] = sk[q];
    cf[q] = corfac(sk[q]);
    lam[q] = __fmul_rn(sv[q], cf[q]);
  }
}

// One degree of the bare recurrence on R rings:
// pc <- a (c pc - b pp), pp <- old pc, rounded op by op as lam_step.
template <int R>
__device__ __forceinline__ void rec_step(float a, float b, const float (&c)[R],
                                         float (&pp)[R], float (&pc)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float nw =
        __fmul_rn(a, __fsub_rn(__fmul_rn(c[q], pc[q]), __fmul_rn(b, pp[q])));
    pp[q] = pc[q];
    pc[q] = nw;
  }
}

// lam_step's 2^-64 rescale after rec_step, for a ring whose |value|
// exceeds 2^32: one test of the largest |value|, then a branch that is
// rarely taken.
template <int R>
__device__ __forceinline__ void rescale_rings(float (&pp)[R], float (&pc)[R],
                                              int (&k)[R], float (&cf)[R]) {
  float big = fabsf(pc[0]);
#pragma unroll
  for (int q = 1; q < R; ++q) big = fmaxf(big, fabsf(pc[q]));
  if (big > kThBig) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (fabsf(pc[q]) > kThBig) {
        pc[q] = __fmul_rn(pc[q], kResc);
        pp[q] = __fmul_rn(pp[q], kResc);
        ++k[q];
        cf[q] = corfac(k[q]);
      }
    }
  }
}

// The mode of the warp's next degrees (the same on every lane).
template <int R>
__device__ __forceinline__ Mode warp_mode(const float (&cf)[R]) {
  bool one = true, zero = true;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    one = one && cf[q] == 1.0f;
    zero = zero && cf[q] == 0.0f;
  }
  if (__all_sync(0xffffffffu, one)) return Mode::kSteady;
  return __all_sync(0xffffffffu, zero) ? Mode::kZero : Mode::kCareful;
}

}  // namespace calclens

// Legendre synthesis by l-parity buckets (K3), f32, with derivatives or the
// potential alone, and the pre-pass that walks its seed chain.
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
// (m, ring) pairs at or beyond the turning-point cutoff of their 128-ring
// tile (mcut, K2's rule) are below float32 significance: their buckets are
// written as 0, as K2's columns are.
//
// What bounds it on the H100: instruction issue.  The rounding contract
// forms lambda' and lambda'' per degree, op by op, so per (l, m, j) element
// with derivatives the kernel needs the recurrence's 4 operations, 5 for
// lambda', 4 for lambda'' and 6 bucket FMAs: 19 issue slots (the potential
// alone: 4 + 2 = 6).  Summed by parts, the function would need K2's 12;
// forming lambda' and lambda'' per degree is the TPU kernel's route, kept
// for its bits.  Nothing is reduced across threads; the output is written
// once.
//
// Design:
//  - the seed chain depends only on the geometry: a pre-pass
//    (legendre_chain_seed_kernel) walks it once per ring pair over m and
//    writes the (value, counter) pair of every m, [nm, J], which the main
//    kernel reads for its seed row, instead of every (m, ring) thread
//    walking the chain through l < m alone;
//  - the sweep is K2's (legendre_common.cuh's synth_sweep, which this file
//    gives its bucket sums): each thread carries 4 rings, a block is one m
//    times four warps of 128 consecutive rings; the block stages 128
//    degrees of coefficients, alm, c_lm, l(l+1) and l in shared memory (two
//    float4 broadcasts per degree serve a thread's 4 rings);
//  - the seed row l == m is peeled off the loop; after it a warp runs its
//    degrees in groups of 8 (16 for the potential alone) in one of three
//    modes chosen by a vote after each group (legendre_common.cuh): while
//    every ring's lambda is 0 only the recurrence and its rescale; the
//    careful recurrence (lambda = value * cf, lambda_{l-1} = prev * cf);
//    once every ring is at k == 0 the bare recurrence with lambda == pc and
//    lambda_{l-1} == pp exactly.  All three give the twin's bits;
//  - degrees are unrolled by 2, so bucket A or B is chosen at compile time;
//    the last chunk is padded with zero degrees to a whole group;
//  - the m cutoff is per warp: a warp beyond its tile's cutoff writes zeros
//    and skips the sweep; blocks of small m (the longest) launch first.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::chain_factor;
using calclens::chain_step;
using calclens::coeffs;
using calclens::kY00;
using calclens::Rings;
using calclens::SynthTile;

constexpr int kRings = 4;                 // rings per thread
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileJ = 32 * kRings;       // rings per warp: the mcut tile
constexpr int kBlockJ = kWarps * kTileJ;  // rings per block
constexpr int kChunkL = kThreads;         // degrees per shared chunk

// ---------------------------------------------------------------------------
// the seed pre-pass: one thread per ring pair walks the chain over m
// ---------------------------------------------------------------------------

constexpr int kSeedThreads = 128;

__global__ void __launch_bounds__(kSeedThreads)
legendre_chain_seed_kernel(const float* __restrict__ sth,
                           float* __restrict__ seed,  // [nm, J]
                           int* __restrict__ seed_k,  // [nm, J]
                           int nm, int J) {
  __shared__ float fac[kSeedThreads];  // chain factors of the chunk
  const int t = threadIdx.x;
  const int j = blockIdx.x * kSeedThreads + t;
  const bool live = j < J;
  const float sj = live ? sth[j] : 0.0f;
  float sv = kY00;
  int sk = 0;
  for (int l0 = 0; l0 < nm; l0 += kSeedThreads) {
    const int nc = min(kSeedThreads, nm - l0);
    __syncthreads();  // the previous chunk's readers are done
    if (t < nc) fac[t] = chain_factor(static_cast<float>(l0 + t));
    __syncthreads();
    for (int i = 0; i < nc; ++i) {
      if (live) {
        const size_t o = static_cast<size_t>(l0 + i) * J + j;
        seed[o] = sv;  // lambda_mm of m = l0 + i
        seed_k[o] = sk;
      }
      chain_step(sj, fac[i], sv, sk);
    }
  }
}

// ---------------------------------------------------------------------------
// the sweep
// ---------------------------------------------------------------------------

// kAcc = 6 (with derivatives) or 2 (the potential alone) buckets per parity
template <int kAcc>
struct Vpu : Rings<kRings> {
  static constexpr bool kDerivs = kAcc == 6;
  static constexpr int kVec = kDerivs ? 2 : 1;  // float4 per degree
  // degrees between two votes, as K2 (8 with derivatives, 16 without)
  static constexpr int kGroup = kDerivs ? 8 : 16;

  float ct[kRings], iv[kRings], m2i2[kRings];  // cot, 1/sin, m^2/sin^2
  float acc[2][kRings][kAcc];  // [(l - m) mod 2][ring][slot]

  // lam, lam_prev: lambda_l and lambda_{l-1} of the rings; s: the degree's
  // staged float4s (a, b, a_re, a_im), (c_lm, l(l+1), l, 0)
  template <int P>
  __device__ __forceinline__ void emit(const float4* s,
                                       const float (&lam)[kRings],
                                       const float (&lam_prev)[kRings]) {
    const float4 s0 = s[0];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      acc[P][q][0] += s0.z * lam[q];
      acc[P][q][1] += s0.w * lam[q];
    }
    if constexpr (kDerivs) {
      const float4 s1 = s[1];
#pragma unroll
      for (int q = 0; q < kRings; ++q) {
        const float lamp =
            __fsub_rn(__fmul_rn(__fmul_rn(s1.z, ct[q]), lam[q]),
                      __fmul_rn(__fmul_rn(s1.x, lam_prev[q]), iv[q]));
        const float lampp =
            __fsub_rn(__fmul_rn(__fsub_rn(m2i2[q], s1.y), lam[q]),
                      __fmul_rn(ct[q], lamp));
        acc[P][q][2] += s0.z * lamp;
        acc[P][q][3] += s0.w * lamp;
        acc[P][q][4] += s0.z * lampp;
        acc[P][q][5] += s0.w * lampp;
      }
    }
  }

  // lambda' and lambda'' would add +-0
  __device__ __forceinline__ void emit_zero(const float4*) {}
};

template <int kAcc>
__global__ void __launch_bounds__(kThreads)
legendre_synth_vpu_kernel(const float* __restrict__ a_re,  // [nm, nl]
                          const float* __restrict__ a_im,
                          const float* __restrict__ cth,
                          const float* __restrict__ cot,
                          const float* __restrict__ inv_sth,
                          const float* __restrict__ seed,  // [nm, J]
                          const int* __restrict__ seed_k,
                          const int* __restrict__ mcut,  // [ceil(J / kTileJ)]
                          float* __restrict__ out,       // [nm, 2 kAcc, J]
                          int nl, int J) {
  using S = Vpu<kAcc>;
  constexpr int kVec = S::kVec;
  __shared__ float4 sh[kChunkL][kVec];

  const int m = blockIdx.y;
  const SynthTile w = calclens::synth_tile<kWarps, kTileJ>(mcut, m, nl, J);
  const float mf = static_cast<float>(m);
  const size_t row = static_cast<size_t>(m) * nl;
  S s;
  float sv[kRings];
  int sk[kRings];
#pragma unroll
  for (int q = 0; q < kRings; ++q) {
    const int j = w.j0 + 32 * q;
    s.c[q] = s.ct[q] = s.iv[q] = s.m2i2[q] = 0.0f;
    sv[q] = 0.0f;
    sk[q] = 0;
    if (w.active && j < J) {
      s.c[q] = cth[j];
      const size_t o = static_cast<size_t>(m) * J + j;
      sv[q] = seed[o];
      sk[q] = seed_k[o];
      if constexpr (S::kDerivs) {
        s.ct[q] = cot[j];
        s.iv[q] = inv_sth[j];
        s.m2i2[q] = __fmul_rn(__fmul_rn(__fmul_rn(mf, mf), s.iv[q]), s.iv[q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) s.acc[0][q][i] = s.acc[1][q][i] = 0.0f;
  }

  calclens::synth_sweep<S::kGroup, kVec>(
      s, sh, m, nl, w, sv, sk, [&](int l, float4 (&d)[kVec]) {
        float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0;
        if (l < nl) {
          const float lf = static_cast<float>(l);
          float ca, cb;
          coeffs(lf, mf, ca, cb);
          v0 = make_float4(ca, cb, a_re[row + l], a_im[row + l]);
          if constexpr (S::kDerivs) {
            const float num = __fmul_rn(
                fmaxf(__fmul_rn(lf - mf, lf + mf), 0.0f), 2.0f * lf + 1.0f);
            v1 = make_float4(
                sqrtf(__fdiv_rn(num, fmaxf(2.0f * lf - 1.0f, 1.0f))),
                __fmul_rn(lf, lf + 1.0f), lf, 0.0f);
          }
        }
        d[0] = v0;
        if constexpr (S::kDerivs) d[1] = v1;
      });

  // bucket A (even l) holds the (l - m)-even sums for even m, the odd ones
  // for odd m; a warp beyond its cutoff writes its zeros
  const int pa = m & 1;
  float* o = out + static_cast<size_t>(m) * (2 * kAcc) * J;
#pragma unroll
  for (int q = 0; q < kRings; ++q) {
    const int j = w.j0 + 32 * q;
    if (j >= J) continue;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const float e = s.acc[0][q][i], d = s.acc[1][q][i];
      o[static_cast<size_t>(2 * i) * J + j] = pa ? d : e;      // bucket A
      o[static_cast<size_t>(2 * i + 1) * J + j] = pa ? e : d;  // bucket B
    }
  }
}

}  // namespace

// sth [J]; seed [nm, J] f32, seed_k [nm, J] int32: lambda_mm of every m by
// the chain (value and scale counter).  Returns cudaGetLastError().
extern "C" int legendre_chain_seed_launch(const float* sth, float* seed,
                                          int* seed_k, int nm, int J,
                                          void* stream) {
  const dim3 grid((J + kSeedThreads - 1) / kSeedThreads);
  legendre_chain_seed_kernel<<<grid, kSeedThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      sth, seed, seed_k, nm, J);
  return static_cast<int>(cudaGetLastError());
}

// a_re, a_im [nm, nl] (TRANSPOSED alm); cth, cot, inv_sth [J]; seed, seed_k
// [nm, J] from legendre_chain_seed_launch; mcut [ceil(J / 128)] int32; out
// [nm, 12, J] with derivatives, [nm, 4, J] without (column 2 s + p for
// slot s, l parity p).  Returns cudaGetLastError() after the launch.
extern "C" int legendre_synth_vpu_launch(
    const float* a_re, const float* a_im, const float* cth, const float* cot,
    const float* inv_sth, const float* seed, const int* seed_k,
    const int* mcut, float* out, int nl, int nm, int J, int derivs,
    void* stream) {
  const dim3 grid((J + kBlockJ - 1) / kBlockJ, nm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (derivs) {
    legendre_synth_vpu_kernel<6><<<grid, kThreads, 0, s>>>(
        a_re, a_im, cth, cot, inv_sth, seed, seed_k, mcut, out, nl, J);
  } else {
    legendre_synth_vpu_kernel<2><<<grid, kThreads, 0, s>>>(
        a_re, a_im, cth, cot, inv_sth, seed, seed_k, mcut, out, nl, J);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// stored scale.  (m, ring) pairs at or beyond the turning-point cutoff of
// their 128-ring tile (mcut, transforms.m_cutoff on the tile's largest
// sin theta) are below float32 significance: their columns are written as 0.
//
// What bounds it on the H100: instruction issue.  Nothing is reduced across
// threads, the output is written once and the inputs are small, so the
// limit is the issue slots of each (l, m, j) element: the recurrence, whose
// 4 operations stay rounded one by one (__fmul_rn / __fsub_rn, as the twin
// rounds them; no FMA), and the column FMAs, 8 (16 columns) or 2 (4
// columns): 12 or 6 slots at least.  The contraction stays in plain FP32 on
// the CUDA cores: the summed-by-parts streams cancel by ~1/l after the
// cot / (1/sin) combination, which TF32 inputs would turn into O(1) errors.
//
// Design, to spend the slots on that arithmetic and little else:
//  - each thread carries kRings = 4 rings, so the shared-memory loads of a
//    degree's streams and coefficients (three float4 broadcasts, one for the
//    potential alone) and the loop's own instructions serve 4 rings;
//  - a block is one m times 512 rings, four warps of 128 consecutive rings;
//    the block stages 128 degrees of its m's streams, pre-multiplied by l
//    and l(l+1), with the recurrence coefficients in shared memory;
//  - the seed row l == m is peeled off the loop; after it a warp runs its
//    degrees in groups of 8 (16 for the 4 columns) in one of three modes,
//    chosen by a vote after each group (legendre_common.cuh's synth_sweep,
//    which K3 shares; this file supplies the column sums): while every
//    ring's lambda is 0 (scale k <= -2) the recurrence alone, without the
//    column FMAs; then the careful recurrence (rescale test, scale factor);
//    once every ring of the warp is at k == 0 the bare 4-operation
//    recurrence.  All three give the twin's bits;
//  - degrees are unrolled by 2, so the even and odd sums are chosen at
//    compile time (the (-1)^l columns are their difference at the end);
//    the last chunk is padded with zero degrees to a whole group;
//  - the m cutoff is per warp: a warp whose 128-ring tile lies beyond its
//    cutoff writes zeros and skips the sweep (a block with no warp left
//    skips the staging too); blocks of small m (the longest) are launched
//    first.
// The column count is a template parameter: one source, two launchers, two
// counters.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::coeffs;
using calclens::diag_seed;
using calclens::Rings;
using calclens::SynthTile;

constexpr int kRings = 4;                 // rings per thread
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileJ = 32 * kRings;       // rings per warp: the mcut tile
constexpr int kBlockJ = kWarps * kTileJ;  // rings per block
constexpr int kChunkL = kThreads;         // degrees per shared chunk

// kStreams = 8 (16 columns, with derivatives) or 2 (4 columns, potential)
template <int kStreams>
struct Synth : Rings<kRings> {
  static constexpr int kVec = kStreams == 8 ? 3 : 1;  // float4 per degree
  // degrees between two votes: 16 for the 4 columns; 8 for the 16, whose
  // 16-degree group took 129 registers and ran slower
  static constexpr int kGroup = kStreams == 8 ? 8 : 16;

  float acc[2][kRings][kStreams];  // [(l - m) mod 2][ring][stream]

  // s: the degree's staged float4s; P = (l - m) mod 2
  template <int P>
  __device__ __forceinline__ void emit(const float4* s,
                                       const float (&lam)[kRings],
                                       const float (&)[kRings]) {
    const float4 s0 = s[0];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      acc[P][q][0] += s0.z * lam[q];
      acc[P][q][1] += s0.w * lam[q];
    }
    if constexpr (kStreams == 8) {
      const float4 s1 = s[1];
      const float4 s2 = s[2];
#pragma unroll
      for (int q = 0; q < kRings; ++q) {
        acc[P][q][2] += s1.x * lam[q];
        acc[P][q][3] += s1.y * lam[q];
        acc[P][q][4] += s1.z * lam[q];
        acc[P][q][5] += s1.w * lam[q];
        acc[P][q][6] += s2.x * lam[q];
        acc[P][q][7] += s2.y * lam[q];
      }
    }
  }

  __device__ __forceinline__ void emit_zero(const float4*) {}
};

// kRowOffset: the rows start at m0 > 0 (a rank's block of m rows); without
// it m is blockIdx.y, the one-device code: the runtime offset takes the
// 16-column form from 126 to 129 registers, 3 blocks per SM instead of 4
// and 5 % longer (chip_smoke.py phase 6 on an H100)
template <int kStreams, bool kRowOffset>
__global__ void __launch_bounds__(kThreads)
legendre_synth_kernel(const float* __restrict__ a_re,  // [nm, nl]
                      const float* __restrict__ a_im,
                      const float* __restrict__ h_re,  // unused for 2 streams
                      const float* __restrict__ h_im,
                      const float* __restrict__ cth,
                      const float* __restrict__ ln_sth,
                      const float* __restrict__ logc,
                      const int* __restrict__ mcut,  // [ceil(J / kTileJ)]
                      float* __restrict__ out,       // [nm, 2 kStreams, J]
                      int nl, int J, int m0) {
  using S = Synth<kStreams>;
  constexpr int kVec = S::kVec;
  __shared__ float4 sh[kChunkL][kVec];

  const int mr = blockIdx.y;  // input and output row; m = m0 + mr
  const int m = kRowOffset ? m0 + mr : mr;
  const SynthTile w = calclens::synth_tile<kWarps, kTileJ>(mcut, m, nl, J);
  const float mf = static_cast<float>(m);
  const size_t arow = static_cast<size_t>(mr) * nl;
  S s;
  float sv[kRings];
  int sk[kRings];
#pragma unroll
  for (int q = 0; q < kRings; ++q) {
    const int j = w.j0 + 32 * q;
    s.c[q] = 0.0f;
    sv[q] = 0.0f;
    sk[q] = 0;
    if (w.active && j < J) {
      s.c[q] = cth[j];
      diag_seed(logc[mr], mf, ln_sth[j], sv[q], sk[q]);
    }
#pragma unroll
    for (int i = 0; i < kStreams; ++i) {
      s.acc[0][q][i] = s.acc[1][q][i] = 0.0f;
    }
  }

  calclens::synth_sweep<S::kGroup, kVec>(
      s, sh, m, nl, w, sv, sk, [&](int l, float4 (&d)[kVec]) {
        float4 v0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v1 = v0, v2 = v0;
        if (l < nl) {
          const float lf = static_cast<float>(l);
          float ca, cb;
          coeffs(lf, mf, ca, cb);
          const float ar = a_re[arow + l], ai = a_im[arow + l];
          v0 = make_float4(ca, cb, ar, ai);
          if constexpr (kStreams == 8) {
            const float l2 = __fmul_rn(lf, lf + 1.0f);
            v1 = make_float4(__fmul_rn(ar, lf), __fmul_rn(ai, lf),
                             h_re[arow + l], h_im[arow + l]);
            v2 = make_float4(__fmul_rn(ar, l2), __fmul_rn(ai, l2), 0.0f,
                             0.0f);
          }
        }
        d[0] = v0;
        if constexpr (kStreams == 8) {
          d[1] = v1;
          d[2] = v2;
        }
      });

  // even-l sums are the (l - m)-even ones for even m, the odd ones for odd
  // m; a warp beyond its cutoff writes its zeros
  const bool m_odd = (m & 1) != 0;
  float* o = out + static_cast<size_t>(mr) * (2 * kStreams) * J;
#pragma unroll
  for (int q = 0; q < kRings; ++q) {
    const int j = w.j0 + 32 * q;
    if (j >= J) continue;
#pragma unroll
    for (int i = 0; i < kStreams; ++i) {
      const float e = s.acc[0][q][i], d = s.acc[1][q][i];
      o[static_cast<size_t>(i) * J + j] = e + d;
      o[static_cast<size_t>(i + kStreams) * J + j] = m_odd ? d - e : e - d;
    }
  }
}

template <int kStreams>
int launch(const float* a_re, const float* a_im, const float* h_re,
           const float* h_im, const float* cth, const float* ln_sth,
           const float* logc, const int* mcut, float* out, int nl, int nm,
           int J, int m0, void* stream) {
  const dim3 grid((J + kBlockJ - 1) / kBlockJ, nm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m0 != 0) {
    legendre_synth_kernel<kStreams, true><<<grid, kThreads, 0, s>>>(
        a_re, a_im, h_re, h_im, cth, ln_sth, logc, mcut, out, nl, J, m0);
  } else {
    legendre_synth_kernel<kStreams, false><<<grid, kThreads, 0, s>>>(
        a_re, a_im, h_re, h_im, cth, ln_sth, logc, mcut, out, nl, J, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Streams a_re, a_im, h_re, h_im [nm, nl] (TRANSPOSED alm) of the m rows
// m0 .. m0 + nm - 1; cth, ln_sth [J]; logc [nm] (of those rows); mcut [ceil(J / 128)] int32; out [nm, 16, J].  Returns
// cudaGetLastError() after the launch.
extern "C" int legendre_synth_launch(
    const float* a_re, const float* a_im, const float* h_re, const float* h_im,
    const float* cth, const float* ln_sth, const float* logc, const int* mcut,
    float* out, int nl, int nm, int J, int m0, void* stream) {
  return launch<8>(a_re, a_im, h_re, h_im, cth, ln_sth, logc, mcut, out, nl,
                   nm, J, m0, stream);
}

// The potential alone: a_re, a_im [nm, nl]; out [nm, 4, J] = {a_re, a_im}
// summed with weight 1, then with (-1)^l.
extern "C" int legendre_synth_phi_launch(
    const float* a_re, const float* a_im, const float* cth,
    const float* ln_sth, const float* logc, const int* mcut, float* out,
    int nl, int nm, int J, int m0, void* stream) {
  return launch<2>(a_re, a_im, nullptr, nullptr, cth, ln_sth, logc, mcut,
                   out, nl, nm, J, m0, stream);
}

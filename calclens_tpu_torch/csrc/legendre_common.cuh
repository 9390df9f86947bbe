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

// ---------------------------------------------------------------------------
// The sweep of K1-K4 over the degrees, on top of the steps above.  A kernel
// derives its per-thread state from Rings<R> and supplies only what it does
// with one degree's lambda:
//
//   template <int P> void emit(Out o, const float (&lam)[R],
//                              const float (&lam_prev)[R]);
//   void emit_zero(Out o);  // the zero mode: every lambda is 0
//
// P = (l - m) mod 2, lam and lam_prev are lambda_l and lambda_{l-1} of its
// rings, and Out addresses the degree: K2 and K3 get the degree's staged
// inputs, K1 and K4 its output row.  K2 and K3 run synth_sweep, K1 and K4
// analysis_sweep.
// ---------------------------------------------------------------------------

template <int R>
struct Rings {
  static constexpr int kR = R;
  float c[R], pp[R], pc[R], cf[R];  // cos theta; recurrence state and scale
  int k[R];
};

template <Mode M>
struct ModeTag {
  static constexpr Mode value = M;
};

// One degree with coefficients (a, b) in mode M: the recurrence, then its
// lambda_l and lambda_{l-1} to emit<P>: pc and pp themselves in the steady
// mode (cf == 1, so both are exact), both times cf after the rescale test in
// the careful mode; emit_zero in the zero mode.
template <int P, Mode M, class S, class Out>
__device__ __forceinline__ void sweep_degree(S& s, float a, float b, Out o) {
  rec_step(a, b, s.c, s.pp, s.pc);
  if constexpr (M == Mode::kSteady) {
    s.template emit<P>(o, s.pc, s.pp);
  } else {
    rescale_rings(s.pp, s.pc, s.k, s.cf);
    if constexpr (M == Mode::kCareful) {
      float lam[S::kR], lam_prev[S::kR];
#pragma unroll
      for (int q = 0; q < S::kR; ++q) {
        lam[q] = __fmul_rn(s.pc[q], s.cf[q]);
        lam_prev[q] = __fmul_rn(s.pp[q], s.cf[q]);
      }
      s.template emit<P>(o, lam, lam_prev);
    } else {
      s.emit_zero(o);
    }
  }
}

// The seed row l == m from the diagonal seeds (sv, sk): lambda_mm to
// emit<0>, with lambda_{m-1,m} = pp = 0.
template <class S, class Out>
__device__ __forceinline__ void sweep_seed(S& s, const float (&sv)[S::kR],
                                           const int (&sk)[S::kR], Out o) {
  float lam[S::kR];
  seed_rings(sv, sk, s.pp, s.pc, s.k, s.cf, lam);
  s.template emit<0>(o, lam, s.pp);
}

// Runs group(ModeTag<mode>) in the warp's mode, then votes the next one; a
// steady warp stays steady (k only grows, and is 0 on every ring).  Returns
// false when the group ran in the zero mode.
template <class S, class Group>
__device__ __forceinline__ bool vote_group(const S& s, Mode& mode,
                                           Group&& group) {
  if (mode == Mode::kSteady) {
    group(ModeTag<Mode::kSteady>{});
    return true;
  }
  const bool zero = mode == Mode::kZero;
  if (zero) {
    group(ModeTag<Mode::kZero>{});
  } else {
    group(ModeTag<Mode::kCareful>{});
  }
  mode = warp_mode(s.cf);
  return !zero;
}

// --- K2 and K3: a block is one m times kWarps warps of 32 R consecutive
// rings (a warp's ring tile, the unit of the m cutoff); it stages kChunk
// degrees at a time, V float4 per degree, the first float4 (a, b, ., .).

// Degrees i .. i + G - 1 of the staged chunk sh in mode M, unrolled by 2
// (i even, so degree i has P = 0); with kSeed degree i is the seed row.
template <int G, int V, Mode M, bool kSeed, class S>
__device__ __forceinline__ void synth_group(S& s, const float4* sh, int i,
                                            const float (&sv)[S::kR],
                                            const int (&sk)[S::kR]) {
  const float4* g = sh + i * V;
#pragma unroll
  for (int u = 0; u < G; u += 2) {
    const float4* d0 = g + u * V;
    const float4* d1 = d0 + V;
    // both degrees' coefficients first: on the H100 that made K2's
    // 4-column form 2 % faster (fewer register copies in its careful
    // degrees) and K3's potential-only form 3 % slower than with each load
    // beside its degree; the other sweeps moved by less than 1 %
    const float4 ab0 = d0[0], ab1 = d1[0];
    if (kSeed && u == 0) {
      sweep_seed(s, sv, sk, d0);
    } else {
      sweep_degree<0, M>(s, ab0.x, ab0.y, d0);
    }
    sweep_degree<1, M>(s, ab1.x, ab1.y, d1);
  }
}

// The warp's tile of a block of K2 or K3: ring q of the thread is
// j0 + 32 q; a warp is active if its tile holds rings and lies below its
// cutoff mcut[tile]; a block with no active warp stages nothing (l_end = m)
// and its warps write their zeros.
struct SynthTile {
  int tile, j0, l_end;
  bool active;
};

template <int kWarps, int kTileJ>
__device__ __forceinline__ SynthTile synth_tile(const int* mcut, int m,
                                                int nl, int J) {
  SynthTile w;
  const int lane = threadIdx.x & 31;
  w.tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  w.j0 = w.tile * kTileJ + lane;
  w.active = w.j0 - lane < J && m < mcut[w.tile];
  w.l_end = __syncthreads_or(w.active) ? nl : m;
  return w;
}

// The sweep of degrees m .. nl - 1: per chunk, thread t stages degree
// l0 + t by stage(l, sh[t]) (l may pass nl: it stages zeros, so the last
// chunk is padded to whole groups), then an active warp runs the chunk in
// groups of G: the seed group first, then a vote after each group that was
// not steady.
template <int G, int V, int kChunk, class S, class Stage>
__device__ __forceinline__ void synth_sweep(S& s, float4 (&sh)[kChunk][V],
                                            int m, int nl,
                                            const SynthTile& w,
                                            const float (&sv)[S::kR],
                                            const int (&sk)[S::kR],
                                            Stage&& stage) {
  const int t = threadIdx.x;
  Mode mode = Mode::kCareful;
  for (int l0 = m; l0 < w.l_end; l0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    stage(l0 + t, sh[t]);
    __syncthreads();
    if (!w.active) continue;  // warp-uniform
    const float4* c = &sh[0][0];
    const int nc = min(kChunk, nl - l0);
    int i = 0;
    if (l0 == m) {
      synth_group<G, V, Mode::kCareful, true>(s, c, 0, sv, sk);
      mode = warp_mode(s.cf);
      i = G;
    }
    for (; i < nc; i += G) {
      vote_group(s, mode, [&](auto tag) {
        synth_group<G, V, decltype(tag)::value, false>(s, c, i, sv, sk);
      });
    }
  }
}

// --- K1 and K4: a block is one m times a ring tile; the recurrence
// coefficients of kChunk degrees are staged once per chunk, and degree
// i + u of a group of G emits into rows + u * kStride.

// Degrees i .. i + G - 1 in mode M with coefficient pairs coef2[i / 2 ..]
// (two degrees per float4), unrolled by 2; with kSeed degree i is the seed
// row.
template <int G, int kStride, Mode M, bool kSeed, class S>
__device__ __forceinline__ void analysis_group(S& s, const float4* coef2,
                                               int i, float* rows,
                                               const float (&sv)[S::kR],
                                               const int (&sk)[S::kR]) {
#pragma unroll
  for (int u = 0; u < G; u += 2) {
    const float4 ab = coef2[(i + u) / 2];  // degrees i + u, i + u + 1
    if (kSeed && u == 0) {
      sweep_seed(s, sv, sk, rows);
    } else {
      sweep_degree<0, M>(s, ab.x, ab.y, rows + u * kStride);
    }
    sweep_degree<1, M>(s, ab.z, ab.w, rows + (u + 1) * kStride);
  }
}

// The sweep of degrees m .. nl - 1 for degree m's block: per chunk the
// coefficients (thread t stages degree l0 + t, zeros past nl), then groups
// of G degrees, each emitting into rows() and followed by
// after(first degree of the group, stored), stored being false when the
// group ran in the zero mode.  after may hold barriers: every warp of the
// block runs every group.
template <int G, int kStride, int kChunk, class S, class Rows, class After>
__device__ __forceinline__ void analysis_sweep(S& s, float2 (&coef)[kChunk],
                                               int m, int nl,
                                               const float (&sv)[S::kR],
                                               const int (&sk)[S::kR],
                                               Rows&& rows, After&& after) {
  const int t = threadIdx.x;
  const float mf = static_cast<float>(m);
  Mode mode = Mode::kCareful;
  for (int l0 = m; l0 < nl; l0 += kChunk) {
    __syncthreads();  // the previous chunk's coefficient readers are done
    {
      const int l = l0 + t;
      float a = 0.0f, b = 0.0f;
      if (l < nl) coeffs(static_cast<float>(l), mf, a, b);
      coef[t] = make_float2(a, b);
    }
    __syncthreads();
    const float4* coef2 = reinterpret_cast<const float4*>(coef);
    const int nc = min(kChunk, nl - l0);
    for (int i = 0; i < nc; i += G) {
      float* r = rows();
      bool stored = true;
      if (l0 == m && i == 0) {
        analysis_group<G, kStride, Mode::kCareful, true>(s, coef2, 0, r, sv,
                                                         sk);
        mode = warp_mode(s.cf);
      } else {
        stored = vote_group(s, mode, [&](auto tag) {
          analysis_group<G, kStride, decltype(tag)::value, false>(
              s, coef2, i, r, sv, sk);
        });
      }
      after(l0 + i, stored);
    }
  }
}

}  // namespace calclens

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
//    (legendre_chain_seed_kernel, below) writes the (value, counter) pair
//    of every m, [nm, J], which the main kernel reads for its seed row,
//    instead of every (m, ring) thread walking the chain through l < m
//    alone;
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

#include <algorithm>

#include "legendre_common.cuh"
#include "launch_util.cuh"

namespace {

using calclens::chain_factor;
using calclens::chain_step;
using calclens::coeffs;
using calclens::kY00;
using calclens::num_sms;
using calclens::Rings;
using calclens::SynthTile;

constexpr int kRings = 4;                 // rings per thread
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileJ = 32 * kRings;       // rings per warp: the mcut tile
constexpr int kBlockJ = kWarps * kTileJ;  // rings per block
constexpr int kChunkL = kThreads;         // degrees per shared chunk

// ---------------------------------------------------------------------------
// the seed pre-pass
// ---------------------------------------------------------------------------
//
// What bounds it on the H100: device memory.  It writes nm J (value,
// counter) pairs, 805 MB at order 12, 0.240 ms at 3.35 TB/s.  What stands in
// the way: the chain is a sequence of nm dependent steps per ring pair (each
// rounds its predecessor, so no scan in another order gives the twin's
// bits), and there are only J ring pairs: one thread per ring walking and
// storing (the first design) keeps a few warps on an SM, each writing 128
// bytes per row 4 J bytes apart, too few stores in flight for the card's
// memory rate.
//
// Design: one launch, two roles, handed out by a ticket counter.
//  - Producers (the first ceil(J / 128) tickets; one warp per 32 ring pairs)
//    walk the chain without storing it and publish (value, counter) every
//    kSeedSeg degrees: a checkpoint row, then a per-warp count behind a
//    fence.  They walk ScaledChain, whose dependent path per degree is two
//    multiplications, where chain_step's is four (multiply, multiply,
//    compare, rescale); the producers' walk is the longer of the two roles.
//  - Consumers (the rest, segment by segment) each take kSeedSeg degrees of
//    128 ring pairs: each warp waits until its producer warp has published
//    the segment's checkpoint, then re-walks those degrees from it with
//    chain_step and writes the rows with streaming stores.  All SMs write.
//  - A consumer only waits on a producer that took an earlier ticket, so is
//    already running: the waits cannot deadlock.  The grid is persistent,
//    kSeedBlocksPerSM blocks per SM: more resident consumers, waiting and
//    polling beside the producers, slow the producers' walk (the variants
//    "seed plain-chain producers", "seed 4 blocks per SM" and "seed 16
//    blocks per SM" of tools/legendre_variants.py time these choices).
//  - Rings with sin theta outside [2^-40, 1] (none on a HEALPix grid) take
//    the plain chain in their producer warp.

constexpr int kSeedThreads = 128;  // 4 warps of 32 ring pairs
constexpr int kSeedWarps = kSeedThreads / 32;
constexpr int kSeedSeg = 256;      // degrees per checkpoint segment
constexpr int kSeedBlocksPerSM = 2;
constexpr int kSeedSpins = 1 << 22;  // polls of ~1 us before a wait traps
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSeedSeg % 32 == 0, "a segment is whole 32-degree chunks");

// The chain as the twin walks it.
struct PlainChain {
  float v = kY00;
  int k = 0;
  __device__ __forceinline__ void step(float s, float f) {
    chain_step(s, f, v, k);
  }
  __device__ __forceinline__ float value() const { return v; }
  __device__ __forceinline__ int counter() const { return k; }
};

__device__ __forceinline__ int biased_exp(float x) {
  return __float_as_int(x) >> 23;
}

__device__ __forceinline__ float pow2(int y) {
  return __int_as_float((y + 127) << 23);
}

__device__ __forceinline__ bool scaled_ok(float s) {
  return s >= 0x1p-40f && s <= 1.0f;
}

// The same chain, bit for bit for 2^-40 <= s <= 1, with the rescale off its
// dependent path.  Let v be the chain without rescales (v = value
// 2^(-64 c), c = -counter).  ScaledChain carries w = v 2^Y, Y the sum of
// the shifts y applied so far, and steps w <- (w (s 2^y)) f: each product
// is the twin's times a power of two, both in the normal range, so it
// rounds alike.  y is set from the exponent of w two steps back (the
// predictor round(3 log2 s) covers the three steps since), which keeps w
// within [2^-1, 2^3].  v falls by less than 2^-41 per step, so the twin
// rescales exactly when v first falls below 2^(-64 (c + 1)):
// c = max over the steps so far of floor((-E(v) - 1) / 64), with the
// exponent E(v) = E(w) - Y, an integer running max beside the chain.  The
// value is w 2^(64 c - Y), assembled on its exponent bits.
struct ScaledChain {
  float w;
  int Y, c;
  int e2, e1;  // biased exponents of w two steps and one step back
  int y2, y1;  // the shifts of those steps
  int c0;      // 127 - round(3 log2 s)
  __device__ __forceinline__ explicit ScaledChain(float s)
      : w(kY00), Y(0), c(0) {
    const float l2 = __log2f(s);
    const int d1 = __float2int_rn(l2), d2 = __float2int_rn(2.0f * l2),
              d3 = __float2int_rn(3.0f * l2);
    c0 = 127 - d3;
    e2 = e1 = biased_exp(w);
    // a history under which the first two shifts predict one and two steps
    y1 = d2 - d3;
    y2 = d1 - d2;
  }
  __device__ __forceinline__ void step(float s, float f) {
    const int y = c0 - e2 - y2 - y1;
    const float wn = __fmul_rn(__fmul_rn(w, __fmul_rn(s, pow2(y))), f);
    Y += y;
    c = max(c, (Y + 126 - biased_exp(wn)) >> 6);
    e2 = e1;
    e1 = biased_exp(w);
    y2 = y1;
    y1 = y;
    w = wn;
  }
  __device__ __forceinline__ float value() const {
    return __int_as_float(__float_as_int(w) + ((64 * c - Y) << 23));
  }
  __device__ __forceinline__ int counter() const { return -c; }
};

// A producer warp: ring pair j of the lane, flag counts its checkpoints.
template <class Chain>
__device__ __forceinline__ void seed_produce(Chain ch, float s, int lane,
                                             bool live, int j,
                                             float* __restrict__ ck,
                                             int* __restrict__ ckk,
                                             int* flag, int nm, int J) {
  for (int l0 = 0; l0 < nm; l0 += 32) {
    if (l0 % kSeedSeg == 0) {
      const size_t o = static_cast<size_t>(l0 / kSeedSeg) * J + j;
      if (live) {
        ck[o] = ch.value();
        ckk[o] = ch.counter();
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicExch(flag, l0 / kSeedSeg + 1);
    }
    const float f = chain_factor(static_cast<float>(l0 + lane));
#pragma unroll
    for (int i = 0; i < 32; ++i) ch.step(s, __shfl_sync(kFull, f, i));
  }
}

// A consumer warp: degrees [g kSeedSeg, (g + 1) kSeedSeg) of its ring pairs.
__device__ __forceinline__ void seed_fill(int g, int lane, bool live, int j,
                                          const float* __restrict__ sth,
                                          const float* ck, const int* ckk,
                                          const int* flag,
                                          float* __restrict__ seed,
                                          int* __restrict__ seed_k, int nm,
                                          int J) {
  if (lane == 0) {
    const volatile int* published = flag;
    for (int spin = 0; *published <= g; ++spin) {
      if (spin == kSeedSpins) __trap();
      __nanosleep(1000);
    }
    __threadfence();
  }
  __syncwarp();
  const size_t o = static_cast<size_t>(g) * J + j;
  const float s = live ? sth[j] : 0.0f;
  PlainChain ch;
  if (live) {
    ch.v = __ldcg(ck + o);  // written by another block: read from L2
    ch.k = __ldcg(ckk + o);
  }
  const int m0 = g * kSeedSeg, m1 = min(nm, m0 + kSeedSeg);
  float* p = seed + static_cast<size_t>(m0) * J + j;
  int* q = seed_k + static_cast<size_t>(m0) * J + j;
  for (int l0 = m0; l0 < m1; l0 += 32) {
    const float f = chain_factor(static_cast<float>(l0 + lane));
    const int nc = min(32, m1 - l0);
#pragma unroll 8
    for (int i = 0; i < nc; ++i) {
      if (live) {
        __stcs(p, ch.v);
        __stcs(q, ch.k);
      }
      p += J;
      q += J;
      ch.step(s, __shfl_sync(kFull, f, i));
    }
  }
}

// sync [1 + ceil(J / 32)], zero at launch: the ticket counter, then each
// ring warp's published checkpoints; ck, ckk [ceil(nm / kSeedSeg), J].
__global__ void __launch_bounds__(kSeedThreads)
legendre_chain_seed_kernel(const float* __restrict__ sth,
                           float* __restrict__ seed,  // [nm, J]
                           int* __restrict__ seed_k,  // [nm, J]
                           float* ck, int* ckk, int* sync, int nm, int J) {
  __shared__ int ticket;
  const int t = threadIdx.x, lane = t & 31;
  const int producers = (J + kSeedThreads - 1) / kSeedThreads;
  const int tickets =
      producers * (1 + (nm + kSeedSeg - 1) / kSeedSeg);
  for (;;) {
    __syncthreads();  // every warp has read the previous ticket
    if (t == 0) ticket = atomicAdd(sync, 1);
    __syncthreads();
    const int id = ticket;
    if (id >= tickets) return;
    const int tile = id < producers ? id : (id - producers) % producers;
    const int rw = tile * kSeedWarps + (t >> 5);  // ring warp
    if (rw * 32 >= J) continue;  // no ring pair: nothing to publish or fill
    const int j = rw * 32 + lane;
    const bool live = j < J;
    if (id < producers) {
      const float s = live ? sth[j] : 1.0f;
      if (__all_sync(kFull, scaled_ok(s))) {
        seed_produce(ScaledChain(s), s, lane, live, j, ck, ckk,
                     sync + 1 + rw, nm, J);
      } else {
        seed_produce(PlainChain(), s, lane, live, j, ck, ckk, sync + 1 + rw,
                     nm, J);
      }
    } else {
      seed_fill((id - producers) / producers, lane, live, j, sth, ck, ckk,
                sync + 1 + rw, seed, seed_k, nm, J);
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
                          int nl, int J, int m0) {
  using S = Vpu<kAcc>;
  constexpr int kVec = S::kVec;
  __shared__ float4 sh[kChunkL][kVec];

  const int mr = blockIdx.y;  // input and output row; m = m0 + mr
  const int m = m0 + mr;
  const SynthTile w = calclens::synth_tile<kWarps, kTileJ>(mcut, m, nl, J);
  const float mf = static_cast<float>(m);
  const size_t arow = static_cast<size_t>(mr) * nl;
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
      const size_t o = static_cast<size_t>(mr) * J + j;
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
          v0 = make_float4(ca, cb, a_re[arow + l], a_im[arow + l]);
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
  float* o = out + static_cast<size_t>(mr) * (2 * kAcc) * J;
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
// the chain (value and scale counter).  scratch: at least
// 1 + ceil(J / 32) + 2 ceil(nm / kSeedSeg) J int32 (the head is zeroed
// here).
// Returns cudaGetLastError().
extern "C" int legendre_chain_seed_launch(const float* sth, float* seed,
                                          int* seed_k, int* scratch,
                                          long long scratch_ints, int nm,
                                          int J, void* stream) {
  const long long head = 1 + (J + 31) / 32;
  const long long nseg = (nm + kSeedSeg - 1) / kSeedSeg;
  if (nm <= 0 || J <= 0 || scratch_ints < head + 2 * nseg * J) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * head, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long producers = (J + kSeedThreads - 1) / kSeedThreads;
  const int blocks = static_cast<int>(
      std::min<long long>(producers * (1 + nseg),
                          kSeedBlocksPerSM * num_sms()));
  legendre_chain_seed_kernel<<<blocks, kSeedThreads, 0, s>>>(
      sth, seed, seed_k, reinterpret_cast<float*>(scratch + head),
      scratch + head + nseg * J, scratch, nm, J);
  return static_cast<int>(cudaGetLastError());
}

// a_re, a_im [nm, nl] (TRANSPOSED alm) of the m rows m0 .. m0 + nm - 1;
// cth, cot, inv_sth [J]; seed, seed_k [nm, J] of those rows (rows m0 ..
// of legendre_chain_seed_launch's output); mcut [ceil(J / 128)] int32; out
// [nm, 12, J] with derivatives, [nm, 4, J] without (column 2 s + p for
// slot s, l parity p).  Returns cudaGetLastError() after the launch.
extern "C" int legendre_synth_vpu_launch(
    const float* a_re, const float* a_im, const float* cth, const float* cot,
    const float* inv_sth, const float* seed, const int* seed_k,
    const int* mcut, float* out, int nl, int nm, int J, int derivs, int m0,
    void* stream) {
  const dim3 grid((J + kBlockJ - 1) / kBlockJ, nm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (derivs) {
    legendre_synth_vpu_kernel<6><<<grid, kThreads, 0, s>>>(
        a_re, a_im, cth, cot, inv_sth, seed, seed_k, mcut, out, nl, J, m0);
  } else {
    legendre_synth_vpu_kernel<2><<<grid, kThreads, 0, s>>>(
        a_re, a_im, cth, cot, inv_sth, seed, seed_k, mcut, out, nl, J, m0);
  }
  return static_cast<int>(cudaGetLastError());
}

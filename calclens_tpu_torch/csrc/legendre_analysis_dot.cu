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
// contracted it on the MXU at HIGHEST precision; here a block is one m row
// and walks its 512-ring tiles in order, and in each tile each warp stores
// 16 degrees of its 128 rings and contracts them on the tensor cores.
//
// What bounds it on the H100: instruction issue on the CUDA cores.  Per
// (l, m, j) element the recurrence costs 4 rounded operations there (no
// FMA, as the twin rounds them); the 2 products (re, im) run on the
// tensor cores, where even 3 TF32 products each take about a third of the
// recurrence's time at the card's peaks.  The route adds the store of
// lambda, its load and its split for the tensor cores on the CUDA cores.
// E and O are read once and alm is written once, so device memory does
// not bound it.
//
// Design:
//  - the store phase is K1's sweep (legendre_common.cuh's analysis_sweep,
//    which this file gives its store and contraction): each thread carries
//    the recurrence of 4 rings, the recurrence coefficients of 128 degrees
//    are computed once per block into shared memory, the seed row l == m is
//    peeled off the loop, and a warp runs each group of 16 degrees in one
//    of three modes chosen by a vote (legendre_common.cuh): the recurrence
//    alone while every ring's lambda is 0 (nothing is stored or
//    contracted), the careful recurrence, and once all its rings are at
//    k == 0 the bare one.  A thread stores its 4 rings' lambda of a degree
//    as one float4;
//  - the contraction runs on the tensor cores: mma.sync m16n8k8 with TF32
//    operands, 16 degrees x 8 rings times 8 rings x 8 columns, the columns
//    being the four sources (S0, S1) x (re, im) split into a TF32 high part
//    and the rest.  lambda is split the same way and each of its parts is
//    multiplied into a sum of its own, so the four products hi.hi, hi.lo,
//    lo.hi and lo.lo keep each product to 2^-21 (the TPU's 6-pass HIGHEST
//    does the same with bf16 parts; plain TF32 would lose ~3 digits).  A
//    warp contracts only the 128 rings that it stored itself, so store and
//    contraction are separated by __syncwarp alone, and the sources'
//    fragments are built once per block and kept in registers.  The same
//    tile contracted in FP32 FMAs on the CUDA cores (a row of
//    tools/legendre_variants.py) was 6 % slower;
//  - each degree keeps the pair of its l parity; the four warps' partial
//    sums of a block of degrees meet in shared memory (one barrier per 16
//    degrees), and the 512-ring tiles of a degree are combined in a fixed
//    order, as in K1: tile by tile, one thread per (degree, re or im) adds
//    the tile's sum to the alm element, which no other block touches.  So
//    alm is the same bits on every run, and a row's bits depend only on
//    that row's inputs, not on the launch's m0 or nm.  The rows run
//    longest first.

#include <cuda_runtime.h>

#include <cstdint>

#include "legendre_common.cuh"

namespace {

using calclens::diag_seed;
using calclens::Rings;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRings = 4;                   // rings per thread
constexpr int kWarpJ = 32 * kRings;         // rings a warp stores
constexpr int kTileJ = kWarps * kWarpJ;     // 512 rings: the mcut tile
constexpr int kChunkL = kThreads;           // degrees per coefficient chunk
constexpr int kBlockL = 16;  // degrees per contraction and per vote
// floats per stored degree row: 128 rings + 16, so that the float4 reads of
// rows g and g + 1 in a quarter-warp hit distinct banks
constexpr int kRow = kWarpJ + 16;

// x = hi + lo to 2^-21 of x, both TF32 operands of mma: hi is x rounded
// to 10 mantissa bits (to nearest, ties away: add half a unit to the bits,
// clear the 13 below), lo = x - hi exactly, |lo| <= 2^-11 |x|.  The tensor
// cores read the top 19 bits of an operand, so lo enters truncated, within
// 2^-10 of itself.  Three instructions per value; on sm_90
// cvt.rna.tf32.f32 becomes four (with a test for infinities that lambda
// never holds).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b for one m16n8k8 TF32 tile, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a thread stores its 4 rings' lambda of a degree as one float4
struct Store : Rings<kRings> {
  template <int P>
  __device__ __forceinline__ void emit(float* row, const float (&lam)[kRings],
                                       const float (&)[kRings]) {
    *reinterpret_cast<float4*>(row) =
        make_float4(lam[0], lam[1], lam[2], lam[3]);
  }

  // every lambda is 0: nothing is stored or contracted
  __device__ __forceinline__ void emit_zero(float*) {}
};

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
                             int nl, int J, int m0) {
  const int mr = blockIdx.x;  // input and output row; m = m0 + mr
  const int m = m0 + mr;

  __shared__ __align__(16) float2 coef[kChunkL];  // (a, b) per degree
  __shared__ __align__(16) float lam_s[kWarps][kBlockL][kRow];
  __shared__ float2 part[2][kWarps][kBlockL];  // per-warp (re, im) sums

  const int t = threadIdx.x;
  const int w = t >> 5;
  const int lane = t & 31;
  const float mf = static_cast<float>(m);
  const bool m_even = (m & 1) == 0;
  const size_t mrow = static_cast<size_t>(mr) * J;
  // thread t < 2 kBlockL combines degree t / 2 of a block, re (t even) or
  // im (t odd), into this element of the row
  float* const row = ((t & 1) ? alm_im : alm_re) + static_cast<size_t>(mr) * nl;

  const int ntiles = (J + kTileJ - 1) / kTileJ;
  for (int jt = 0; jt < ntiles; ++jt) {
    if (m >= mcut[jt]) continue;  // whole (m, tile) below f32 significance
    const int jw = jt * kTileJ + w * kWarpJ;  // the warp's first ring

    // ring q of a thread: jw + 32 q + lane, stored at column 4 lane + q
    Store s;
    float sv[kRings];
    int sk[kRings];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      const int j = jw + 32 * q + lane;
      s.c[q] = 0.0f;
      sv[q] = 0.0f;
      sk[q] = 0;
      if (j < J) {
        s.c[q] = cth[j];
        diag_seed(logc[mr], mf, ln_sth[j], sv[q], sk[q]);
      }
    }

    // the sources at column v = 4 p' + q of the warp's rows: ring
    // jw + 32 q + p'.  The B fragment of k-step 2p + h (rows kk = tig,
    // tig + 4 of the 8-ring step) is columns 16 p + 4 tig + 2 h + (0, 1);
    // column n = g of B is source g & 3 (S0 re, S0 im, S1 re, S1 im), its
    // high part for g < 4 and its low part for g >= 4.
    const int g = lane >> 2, tig = lane & 3;
    uint32_t bf[8][4];
    {
      const float* s0r = m_even ? ere : ore;
      const float* s0i = m_even ? eim : oim;
      const float* s1r = m_even ? ore : ere;
      const float* s1i = m_even ? oim : eim;
      const float* src = (g & 3) == 0 ? s0r : (g & 3) == 1 ? s0i
                         : (g & 3) == 2 ? s1r : s1i;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
#pragma unroll
        for (int q = 0; q < kRings; ++q) {
          const int j = jw + 32 * q + 4 * p + tig;
          const float x = j < J ? src[mrow + j] : 0.0f;
          uint32_t hi, lo;
          split(x, hi, lo);
          bf[p][q] = g < 4 ? hi : lo;
        }
      }
    }

    int buf = 0;
    calclens::analysis_sweep<kBlockL, kRow>(
        s, coef, m, nl, sv, sk, [&] { return &lam_s[w][0][4 * lane]; },
        [&](int lb, bool stored) {
          // this thread's alm element of the block, read before the
          // barriers so that its latency overlaps the contraction
          const int l = lb + (t >> 1);
          const bool mine = t < 2 * kBlockL && l < nl;
          const float old = mine ? row[l] : 0.0f;
          __syncwarp();  // the warp's lambda of these 16 degrees is stored
          if (!stored) {
            if (lane < kBlockL) part[buf][w][lane] = make_float2(0.0f, 0.0f);
          } else {
            // the 16 degrees' sums over the warp's rings, lambda's high and
            // low parts in two sums: two independent chains
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            const float* r0 = &lam_s[w][g][4 * tig];
            const float* r1 = &lam_s[w][g + 8][4 * tig];
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const float4 x = *reinterpret_cast<const float4*>(r0 + 16 * p);
              const float4 y = *reinterpret_cast<const float4*>(r1 + 16 * p);
              uint32_t ah[4], al[4];
              // k-step 2p: columns (tig, tig + 4) = stored (x, y).(x, y)
              split(x.x, ah[0], al[0]);
              split(y.x, ah[1], al[1]);
              split(x.y, ah[2], al[2]);
              split(y.y, ah[3], al[3]);
              mma_tf32(d, ah, bf[p][0], bf[p][1]);
              mma_tf32(e, al, bf[p][0], bf[p][1]);
              // k-step 2p + 1: stored (x, y).(z, w)
              split(x.z, ah[0], al[0]);
              split(y.z, ah[1], al[1]);
              split(x.w, ah[2], al[2]);
              split(y.w, ah[3], al[3]);
              mma_tf32(d, ah, bf[p][2], bf[p][3]);
              mma_tf32(e, al, bf[p][2], bf[p][3]);
            }
            // d = rows (g, g + 8) x columns (2 tig, 2 tig + 1): tig 0 and 1
            // hold S0 and S1 (re, im) of the high parts, tig 2 and 3 of the
            // low
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              d[c] += e[c];
              d[c] += __shfl_xor_sync(0xffffffffu, d[c], 2);
            }
            // rows g and g + 8 share the parity of degree lb + g
            if (tig == ((lb + g) & 1)) {
              part[buf][w][g] = make_float2(d[0], d[1]);
              part[buf][w][g + 8] = make_float2(d[2], d[3]);
            }
          }
          __syncthreads();  // every warp's partial sums of these degrees are in
          if (mine) {
            const int dg = t >> 1;
            float v = 0.0f;
#pragma unroll
            for (int u = 0; u < kWarps; ++u) {
              const float2 x = part[buf][u][dg];
              v += (t & 1) ? x.y : x.x;
            }
            row[l] = __fadd_rn(old, v);
          }
          buf ^= 1;  // the next partial sums go to the other buffer
        });
  }
}

}  // namespace

// E/O real and imaginary planes [nm, J] of the m rows m0 .. m0 + nm - 1;
// cth, ln_sth [J]; logc [nm] (of those rows);
// mcut [ceil(J / 512)] int32; alm_re/alm_im [nm, nl] (TRANSPOSED, zeroed by
// the caller).  One block per row, row 0 (the longest) first.  Returns
// cudaGetLastError() after the launch.
extern "C" int legendre_analysis_dot_launch(
    const float* ere, const float* eim, const float* ore, const float* oim,
    const float* cth, const float* ln_sth, const float* logc, const int* mcut,
    float* alm_re, float* alm_im, int nl, int nm, int J, int m0,
    void* stream) {
  legendre_analysis_dot_kernel<<<nm, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      ere, eim, ore, oim, cth, ln_sth, logc, mcut, alm_re, alm_im, nl, J,
      m0);
  return static_cast<int>(cudaGetLastError());
}

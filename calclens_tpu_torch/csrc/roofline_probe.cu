// Synthetic ceilings of the Legendre sweep (P1), f32.
//
// Replaces the Pallas TPU kernel tools/roofline_legendre.py::_probe_kernel
// (wrapper _probe).  For rows m = 0 .. rows-1 and rings j = 0 .. TJ-1 it
// sweeps the degrees l = 1 .. LBLK * LB of the bare three-term recurrence
//
//   new = a_lm * (cth_j * pc - b_lm * pp),   pp = 0, pc = 0.5 at the start,
//
// with the coefficients of legendre_common.cuh (computed once per block of
// LB degrees into shared memory, as the TPU hoisted a_blk / b_blk), in four
// modes, templated:
//   rec        the recurrence alone; out[m, j] = the last pc;
//   rec+store  the same, and every degree's value is stored into a
//              shared-memory tile the size of K4's (16 degrees x 512 rings,
//              rows padded to 520 floats, legendre_analysis_dot.cu); out as
//              in rec, read back from the tile after a barrier, so the stores
//              cannot be dropped;
//   store      the stores alone (the constant 0.5); out = tile row 0 = 0.5;
//   dot        FP32 FMA from shared memory, as K4 contracts (no TF32):
//              S[k, i] = i (0.01 k + 1) (k < 16, i < LB) against a tile set
//              to 0.5 once per block, out[m, k, j] summed over the LBLK
//              blocks.  The TPU kernel contracts a scratch that nothing in
//              that mode writes, so its value is undefined there; the tile
//              of 0.5 keeps the mode's work and makes its output defined.
// The point is not a copy of the TPU's tiles but a ceiling for the port's
// own kernels at their own tile shapes: one thread per (m, ring) as in K2,
// the recurrence with the explicitly rounded intrinsics of K1-K4 (so the
// plain version rounds alike), and K4's stored tile.
//
// What bounds it on the H100: by design, the dependent chain of 4 FP32
// operations per (l, m, j) (rec), that chain plus one shared-memory store
// (rec+store), the shared-memory store rate (store), or 16 FMAs per
// element fed from shared memory (dot).  Device memory is touched only for
// the output.
// Design: a block is 512 (m, ring) pairs: 512 / TJ rows of m times TJ
// rings (TJ a power of two, 32 .. 512, so a warp never straddles two rows
// and a coefficient load is a broadcast).  The coefficients of the block's
// rows for LB degrees sit in shared memory; a barrier before and after
// each refill.

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::coeffs;

constexpr int kThreads = 512;          // (m, ring) pairs per block
constexpr int kTileL = 16;             // degrees per stored tile (K4's)
constexpr int kStride = kThreads + 8;  // K4's padded tile row
constexpr int kTileFloats = kTileL * kStride;
constexpr int kDotCols = 16;

enum Mode { kRec = 0, kRecStore = 1, kStore = 2, kDot = 3 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
roofline_probe_kernel(const float* __restrict__ geo,  // [5, TJ]; row 0 cth
                      float* __restrict__ out, int rows, int TJ, int LB,
                      int LBLK) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int R = kThreads / TJ;  // rows of m per block
  const int row0 = blockIdx.x * R;
  const int r = t / TJ;
  const int j = t - r * TJ;
  const int row = row0 + r;
  const bool live = row < rows;

  if constexpr (kMode == kStore) {
    float* tile = smem;
    const float pc = 0.5f;
    int slot = 0;
#pragma unroll 1
    for (int lb = 0; lb < LBLK; ++lb) {
      for (int i = 0; i < LB; ++i) {
        tile[slot * kStride + t] = pc;
        slot = (slot + 1) & (kTileL - 1);
      }
    }
    __syncthreads();
    if (live) out[static_cast<size_t>(row) * TJ + j] = tile[t];
  } else if constexpr (kMode == kDot) {
    float* tile = smem;                      // P [16][kStride], all 0.5
    float* st = smem + kTileFloats;          // S transposed [LB][16]
    for (int s = 0; s < kTileL; ++s) tile[s * kStride + t] = 0.5f;
    for (int q = t; q < LB * kDotCols; q += kThreads) {
      const int i = q / kDotCols;
      const int k = q - i * kDotCols;
      // (0.01 k + 1) in double, rounded once to float, as the TPU's Python
      // constant is
      const float sk = static_cast<float>(0.01 * k + 1.0);
      st[q] = __fmul_rn(static_cast<float>(i), sk);
    }
    __syncthreads();
    float acc[kDotCols];
#pragma unroll
    for (int k = 0; k < kDotCols; ++k) acc[k] = 0.0f;
#pragma unroll 1
    for (int lb = 0; lb < LBLK; ++lb) {
      for (int i = 0; i < LB; ++i) {
        const float p = tile[(i & (kTileL - 1)) * kStride + t];
        const float4* s4 = reinterpret_cast<const float4*>(st + i * kDotCols);
#pragma unroll
        for (int v = 0; v < kDotCols / 4; ++v) {
          const float4 s = s4[v];
          acc[4 * v] = fmaf(s.x, p, acc[4 * v]);
          acc[4 * v + 1] = fmaf(s.y, p, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(s.z, p, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(s.w, p, acc[4 * v + 3]);
        }
      }
    }
    if (live) {
      float* o = out + static_cast<size_t>(row) * kDotCols * TJ + j;
#pragma unroll
      for (int k = 0; k < kDotCols; ++k) o[static_cast<size_t>(k) * TJ] = acc[k];
    }
  } else {
    float* tile = smem;  // rec+store only
    float* ca = smem + (kMode == kRecStore ? kTileFloats : 0);  // [R][LB]
    float* cb = ca + R * LB;
    const float c = geo[j];
    float pp = 0.0f, pc = 0.5f;
    int slot = 0;
#pragma unroll 1
    for (int lb = 0; lb < LBLK; ++lb) {
      __syncthreads();  // the previous block's coefficients are used up
      for (int q = t; q < R * LB; q += kThreads) {
        const int rr = q / LB;
        const int i = q - rr * LB;
        coeffs(static_cast<float>(lb * LB + i + 1),
               static_cast<float>(row0 + rr), ca[q], cb[q]);
      }
      __syncthreads();
      const float* a_r = ca + r * LB;
      const float* b_r = cb + r * LB;
      for (int i = 0; i < LB; ++i) {
        const float nw = __fmul_rn(
            a_r[i], __fsub_rn(__fmul_rn(c, pc), __fmul_rn(b_r[i], pp)));
        if constexpr (kMode == kRecStore) {
          tile[slot * kStride + t] = nw;
          slot = (slot + 1) & (kTileL - 1);
        }
        pp = pc;
        pc = nw;
      }
    }
    if constexpr (kMode == kRecStore) {
      __syncthreads();  // makes every store observable
      pc = tile[((slot + kTileL - 1) & (kTileL - 1)) * kStride + t];
    }
    if (live) out[static_cast<size_t>(row) * TJ + j] = pc;
  }
}

template <int kMode>
int launch(const float* geo, float* out, int rows, int TJ, int LB, int LBLK,
           cudaStream_t stream) {
  const int R = kThreads / TJ;
  size_t smem = 0;
  if (kMode == kRec || kMode == kRecStore) {
    smem += 2 * sizeof(float) * R * LB;
  }
  if (kMode != kRec) smem += sizeof(float) * kTileFloats;
  if (kMode == kDot) smem += sizeof(float) * LB * kDotCols;
  cudaError_t err = cudaFuncSetAttribute(
      roofline_probe_kernel<kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + R - 1) / R;
  roofline_probe_kernel<kMode><<<blocks, kThreads, smem, stream>>>(
      geo, out, rows, TJ, LB, LBLK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// geo [5, TJ] (row 0 is cos theta); out [rows, TJ] (modes 0-2) or
// [rows, 16, TJ] (mode 3); mode 0 rec, 1 rec+store, 2 store, 3 dot.  TJ is a
// power of two in [32, 512]; the wrapper checks the shared-memory sizes.
// Returns cudaGetLastError() after the launch.
extern "C" int roofline_probe_launch(const float* geo, float* out, int rows,
                                     int TJ, int LB, int LBLK, int mode,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRec: return launch<kRec>(geo, out, rows, TJ, LB, LBLK, s);
    case kRecStore: return launch<kRecStore>(geo, out, rows, TJ, LB, LBLK, s);
    case kStore: return launch<kStore>(geo, out, rows, TJ, LB, LBLK, s);
    case kDot: return launch<kDot>(geo, out, rows, TJ, LB, LBLK, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

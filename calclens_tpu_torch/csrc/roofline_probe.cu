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
//   rec+store  the same, and every degree's value is stored into K4's
//              per-warp tile (16 degrees x (128 + 16) floats,
//              legendre_analysis_dot.cu); out as in rec, read back from the
//              tile after a barrier, so the stores cannot be dropped;
//   store      the stores alone (the constant 0.5); out = tile row 0 = 0.5;
//   dot        FP32 FMA from shared memory (no TF32), the ceiling of K2's
//              16-column sums: S[k, i] = i (0.01 k + 1) (k < 16, i < LB)
//              against a tile set to 0.5 once per block, out[m, k, j]
//              summed over the LBLK blocks.  The TPU kernel contracts a
//              scratch that nothing in that mode writes, so its value is
//              undefined there; the tile of 0.5 keeps the mode's work and
//              makes its output defined.
// The point is not a copy of the TPU's tiles but a ceiling for the port's
// own kernels in their own layout (K1-K4 since their redesign): 4 rings per
// thread, one (a, b) pair per degree read from shared memory for all 4,
// degrees unrolled, the steady step of the sweep (legendre_common.cuh's
// rec_step, rounded op by op, so the plain version rounds alike) and one
// float4 store per thread and degree into K4's tile.
//
// What bounds it on the H100: rec, the issue of the recurrence's 4 rounded
// FP32 operations per (l, m, j) (no FMA under that rounding: 4 issue
// slots); rec+store, those and one 4-byte store per element, at the card's
// shared-memory rate (both bounds are equal on the H100); store, the
// shared-memory rate; dot, 16 FMAs per element at the FP32 rate.  Device
// memory is touched only for the output.
// Design: a block is 128 threads, 512 (m, ring) pairs: 512 / TJ rows of m
// (TJ a power of two, 32 .. 512), TJ / 4 threads per row, ring q of a
// thread being u + q TJ / 4 (u its place in its row), so a thread's 4 rings
// share one row and its coefficients; at TJ < 128 a warp spans several rows
// (their coefficient rows are padded by 16 bytes, so the warp's reads hit
// distinct banks).  Per block of LB degrees the coefficients of the block's
// rows are computed into shared memory between two barriers.  When LB is a
// multiple of 16 the degrees run in groups of 16 with their two-degree
// coefficient loads (float4) and tile rows fixed at compile time, so
// nothing per element but the operations and the store remains; otherwise
// one degree at a time with a running tile row (the checked shapes, not the
// timed one).  dot: each thread keeps 4 rings x 16 columns of sums and per
// degree reads its 4 rings' tile values as one float4 and S's 16 columns as
// 4 broadcast float4 (5 loads per 64 FMAs).

#include <cuda_runtime.h>

#include "legendre_common.cuh"

namespace {

using calclens::coeffs;
using calclens::rec_step;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRings = 4;                  // rings per thread
constexpr int kPairs = kThreads * kRings;  // (m, ring) pairs per block
constexpr int kTileL = 16;                 // degrees per stored tile (K4's)
constexpr int kRow = 32 * kRings + 16;     // K4's padded tile row: 144 floats
constexpr int kTileFloats = kWarps * kTileL * kRow;
constexpr int kDotCols = 16;

enum Mode { kRec = 0, kRecStore = 1, kStore = 2, kDot = 3 };

// K4's store of a degree: 4 rings' values as one float4.
__device__ __forceinline__ void store_rings(float* p,
                                            const float (&v)[kRings]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One 16-byte store and load in shared memory, kept as written: the store
// mode stores the same constants to the same rows every 16 degrees (the
// compiler would sink such stores out of the loop), and dot's tile reads
// repeat every 16 degrees (it would hoist them).
__device__ __forceinline__ void sts4_kept(float* p, float x) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "f"(x));
}

__device__ __forceinline__ float4 lds4_kept(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// 64 FMAs of one degree: 4 rings' tile values p times S's 16 columns s4.
__device__ __forceinline__ void dot_degree(float (&acc)[kRings][kDotCols],
                                           const float4 p,
                                           const float4* s4) {
  const float pv[kRings] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int v = 0; v < kDotCols / 4; ++v) {
    const float4 s = s4[v];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      acc[q][4 * v] = fmaf(s.x, pv[q], acc[q][4 * v]);
      acc[q][4 * v + 1] = fmaf(s.y, pv[q], acc[q][4 * v + 1]);
      acc[q][4 * v + 2] = fmaf(s.z, pv[q], acc[q][4 * v + 2]);
      acc[q][4 * v + 3] = fmaf(s.w, pv[q], acc[q][4 * v + 3]);
    }
  }
}

// kGroup 16: LB is a multiple of 16, degrees in groups of 16; 1: one at a
// time.
template <int kMode, int kGroup>
__global__ void __launch_bounds__(kThreads)
roofline_probe_kernel(const float* __restrict__ geo,  // [5, TJ]; row 0 cth
                      float* __restrict__ out, int rows, int TJ, int LB,
                      int LBLK) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int per_row = TJ / kRings;  // threads per row of m
  const int R = kPairs / TJ;        // rows of m per block
  const int r = t / per_row;
  const int u = t - r * per_row;
  const int row0 = blockIdx.x * R;
  const int row = row0 + r;
  // this thread's 4 columns of its warp's tile [16][kRow] (not in rec)
  float* mine = smem + (t >> 5) * kTileL * kRow + kRings * lane;
  float res[kRings];

  if constexpr (kMode == kStore) {
    int slot = 0;
#pragma unroll 1
    for (int lb = 0; lb < LBLK; ++lb) {
      if constexpr (kGroup == kTileL) {
#pragma unroll 1
        for (int i = 0; i < LB; i += kGroup) {
#pragma unroll
          for (int s = 0; s < kGroup; ++s) {
            sts4_kept(mine + s * kRow, 0.5f);
          }
        }
      } else {
#pragma unroll 1
        for (int i = 0; i < LB; ++i) {
          sts4_kept(mine + slot * kRow, 0.5f);
          slot = (slot + 1) & (kTileL - 1);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRings; ++q) res[q] = mine[q];
  } else if constexpr (kMode == kDot) {
    float* st = smem + kTileFloats;  // S transposed [LB][16]
    for (int e = t; e < kTileFloats; e += kThreads) smem[e] = 0.5f;
    for (int e = t; e < LB * kDotCols; e += kThreads) {
      const int i = e / kDotCols;
      const int k = e - i * kDotCols;
      // (0.01 k + 1) in double, rounded once to float, as the TPU's Python
      // constant is
      const float sk = static_cast<float>(0.01 * k + 1.0);
      st[e] = __fmul_rn(static_cast<float>(i), sk);
    }
    __syncthreads();
    const float4* s4 = reinterpret_cast<const float4*>(st);
    float acc[kRings][kDotCols];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
#pragma unroll
      for (int k = 0; k < kDotCols; ++k) acc[q][k] = 0.0f;
    }
#pragma unroll 1
    for (int lb = 0; lb < LBLK; ++lb) {
      if constexpr (kGroup == kTileL) {
#pragma unroll 1
        for (int i = 0; i < LB; i += kGroup) {
#pragma unroll
          for (int s = 0; s < kGroup; ++s) {
            dot_degree(acc, lds4_kept(mine + s * kRow), s4 + (i + s) * 4);
          }
        }
      } else {
#pragma unroll 1
        for (int i = 0; i < LB; ++i) {
          dot_degree(acc, lds4_kept(mine + (i & (kTileL - 1)) * kRow),
                     s4 + i * 4);
        }
      }
    }
    if (row < rows) {
      float* o = out + static_cast<size_t>(row) * kDotCols * TJ + u;
#pragma unroll
      for (int k = 0; k < kDotCols; ++k) {
#pragma unroll
        for (int q = 0; q < kRings; ++q) {
          o[static_cast<size_t>(k) * TJ + q * per_row] = acc[q][k];
        }
      }
    }
    return;
  } else {
    // the coefficient rows [R][LB + 2] (a, b), after the tile in rec+store
    const int stride = LB + 2;
    float2* ab = reinterpret_cast<float2*>(
        smem + (kMode == kRecStore ? kTileFloats : 0));
    const float2* ab_r = ab + r * stride;
    float c[kRings], pp[kRings], pc[kRings];
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      c[q] = geo[u + q * per_row];
      pp[q] = 0.0f;
      pc[q] = 0.5f;
    }
    int slot = 0;
#pragma unroll 1
    for (int lb = 0; lb < LBLK; ++lb) {
      __syncthreads();  // the previous block's coefficients are used up
      for (int e = t; e < R * LB; e += kThreads) {
        const int rr = e / LB;
        const int i = e - rr * LB;
        float a, b;
        coeffs(static_cast<float>(lb * LB + i + 1),
               static_cast<float>(row0 + rr), a, b);
        ab[rr * stride + i] = make_float2(a, b);
      }
      __syncthreads();
      if constexpr (kGroup == kTileL) {
        const float4* ab4 = reinterpret_cast<const float4*>(ab_r);
#pragma unroll 1
        for (int i = 0; i < LB; i += kGroup) {
#pragma unroll
          for (int s = 0; s < kGroup; s += 2) {
            const float4 x = ab4[(i + s) / 2];  // degrees i + s, i + s + 1
            rec_step(x.x, x.y, c, pp, pc);
            if constexpr (kMode == kRecStore) {
              store_rings(mine + s * kRow, pc);
            }
            rec_step(x.z, x.w, c, pp, pc);
            if constexpr (kMode == kRecStore) {
              store_rings(mine + (s + 1) * kRow, pc);
            }
          }
        }
      } else {
#pragma unroll 1
        for (int i = 0; i < LB; ++i) {
          const float2 x = ab_r[i];
          rec_step(x.x, x.y, c, pp, pc);
          if constexpr (kMode == kRecStore) {
            store_rings(mine + slot * kRow, pc);
            slot = (slot + 1) & (kTileL - 1);
          }
        }
      }
    }
    if constexpr (kMode == kRecStore) {
      __syncthreads();  // makes every store observable
      const float* last = mine + ((slot + kTileL - 1) & (kTileL - 1)) * kRow;
#pragma unroll
      for (int q = 0; q < kRings; ++q) res[q] = last[q];
    } else {
#pragma unroll
      for (int q = 0; q < kRings; ++q) res[q] = pc[q];
    }
  }
  if (row < rows) {
#pragma unroll
    for (int q = 0; q < kRings; ++q) {
      out[static_cast<size_t>(row) * TJ + u + q * per_row] = res[q];
    }
  }
}

template <int kMode, int kGroup>
int launch(const float* geo, float* out, int rows, int TJ, int LB, int LBLK,
           cudaStream_t stream) {
  const int R = kPairs / TJ;
  size_t smem = 0;
  if (kMode == kRec || kMode == kRecStore) {
    smem += sizeof(float2) * R * (LB + 2);
  }
  if (kMode != kRec) smem += sizeof(float) * kTileFloats;
  if (kMode == kDot) smem += sizeof(float) * LB * kDotCols;
  auto kernel = roofline_probe_kernel<kMode, kGroup>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + R - 1) / R;
  kernel<<<blocks, kThreads, smem, stream>>>(geo, out, rows, TJ, LB, LBLK);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_mode(const float* geo, float* out, int rows, int TJ, int LB,
                int LBLK, cudaStream_t stream) {
  return LB % kTileL == 0
             ? launch<kMode, kTileL>(geo, out, rows, TJ, LB, LBLK, stream)
             : launch<kMode, 1>(geo, out, rows, TJ, LB, LBLK, stream);
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
    case kRec: return launch_mode<kRec>(geo, out, rows, TJ, LB, LBLK, s);
    case kRecStore:
      return launch_mode<kRecStore>(geo, out, rows, TJ, LB, LBLK, s);
    case kStore: return launch_mode<kStore>(geo, out, rows, TJ, LB, LBLK, s);
    case kDot: return launch_mode<kDot>(geo, out, rows, TJ, LB, LBLK, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Gathers from a table held in shared memory (P2-P4), f32: out = tab[idx].
//
// Replace the Pallas TPU kernels of tools/exp_pallas_gather.py (closures in
// main()):
//   gather_rows    pallas_a  (kern_a):  tab [W, 8] -> out [N, 8];
//   gather_lanes   pallas_a2 (kern_a2): tabT [8, W] -> out [8, N];
//   gather_onehot  pallas_b  (kern_b):  out [N, 8] by the TPU's two-level
//                  one-hot route on the tensor cores.
// They measure the access pattern of the ray side's taps (rays/soa.py):
// random reads from a table that fits on chip.  An index outside [0, W)
// gives a row of NaN (the kernels do not trap).
//
// What bounds gather_rows and gather_lanes on the H100: device memory, by
// design.  The index, the table and the output each move once (4 N + 32 W +
// 32 N bytes); the table is read from device memory once per block (a
// persistent grid of one block per SM), and every gather then hits shared
// memory.
//
// All three take the TPU tool's table of W = 4096 rows.
// gather_rows: a warp takes 32 kRowsBatches indices at a time, one per
// lane from each batch of 32 (a scalar load, so any int32 view of idx
// works), and writes their rows transposed over the warp: lane k takes half
// k % 2 of row k / 2 of a group of 16 rows, the index of that row from its
// lane by a shuffle, so each float4 store instruction writes 512
// contiguous bytes, as streaming stores.  (Each thread storing its own
// 32-byte row as two float4, the first design, wrote half of every 32-byte
// sector per instruction: 0.18 ms at N = 2^23, 49 % of the bound; staging
// the rows in shared memory for bulk TMA stores was slower than the
// shuffle.)  The 128 KB table is dynamic shared memory.
// gather_lanes: the table transposed; a thread reads 8 scalars and writes 8
// coalesced output rows.
//
// gather_onehot: level 1 is a bf16 product of the one-hot rows
// A[n, s] = (idx[n] / 128 == s) (32 segments) against the table as
// B[s, (l, f)] = tab[128 s + l, f], split into three bf16 parts x = hi +
// mid + lo (each rounded to nearest from the remainder of the one before,
// so the three carry the f32 value exactly).  Each part has columns of its
// own, so each output of the product has one nonzero term and holds its
// part exactly, and (hi + mid) + lo with __fadd_rn rebuilds the f32 value
// bit for bit (summing the parts in one tensor-core accumulator would not:
// Hopper's accumulation can drop lo's last bit where hi rounds up across a
// power of two).  Level 2 selects lane idx % 128 of each row.  Like the
// TPU kernel it computes all 128 lanes of every row: 3 parts x 2 k-steps x
// 128 m16n8k16-equivalent products per 16 indices, 1.65e12 FLOPs at
// N = 2^23.  What bounds it on the H100: those products at the dense bf16
// tensor-core rate (1.67 ms), and beside them the level-2 select on the
// CUDA cores (about 14 instructions per thread per lane of 8 indices).
// Design: B lives in shared memory for the whole kernel (one persistent
// block per SM builds the three parts once: 32 x 3072 bf16, 192 KB), in
// wgmma's K-major layout with the 64-byte swizzle, its columns ordered
// (chunk of 8 lanes, lane, part, field), so one m64n192k16 wgmma covers 8
// lanes of all three parts.  Each warpgroup takes 64 indices at a time and
// builds A, the one-hot rows, in registers (wgmma's register-A fragment is
// mma.sync's A fragment per warp); for each of the 16 chunks it issues two
// wgmma (the two k-steps of 16 segments) into one accumulator of 96
// registers per thread, waits, and keeps the accumulator values of its rows'
// lanes.  Three warpgroups per block run this independently, so one
// warpgroup's select overlaps another's products.  The next 64 indices are
// loaded while the current ones are multiplied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_util.cuh"

namespace {

using calclens::num_sms;

constexpr int kF = 8;                 // fields per table row
constexpr int kGatherThreads = 1024;
constexpr int kRowsBatches = 2;       // gather_rows: 32-index batches per warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeg = 128;             // lanes per segment (the TPU's lanes)
constexpr int kNSeg = 32;             // segments
constexpr int kW = kSeg * kNSeg;      // table rows: 4096
constexpr int kTableBytes = sizeof(float) * kF * kW;  // 128 KB
constexpr int kParts = 3;             // hi, mid, lo
// gather_onehot: B's columns in chunks of 8 lanes x 3 parts x 8 fields
constexpr int kChunkLanes = 8;
constexpr int kChunkN = kChunkLanes * kParts * kF;  // 192: one wgmma's N
constexpr int kChunks = kSeg / kChunkLanes;         // 16
constexpr int kColBytes = 2 * kNSeg;  // one column: 32 segments in bf16
constexpr int kAtomBytes = 8 * kColBytes;  // 8 columns: the swizzle's repeat
constexpr int kChunkBytes = kChunkN * kColBytes;  // 12 KB
constexpr int kOnehotSmem = kChunks * kChunkBytes;  // 192 KB
constexpr int kAcc = kChunkN / 2;     // accumulator floats per thread: 96
constexpr int kGroupRows = 64;        // indices per warpgroup product (M)
constexpr int kOnehotWarpgroups = 3;
constexpr int kOnehotThreads = 128 * kOnehotWarpgroups;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                   float* __restrict__ out, long long n) {
  extern __shared__ float4 rows_s[];  // [kW][2]
  const float4* tab4 = reinterpret_cast<const float4*>(tab);
  for (int i = threadIdx.x; i < 2 * kW; i += blockDim.x) rows_s[i] = tab4[i];
  __syncthreads();
  const float bad = nan_f();
  const float4 nan4 = make_float4(bad, bad, bad, bad);
  float4* out4 = reinterpret_cast<float4*>(out);
  const int lane = threadIdx.x & 31, half = lane & 1;
  constexpr int kSpan = 32 * kRowsBatches;  // indices per warp and step
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const long long step =
      static_cast<long long>(gridDim.x) * (blockDim.x / 32) * kSpan;
  for (long long b = warp * kSpan; b < n; b += step) {
    int r[kRowsBatches];
#pragma unroll
    for (int u = 0; u < kRowsBatches; ++u) {
      const long long i = b + 32 * u + lane;
      r[u] = i < n ? __ldcs(idx + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kRowsBatches; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int src = 16 * h + lane / 2;  // the batch's row of this lane
        const int ri = __shfl_sync(kFull, r[u], src);
        const bool ok = static_cast<unsigned>(ri) < static_cast<unsigned>(kW);
        float4 v = rows_s[2 * (ok ? ri : 0) + half];  // no read off the table
        if (!ok) v = nan4;
        const long long row0 = b + 32 * u + 16 * h;
        if (row0 + lane / 2 < n) __stcs(out4 + 2 * row0 + lane, v);
      }
    }
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_lanes_kernel(const float* __restrict__ tabT,  // [8, kW]
                    const int* __restrict__ idx, float* __restrict__ out,
                    long long n) {
  extern __shared__ float4 lanes_s4[];  // [8][kW]
  const float4* tab4 = reinterpret_cast<const float4*>(tabT);
  for (int i = threadIdx.x; i < kF * kW / 4; i += blockDim.x) {
    lanes_s4[i] = tab4[i];
  }
  __syncthreads();
  const float* lanes_s = reinterpret_cast<const float*>(lanes_s4);
  const float bad = nan_f();
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int r = idx[i];
    const bool ok = r >= 0 && r < kW;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      out[f * n + i] = ok ? lanes_s[f * kW + r] : bad;
    }
  }
}

// Element offset (in bf16) of B[s, col] in wgmma's K-major layout with the
// 64-byte swizzle: column col holds its 32 segments in 64 bytes, 8 columns
// make a 512-byte atom, and the 16-byte chunk s / 8 of column col sits at
// chunk (s / 8) ^ ((col % 8) / 2) of the atom's row (the hardware XORs
// address bits 4-5 with bits 7-8).
__device__ __forceinline__ int b_offset(int col, int s) {
  const int r = col & 7;
  return ((col >> 3) * kAtomBytes + r * kColBytes +
          ((((s >> 3) ^ (r >> 1)) & 3) << 4)) / 2 + (s & 7);
}

// wgmma's shared-memory descriptor of a K-major operand with the 64-byte
// swizzle at shared address `addr`: the start address, the leading offset
// (unused by a swizzled K-major operand: 1), the stride between 8-column
// atoms (512 bytes), all in 16-byte units; layout type 2 is the 64-byte
// swizzle.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (2ull << 62);
}

// d (+)= A B for one m64n192k16 tile: A, the warp's 16 rows x 16 segments,
// from registers in mma.sync's A fragment; B from shared memory at `desc`;
// kAccumulate 0 overwrites d.
template <int kAccumulate>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[kAcc],
                                                 const unsigned (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(kAccumulate));
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16 pair of one-hot entries (seg == k, seg == k + 1), lower k in the low
// half; 0x3F80 is bf16 1.0.
__device__ __forceinline__ unsigned onehot_pair(int seg, int k) {
  return (seg == k ? 0x3F80u : 0u) | (seg == k + 1 ? 0x3F800000u : 0u);
}

__global__ void __launch_bounds__(kOnehotThreads, 1)
gather_onehot_kernel(const float* __restrict__ tab,  // [kW, 8]
                     const int* __restrict__ idx, float* __restrict__ out,
                     long long n) {
  extern __shared__ __align__(1024) __nv_bfloat16 parts_s[];
  // tab[128 s + l, f] sits at flat index s * 1024 + l * 8 + f = e; its parts
  // go to columns (l / 8) * 192 + ((l % 8) * 3 + part) * 8 + f
  for (int e = threadIdx.x; e < kW * kF; e += blockDim.x) {
    const int s = e >> 10;
    const int l = (e >> 3) & (kSeg - 1);
    const int f = e & (kF - 1);
    const int col = (l / kChunkLanes) * kChunkN +
                    (l % kChunkLanes) * kParts * kF + f;
    const float x = tab[e];
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const float r2 = __fsub_rn(r1, __bfloat162float(mid));
    parts_s[b_offset(col, s)] = hi;
    parts_s[b_offset(col + kF, s)] = mid;
    parts_s[b_offset(col + 2 * kF, s)] = __float2bfloat16_rn(r2);
  }
  // the table was written by the generic proxy; wgmma reads it through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(parts_s));
  const int wg = threadIdx.x >> 7;
  const int w = (threadIdx.x >> 5) & 3;  // rows 16 w .. 16 w + 15 of a group
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row (A, D)
  const int q = lane & 3;
  const long long ngroups = (n + kGroupRows - 1) / kGroupRows;
  const long long step = static_cast<long long>(gridDim.x) * kOnehotWarpgroups;
  const float bad = nan_f();
  // the index of row g + 8 h of this warp's 16 in group grp, or -1
  auto load = [&](long long grp, int h) {
    const long long row = grp * kGroupRows + 16 * w + g + 8 * h;
    return grp < ngroups && row < n ? idx[row] : -1;
  };
  long long grp = static_cast<long long>(blockIdx.x) * kOnehotWarpgroups + wg;
  int v[2] = {load(grp, 0), load(grp, 1)};
  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.0f;
  for (; grp < ngroups; grp += step) {
    const int next[2] = {load(grp + step, 0), load(grp + step, 1)};
    bool ok[2];
    int off[2];
    unsigned a[2][4];  // [k step][register]
    {
      int seg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok[h] = v[h] >= 0 && v[h] < kW;
        seg[h] = ok[h] ? v[h] / kSeg : -1;
        off[h] = v[h] & (kSeg - 1);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k = ks * 16 + 2 * q;
        a[ks][0] = onehot_pair(seg[0], k);
        a[ks][1] = onehot_pair(seg[1], k);
        a[ks][2] = onehot_pair(seg[0], k + 8);
        a[ks][3] = onehot_pair(seg[1], k + 8);
      }
    }
    float sel[2][kParts][2] = {};  // [row g + 8 h][part][field 2q + i]
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      const uint64_t desc = b_desc(base + c * kChunkBytes);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_m64n192k16<0>(d, a[0], desc);
      // segments 16 .. 31: 32 bytes on, 2 in the descriptor's units
      wgmma_m64n192k16<1>(d, a[1], desc + 2);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      // the accumulator's 8-column tile 3 j + p holds lane 8 c + j of part p:
      // rows g (registers 0, 1) and g + 8 (2, 3), fields 2 q, 2 q + 1
#pragma unroll
      for (int j = 0; j < kChunkLanes; ++j) {
        const int lane_t = c * kChunkLanes + j;
        const bool hit0 = off[0] == lane_t;
        const bool hit1 = off[1] == lane_t;
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
          const int i = 4 * (j * kParts + p);
          if (hit0) {
            sel[0][p][0] = d[i];
            sel[0][p][1] = d[i + 1];
          }
          if (hit1) {
            sel[1][p][0] = d[i + 2];
            sel[1][p][1] = d[i + 3];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = grp * kGroupRows + 16 * w + g + 8 * h;
      if (row >= n) continue;
      const float (&s)[kParts][2] = sel[h];
      float2 val = make_float2(bad, bad);
      if (ok[h]) {
        val.x = __fadd_rn(__fadd_rn(s[0][0], s[1][0]), s[2][0]);
        val.y = __fadd_rn(__fadd_rn(s[0][1], s[1][1]), s[2][1]);
      }
      *reinterpret_cast<float2*>(out + row * kF + 2 * q) = val;
    }
    v[0] = next[0];
    v[1] = next[1];
  }
}

template <typename Kernel>
int persistent_launch(Kernel kernel, int threads, size_t smem,
                      cudaStream_t stream, const float* tab, const int* idx,
                      float* out, long long n) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<num_sms(), threads, smem, stream>>>(tab, idx, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab [4096, 8], idx [n] int32, out [n, 8].
extern "C" int gather_rows_launch(const float* tab, const int* idx, float* out,
                                  long long n, void* stream) {
  return persistent_launch(gather_rows_kernel, kGatherThreads, kTableBytes,
                           static_cast<cudaStream_t>(stream), tab, idx, out,
                           n);
}

// tabT [8, 4096], idx [n] int32, out [8, n].
extern "C" int gather_lanes_launch(const float* tabT, const int* idx,
                                   float* out, long long n, void* stream) {
  return persistent_launch(gather_lanes_kernel, kGatherThreads, kTableBytes,
                           static_cast<cudaStream_t>(stream), tabT, idx, out,
                           n);
}

// tab [4096, 8], idx [n] int32, out [n, 8].
extern "C" int gather_onehot_launch(const float* tab, const int* idx,
                                    float* out, long long n, void* stream) {
  return persistent_launch(gather_onehot_kernel, kOnehotThreads, kOnehotSmem,
                           static_cast<cudaStream_t>(stream), tab, idx, out,
                           n);
}

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
// What bounds them on the H100: device memory, by design.  The index, the
// table and the output each move once (4 N + 32 W + 32 N bytes); the table
// is read from device memory once per block (a persistent grid of one block
// per SM), and every gather then hits shared memory.
//
// All three take the TPU tool's table of W = 4096 rows.
// gather_rows: each thread gathers one index as two float4 loads of its
// 32-byte row and writes the row as two float4 stores (neighbouring threads
// write neighbouring rows).  The 128 KB table is dynamic shared memory.
// gather_lanes: the table transposed; a thread reads 8 scalars and writes 8
// coalesced output rows.
// gather_onehot: level 1 is a bf16 mma.sync product of the one-hot rows
// A[n, s] = (idx[n] / 128 == s) (16 rows x 32 segments) against the table
// as B[s, l * 8 + f] = tab[128 s + l, f] (32 x 1024), split into three bf16
// parts x = hi + mid + lo (each rounded to nearest from the remainder of
// the one before, so the three carry the f32 value exactly).  One product
// per part, each into its own f32 accumulator: a one-hot product has one
// nonzero term, so each accumulator holds its part exactly, and
// (hi + mid) + lo with __fadd_rn rebuilds the f32 value bit for bit.  Level
// 2 selects lane idx % 128: the m16n8 output tile t holds lanes l = t and
// fields f = 0..7, and a thread keeps tile t's values for a row only where
// t == idx % 128.  Like the TPU kernel it computes all 128 lanes of every
// row: 3 x 2 x 128 products of 16 rows per 16 indices, so it is bound by
// the tensor cores and the shared-memory reads of B, not by device memory.
// Each warp multiplies two 16-row tiles per B fragment it loads; the B
// layout is XOR-swizzled so the fragment loads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF = 8;                 // fields per table row
constexpr int kGatherThreads = 1024;
constexpr int kSeg = 128;             // lanes per segment (the TPU's lanes)
constexpr int kNSeg = 32;             // segments
constexpr int kW = kSeg * kNSeg;      // table rows: 4096
constexpr int kTableBytes = sizeof(float) * kF * kW;  // 128 KB
constexpr int kCols = kSeg * kF;      // 1024 columns of the level-1 product
constexpr int kWordsPerCol = kNSeg / 2;  // bf16 pairs along the segment axis
constexpr int kPartWords = kCols * kWordsPerCol;
constexpr int kParts = 3;             // hi, mid, lo
constexpr int kOnehotThreads = 512;
constexpr int kTilesPerWarp = 2;      // 16-row tiles multiplied per B load

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

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
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const int r = idx[i];
    const bool ok = r >= 0 && r < kW;
    out4[2 * i] = ok ? rows_s[2 * r] : nan4;
    out4[2 * i + 1] = ok ? rows_s[2 * r + 1] : nan4;
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

// 32-bit word of column n holding the bf16 pair of segments (2 word,
// 2 word + 1); the XOR spreads the 8 columns x 4 words of one fragment load
// over all 32 banks.
__device__ __forceinline__ int swz(int n, int word) {
  return n * kWordsPerCol + (word ^ (((n >> 1) & 3) << 2));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  extern __shared__ unsigned parts_s[];  // [kParts][kCols][16 words]
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(parts_s);
  // tab[128 s + l, f] sits at flat index s * 1024 + (l * 8 + f) = e
  for (int e = threadIdx.x; e < kNSeg * kCols; e += blockDim.x) {
    const int s = e / kCols;
    const int col = e - s * kCols;
    const float x = tab[e];
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const float r2 = __fsub_rn(r1, __bfloat162float(mid));
    const int o = 2 * swz(col, s >> 1) + (s & 1);
    pe[o] = hi;
    pe[2 * kPartWords + o] = mid;
    pe[4 * kPartWords + o] = __float2bfloat16_rn(r2);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int q = lane & 3;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const long long ntiles = (n + 15) / 16;
  const float bad = nan_f();
  for (long long tile0 = warp * kTilesPerWarp; tile0 < ntiles;
       tile0 += nwarps * kTilesPerWarp) {
    int off[kTilesPerWarp][2];
    bool ok[kTilesPerWarp][2];
    unsigned a[kTilesPerWarp][2][4];  // [tile][k step][register]
#pragma unroll
    for (int tt = 0; tt < kTilesPerWarp; ++tt) {
      int seg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = (tile0 + tt) * 16 + g + 8 * h;
        const int v = row < n ? idx[row] : -1;
        ok[tt][h] = v >= 0 && v < kW;
        seg[h] = ok[tt][h] ? v / kSeg : -1;
        off[tt][h] = v & (kSeg - 1);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k = ks * 16 + 2 * q;
        a[tt][ks][0] = onehot_pair(seg[0], k);
        a[tt][ks][1] = onehot_pair(seg[1], k);
        a[tt][ks][2] = onehot_pair(seg[0], k + 8);
        a[tt][ks][3] = onehot_pair(seg[1], k + 8);
      }
    }
    float sel[kTilesPerWarp][2][kParts][2] = {};
#pragma unroll 1
    for (int t = 0; t < kSeg; ++t) {  // output tile t: lane t, fields 0..7
      const int col = t * kF + g;
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const unsigned* B = parts_s + p * kPartWords;
        const unsigned b00 = B[swz(col, q)], b01 = B[swz(col, q + 4)];
        const unsigned b10 = B[swz(col, 8 + q)], b11 = B[swz(col, 12 + q)];
#pragma unroll
        for (int tt = 0; tt < kTilesPerWarp; ++tt) {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(d, a[tt][0], b00, b01);
          mma_bf16(d, a[tt][1], b10, b11);
          if (off[tt][0] == t) {
            sel[tt][0][p][0] = d[0];
            sel[tt][0][p][1] = d[1];
          }
          if (off[tt][1] == t) {
            sel[tt][1][p][0] = d[2];
            sel[tt][1][p][1] = d[3];
          }
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < kTilesPerWarp; ++tt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = (tile0 + tt) * 16 + g + 8 * h;
        if (row >= n) continue;
        const float (&s)[kParts][2] = sel[tt][h];
        float2 v = make_float2(bad, bad);
        if (ok[tt][h]) {
          v.x = __fadd_rn(__fadd_rn(s[0][0], s[1][0]), s[2][0]);
          v.y = __fadd_rn(__fadd_rn(s[0][1], s[1][1]), s[2][1]);
        }
        *reinterpret_cast<float2*>(out + row * kF + 2 * q) = v;
      }
    }
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
  const size_t smem = sizeof(unsigned) * kParts * kPartWords;
  cudaError_t err = cudaFuncSetAttribute(
      gather_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_onehot_kernel<<<num_sms(), kOnehotThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(tab, idx, out,
                                                              n);
  return static_cast<int>(cudaGetLastError());
}

// The stage-A dot in three precisions (S3).
//
// Replaces the Pallas kernels of scripts/ablate_mosaic_x6.py:build (bodies
// kern_f32, kern_x6, kern_x1): Yr = Fr x and Yi = Fi x for a constant
// (n1, n1) pair (Fr, Fi) against x (B, n1, n2), in
//   f32_highest  fp32 FMA on the CUDA cores (stage_a_tile.cuh without a
//                twiddle);
//   bf16_x6      the 6-term bf16 ladder of _x6: F arrives split on the host
//                into three bf16 parts (split3_bf16), x is split in the
//                kernel with __float2bfloat16_rn (round to nearest even, as
//                astype does), and the products
//                  a1b1 + (a1b2 + a2b1) + (a1b3 + a2b2 + a3b1)
//                run on the tensor cores with fp32 accumulators, one
//                accumulator per parenthesised group, summed in that order;
//   bf16_x1      one bf16 product of the rounded operands.
//
// What bounds it on an H100, at n1 = 128, n2 = 8192: f32 does 537 MFLOP ->
// 8.0 us at 67 TFLOP/s (compute); bf16_x6 does 3.2 GFLOP -> 3.3 us at
// 989 TFLOP/s but moves 12.7 MB (x read, Yr and Yi written) -> 3.8 us at
// 3.35 TB/s, so memory is the wall, as it is for bf16_x1 (3.8 us).
//
// Design of the bf16 kernel: mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// the simplest tensor-core product.  A block computes 64 rows x 64 columns
// with 8 warps, each a 16 x 32 warp tile (four n8 tiles).  The x tile moves
// through shared memory 32 deep at a time: each thread reads a float4,
// splits each value into its bf16 parts and stores each part's four values
// as one 8-byte word in a [depth][column] layout (rows padded to 72 so the
// stores and the reads are free of bank conflicts); B fragments come out of
// it transposed with ldmatrix.trans (storing the parts transposed, one
// value at a time, would cost 16-way bank conflicts).  The F parts are tiny (3 x 32 KB) and L1-resident, so A fragments are read
// straight from them.  No TMA, no wgmma yet.
#include <cuda_bf16.h>

#include "stage_a_tile.cuh"

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int KC = 32;   // depth per shared-memory stage
constexpr int NLD = BN + 8;  // padded row of the x parts ([depth][column])
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of depth k0.., columns c0.. from a [depth][column] bf16 tile:
// ldmatrix.trans hands thread (g, tq) the pairs (2tq, 2tq+1) x column g of
// the two 8 x 8 matrices at depths k0 and k0 + 8.
__device__ __forceinline__ void load_b(unsigned& b0, unsigned& b1, const unsigned short* tile,
                                       int k0, int c0, int lane) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(tile + (k0 + (lane & 15)) * NLD + c0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// A fragment of rows m0.., depth k0.. of a row-major (n1, n1) bf16 table.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const unsigned short* f, int n1, int m0,
                                       int k0, int g, int tq) {
  const unsigned short* p = f + (size_t)(m0 + g) * n1 + k0 + tq * 2;
  a[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  a[1] = __ldg(reinterpret_cast<const unsigned*>(p + 8 * n1));
  a[2] = __ldg(reinterpret_cast<const unsigned*>(p + 8));
  a[3] = __ldg(reinterpret_cast<const unsigned*>(p + 8 * n1 + 8));
}

// PARTS = 3: bf16_x6; PARTS = 1: bf16_x1.  far / fai: (PARTS, n1, n1) bf16.
template <int PARTS>
__global__ void __launch_bounds__(THREADS)
stage_a_dot_bf16_kernel(const float* __restrict__ x, const unsigned short* __restrict__ far,
                        const unsigned short* __restrict__ fai, float* __restrict__ yr,
                        float* __restrict__ yi, int n1, int n2) {
  constexpr int G = PARTS == 3 ? 3 : 1;  // accumulator groups
  __shared__ __align__(16) unsigned short sx[PARTS][KC][NLD];

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const size_t boff = (size_t)blockIdx.z * n1 * n2;
  const int m0 = row0 + (warp % 4) * 16;  // this warp's 16 rows
  const int n0 = (warp / 4) * 32;         // and 32 columns, within the block
  const bool live = m0 < n1;
  const size_t tab = (size_t)n1 * n1;

  float acc[G][2][4][4];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][c][j][e] = 0.f;

  for (int k0 = 0; k0 < n1; k0 += KC) {
    // x tile (KC x BN) -> bf16 parts, [depth][column], 4 values per store.
#pragma unroll
    for (int i = 0; i < (KC * BN) / (4 * THREADS); ++i) {
      const int q = t + i * THREADS;
      const int k = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
      const float4 v = gft::ldg4(x + boff + (size_t)(k0 + k) * n2 + col0 + c4);
      __nv_bfloat16 h[PARTS][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xv = gft::f4(v, e);
        h[0][e] = __float2bfloat16_rn(xv);
        if constexpr (PARTS == 3) {
          const float r1 = xv - __bfloat162float(h[0][e]);
          h[1][e] = __float2bfloat16_rn(r1);
          h[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(h[1][e]));
        }
      }
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        *reinterpret_cast<uint2*>(&sx[p][k][c4]) =
            make_uint2(pack2(h[p][0], h[p][1]), pack2(h[p][2], h[p][3]));
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        unsigned ar[PARTS][4], ai[PARTS][4];
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          load_a(ar[p], far + p * tab, n1, m0, k0 + kk, g, tq);
          load_a(ai[p], fai + p * tab, n1, m0, k0 + kk, g, tq);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned b[PARTS][2];
#pragma unroll
          for (int p = 0; p < PARTS; ++p)
            load_b(b[p][0], b[p][1], &sx[p][0][0], kk, n0 + j * 8, lane);
          mma_bf16(acc[0][0][j], ar[0], b[0][0], b[0][1]);
          mma_bf16(acc[0][1][j], ai[0], b[0][0], b[0][1]);
          if constexpr (PARTS == 3) {
            mma_bf16(acc[1][0][j], ar[0], b[1][0], b[1][1]);  // a1 b2
            mma_bf16(acc[1][0][j], ar[1], b[0][0], b[0][1]);  // a2 b1
            mma_bf16(acc[1][1][j], ai[0], b[1][0], b[1][1]);
            mma_bf16(acc[1][1][j], ai[1], b[0][0], b[0][1]);
            mma_bf16(acc[2][0][j], ar[0], b[2][0], b[2][1]);  // a1 b3
            mma_bf16(acc[2][0][j], ar[1], b[1][0], b[1][1]);  // a2 b2
            mma_bf16(acc[2][0][j], ar[2], b[0][0], b[0][1]);  // a3 b1
            mma_bf16(acc[2][1][j], ai[0], b[2][0], b[2][1]);
            mma_bf16(acc[2][1][j], ai[1], b[1][0], b[1][1]);
            mma_bf16(acc[2][1][j], ai[2], b[0][0], b[0][1]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  // D fragment: d0, d1 at (row g, cols 2tq, 2tq+1); d2, d3 at row g + 8.
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float* y = (c == 0 ? yr : yi) + boff;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[0][c][j][e];
        if constexpr (G == 3) v[e] = (v[e] + acc[1][c][j][e]) + acc[2][c][j][e];
      }
      const int col = col0 + n0 + j * 8 + tq * 2;
      *reinterpret_cast<float2*>(y + (size_t)(m0 + g) * n2 + col) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(y + (size_t)(m0 + g + 8) * n2 + col) = make_float2(v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" int gft_stage_a_dot_f32(const float* x, const float* fr, const float* fi, float* yr,
                                   float* yi, int batch, int n1, int n2, void* stream) {
  return gft::launch_stage_a_tile<gft::TW_NONE>(x, nullptr, fr, fi, nullptr, nullptr, nullptr,
                                                nullptr, yr, yi, batch, n1, n2, 1, n1, n2,
                                                stream);
}

extern "C" int gft_stage_a_dot_bf16(const float* x, const void* far, const void* fai, float* yr,
                                    float* yi, int batch, int n1, int n2, int parts,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || n1 < 16 || n1 % KC || n2 < BN || n2 % BN ||
      (parts != 1 && parts != 3))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n2 / BN, (n1 + BM - 1) / BM, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ar = static_cast<const unsigned short*>(far);
  const auto* ai = static_cast<const unsigned short*>(fai);
  if (parts == 3)
    stage_a_dot_bf16_kernel<3><<<grid, THREADS, 0, s>>>(x, ar, ai, yr, yi, n1, n2);
  else
    stage_a_dot_bf16_kernel<1><<<grid, THREADS, 0, s>>>(x, ar, ai, yr, yi, n1, n2);
  return (int)cudaGetLastError();
}

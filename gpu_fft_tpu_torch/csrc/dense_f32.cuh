// A register-tiled fp32 product on the CUDA cores, for the stage-A dots.
//
// Serves S3's f32 variant (stage_a_dot.cu, replacing the Pallas body
// kern_f32 of scripts/ablate_mosaic_x6.py:build): over x (B, K, N) it
// computes, for each batch b and stacked row m < M,
//   P[b, m, n] = sum_k A[m, k] x[b, k, n],
// with A given pre-transposed as at (K, M), and hands every 4 consecutive
// columns of P to an epilogue functor (Epi::store(b, m, n, float4)).  S3's
// epilogue splits the stacked rows [Fr; Fi] into Yr and Yi; K3-legacy's
// materialized twiddle is meant to hang on the same hook.
//
// What bounds it on an H100: at (1, 128, 8192) the two dots are 537 MFLOP,
// 8.0 us at 67 TFLOP/s of fp32 FMA, against 12.7 MB moved (3.8 us at
// 3.35 TB/s): the FMA pipes are the wall, so the design keeps them fed.
//
// Design:
// - a 64 x 64 block tile of 64 threads (BM x BN in the template; 64 x 64
//   beat 128 x 128, 128 x 64 and 64 x 128 at (1, 128, 8192) on an H100,
//   scripts/time_dot.py --sweep), each thread 8 x 8 outputs (64
//   accumulators) as two 4-row by two 4-column quarters BM/2 and BN/2
//   apart, so every operand is read with LDS.128 from a [k][m] or [k][n]
//   layout: 4 shared loads per 64 FFMA;
// - the depth loop runs on a STAGES-deep ring of cp.async 16-byte copies
//   (A's slice comes straight from the pre-transposed table, x's from its
//   rows, no transposing store), one barrier per BK-deep slice, so slice
//   k + STAGES - 1 is in flight while slice k computes;
// - K % BK == 0, M % BM == 0 and N % BN == 0 are the caller's contract (the
//   launch rule checks them), so no load or store is masked.
#pragma once

#include "common.cuh"

namespace gft {
namespace dense_f32 {

constexpr int BK = 8;      // depth of a ring slot
constexpr int STAGES = 4;  // ring slots

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace dense_f32

// grid: (N / BN, M / BM, B); BM * BN / 64 threads.
template <int BM, int BN, class Epi>
__global__ void __launch_bounds__(BM * BN / 64)
dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ at, Epi epi, int m_rows,
                 int k_depth, int n_cols) {
  using namespace dense_f32;
  constexpr int TX = BN / 8;  // threads along n
  constexpr int THREADS = BM * BN / 64;
  constexpr int A_CHUNKS = BK * BM / 4;  // 16-byte copies of a slot's A slice
  constexpr int B_CHUNKS = BK * BN / 4;
  __shared__ __align__(16) float sa[STAGES][BK][BM];
  __shared__ __align__(16) float sb[STAGES][BK][BN];

  const int t = threadIdx.x;
  const int tx = t % TX, ty = t / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * k_depth * n_cols;

  auto issue = [&](int slice, int slot) {
    const int k0 = slice * BK;
#pragma unroll
    for (int i = 0; i < (A_CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int q = t + i * THREADS;
      if (A_CHUNKS % THREADS == 0 || q < A_CHUNKS) {
        const int k = q / (BM / 4), c4 = (q % (BM / 4)) * 4;
        cp_async16(&sa[slot][k][c4], at + (size_t)(k0 + k) * m_rows + m0 + c4);
      }
    }
#pragma unroll
    for (int i = 0; i < (B_CHUNKS + THREADS - 1) / THREADS; ++i) {
      const int q = t + i * THREADS;
      if (B_CHUNKS % THREADS == 0 || q < B_CHUNKS) {
        const int k = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
        cp_async16(&sb[slot][k][c4], xb + (size_t)(k0 + k) * n_cols + n0 + c4);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int slices = k_depth / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice s have landed
    __syncthreads();              // ... everyone's; and slice s - 1's slot is free
    const int next = s + STAGES - 1;
    if (next < slices) issue(next, next % STAGES);
    cp_async_commit();
    const int slot = s % STAGES;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = lds4(&sa[slot][k][ty * 4]);
      const float4 a1 = lds4(&sa[slot][k][BM / 2 + ty * 4]);
      const float4 b0 = lds4(&sb[slot][k][tx * 4]);
      const float4 b1 = lds4(&sb[slot][k][BN / 2 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      epi.store(b, m, n,
                make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]));
    }
  }
}

// Launch over x (B, K, N) and at (K, M) in 64 x 64 tiles; returns
// cudaGetLastError().
template <class Epi>
int launch_dense_f32(const float* x, const float* at, Epi epi, int batch, int m_rows, int k_depth,
                     int n_cols, void* stream) {
  constexpr int TILE = 64;
  if (batch < 1 || batch > 65535 || k_depth < dense_f32::BK || k_depth % dense_f32::BK ||
      m_rows % TILE || n_cols % TILE || m_rows / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_cols / TILE, m_rows / TILE, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dense_f32_kernel<TILE, TILE, Epi><<<grid, TILE * TILE / 64, 0, s>>>(x, at, epi, m_rows, k_depth, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace gft

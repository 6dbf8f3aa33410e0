// A register-tiled fp32 product on the CUDA cores, for the stage-A dots.
//
// Computes P[b, m, n] = sum_k A[m, k] x[b, k, n] for each stacked row m < M,
// with A given pre-transposed as at (K, M), and hands the results to an
// epilogue functor in pairs of rows PAIR apart:
//   Epi::store(b, m, n, float4 lo, float4 hi[, const float4 (&w)[STAGED]])
// gets columns n .. n + 3 of row m (lo) and of row m + PAIR (hi), for every
// m with m % BM < PAIR.  An epilogue may read an operand of its own, tiled
// like a row pair's outputs: Epi::STAGED planes, plane p at row r of block
// row group m0 / BM and column c being epi.staged_src(p, m0)[r * epi.ld + c].
// The kernel copies a block tile's PAIR x BN of each plane into shared
// memory under the tile's first slices and hands store the float4 of each
// plane at (m, n) as w.  Two stage-A kernels run on it:
// - S3's f32 variant (stage_a_dot.cu, replacing the Pallas body kern_f32
//   of scripts/ablate_mosaic_x6.py:build), whose epilogue splits the
//   stacked rows [Fr; Fi] into Yr and Yi;
// - S2 (stage_a_manual.cu, replacing scripts/ablate_2e20_levers.py:
//   stage_a_manual), whose table interleaves Fr and Fi by 32 rows, so that
//   a pair is the real and imaginary part of one output row and its
//   epilogue multiplies by the materialized twiddle, staged as two planes
//   (twr, twi).
//
// What bounds it on an H100: at (1, 128, 8192) the two dots are 537 MFLOP,
// 8.0 us at 67 TFLOP/s of fp32 FMA, against 12.7 MB moved (3.8 us at
// 3.35 TB/s; S2 adds 8.4 MB of twiddle): the FMA pipes are the wall, so the
// design keeps them fed.
//
// Design:
// - a 64-row block tile (BM) of BN / 8 x 8 threads, each thread 8 x 8
//   outputs (64 accumulators) as two 4-row by two 4-column quarters BM/2
//   and BN/2 apart, so every operand is read with LDS.128 from a [k][m] or
//   [k][n] layout: 4 shared loads per 64 FFMA (64 x 64 beat 128 x 128,
//   128 x 64 and 64 x 128 for S3 at (1, 128, 8192) on an H100,
//   scripts/time_dot.py --sweep);
// - one block tile a block, one wave (a block that walked several column
//   tiles with its A rows resident lost to it for S2 at 2^20 on an H100:
//   PERF.md, section 6);
// - the depth loop runs on a STAGES-deep ring of cp.async 16-byte copies
//   (A's slice comes straight from the pre-transposed table, x's from its
//   rows, no transposing store), one barrier per BK-deep slice, so slice
//   k + STAGES - 1 is in flight while slice k computes; the epilogue's
//   staged planes are copied with the first slice's copy group in the loop,
//   so their loads are under the FMAs, not after them;
// - K % BK == 0, M % BM == 0 and N % BN == 0 are the caller's contract (the
//   launch rules check them), so no load or store is masked.
#pragma once

#include "common.cuh"

namespace gft {
namespace dense_f32 {

constexpr int BK = 8;          // depth of a ring slot
constexpr int STAGES = 4;      // ring slots
constexpr int BM = 64;         // rows of a block tile
constexpr int PAIR = BM / 2;   // distance of the two rows the epilogue gets

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

// grid: (N / BN, M / BM, B); BM * BN / 64 threads; dynamic shared memory:
// the epilogue's staged planes, Epi::STAGED x PAIR x BN floats.
template <int BN, class Epi>
__global__ void __launch_bounds__(dense_f32::BM * BN / 64)
dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ at, Epi epi, int m_rows,
                 int k_depth, int n_cols) {
  using namespace dense_f32;
  constexpr int TX = BN / 8;  // threads along n
  constexpr int THREADS = BM * BN / 64;
  constexpr int A_CHUNKS = BK * BM / 4;  // 16-byte copies of a slot's A slice
  constexpr int B_CHUNKS = BK * BN / 4;
  __shared__ __align__(16) float sa[STAGES][BK][BM];
  __shared__ __align__(16) float sb[STAGES][BK][BN];
  extern __shared__ __align__(16) float sw[];  // [Epi::STAGED][PAIR][BN]

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
    if constexpr (Epi::STAGED > 0) {
      if (s == 0) {  // the tile's staged planes, in this iteration's copy group
        static_assert(PAIR * BN / 4 % THREADS == 0, "whole 16-byte copies a thread");
#pragma unroll
        for (int p = 0; p < Epi::STAGED; ++p) {
          const float* src = epi.staged_src(p, m0);
#pragma unroll
          for (int i = 0; i < PAIR * BN / 4 / THREADS; ++i) {
            const int q = t + i * THREADS;
            const int r = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
            cp_async16(sw + (p * PAIR + r) * BN + c4, src + (size_t)r * epi.ld + n0 + c4);
          }
        }
      }
    }
    const int next = s + STAGES - 1;
    if (next < slices) issue(next, next % STAGES);
    cp_async_commit();
    const int slot = s % STAGES;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = lds4(&sa[slot][k][ty * 4]);
      const float4 a1 = lds4(&sa[slot][k][PAIR + ty * 4]);
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
  if constexpr (Epi::STAGED > 0) __syncthreads();  // everyone's planes have landed

  // Rows m0 + ty * 4 + i and that + PAIR in pairs, columns n0 + c.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ty * 4 + i, c = h * (BN / 2) + tx * 4;
      const float* lo = &acc[i][h * 4];
      const float* hi = &acc[i + 4][h * 4];
      const float4 vlo = make_float4(lo[0], lo[1], lo[2], lo[3]);
      const float4 vhi = make_float4(hi[0], hi[1], hi[2], hi[3]);
      if constexpr (Epi::STAGED == 0) {
        epi.store(b, m0 + r, n0 + c, vlo, vhi);
      } else {
        float4 w[Epi::STAGED];
#pragma unroll
        for (int p = 0; p < Epi::STAGED; ++p) w[p] = lds4(sw + (p * PAIR + r) * BN + c);
        epi.store(b, m0 + r, n0 + c, vlo, vhi, w);
      }
    }
  }
}

// Launch over x (B, K, N) and at (K, M) in BM x BN tiles, a tile a block.
// A staged epilogue's planes take dynamic shared memory beyond the default
// 48 KB a block at BN = 128; the attribute is set once per device and
// instantiation, so a launch captured into a CUDA graph makes no such call.
// Returns cudaGetLastError() or the refusal.
template <int BN, class Epi>
int launch_dense_f32(const float* x, const float* at, Epi epi, int batch, int m_rows, int k_depth,
                     int n_cols, void* stream) {
  using namespace dense_f32;
  constexpr int MAX_DEVICES = 64;
  constexpr int SMEM = Epi::STAGED * PAIR * BN * (int)sizeof(float);
  static bool smem_set[MAX_DEVICES];
  if (batch < 1 || batch > 65535 || k_depth < BK || k_depth % BK || m_rows % BM || n_cols % BN ||
      m_rows / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if constexpr (SMEM > 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!smem_set[dev]) {
      e = cudaFuncSetAttribute(dense_f32_kernel<BN, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
      if (e != cudaSuccess) {
        cudaGetLastError();  // leave no error behind for the next launch to report
        return (int)e;
      }
      smem_set[dev] = true;
    }
  }
  const dim3 grid(n_cols / BN, m_rows / BM, batch);
  dense_f32_kernel<BN, Epi><<<grid, BM * BN / 64, SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, at, epi, m_rows, k_depth, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace gft

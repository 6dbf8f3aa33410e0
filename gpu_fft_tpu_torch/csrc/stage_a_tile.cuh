// The tiled column-DFT product of K3-legacy: stage A on a plan with a
// materialized twiddle (stage_a.cu, gft_stage_a_full), replacing the Pallas
// kernel gpu_fft_tpu/kernels/fused.py:153 / :162 (stage_a on such a plan).
// K3 itself, on the production plan's factored twiddle, is a radix FFT
// (stage_a.cu, radix.cuh); S3's f32 dot moved to dense_f32.cuh.
//
// Over a (B, n1, n2) view of x it computes, for k1 < rows and c < ncols,
//   P[b, k1, c] = sum_a F1[k1, a] x[b, a, c]
// and writes Y = P * W[k1, c], W = tw[k1 * n2 + c] a materialized (n1, n2)
// table read with coalesced float4 loads in the epilogue.
//
// What bounds it on an H100: at 2^20, n1 = 128, all rows, 543 MFLOP -> 8.1 us
// at 67 TFLOP/s of fp32 FMA, against 21 MB (x, twiddle, output) -> 6.3 us at
// 3.35 TB/s: the FMA pipes.
//
// Design: each block computes a TM x TN output tile, staging TK-deep slices
// of F1 (transposed, padded against bank conflicts) and of x (float4,
// coalesced) through shared memory, 2 x 8 outputs per thread in registers.
// Where n1 is not a multiple of TK (the legacy sweep's n1 = 16) the depth
// tile is masked; that is its own instantiation (DEPTH_MASK), so the main
// path's n1 of 128 or 256 runs the unmasked loop.
// fp32 FMA on CUDA cores, 4-product complex arithmetic.  Offsets are 64-bit:
// B * n passes 2^31 at B = 128, n = 2^24.  The register-tiled, cp.async-ringed
// core of dense_f32.cuh is its successor; K3-legacy moves onto it next.
#pragma once

#include "common.cuh"

namespace gft {

namespace stage_a_tile {
constexpr int TM = 32;   // output rows k1 per block
constexpr int TN = 128;  // output columns c per block
constexpr int TK = 32;   // contraction depth per shared-memory stage
constexpr int THREADS = 256;
}  // namespace stage_a_tile

// twr / twi: the (n1, n2) twiddle.
template <bool COMPLEX, bool DEPTH_MASK>
__global__ void __launch_bounds__(stage_a_tile::THREADS)
stage_a_tile_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ f1r, const float* __restrict__ f1i,
                    const float* __restrict__ twr, const float* __restrict__ twi,
                    float* __restrict__ yr, float* __restrict__ yi, int n1, int n2, int rows,
                    int ncols, int col_blocks) {
  using namespace stage_a_tile;
  __shared__ float sfr[TK][TM + 1];
  __shared__ float sfi[TK][TM + 1];
  __shared__ __align__(16) float sxr[TK][TN];
  __shared__ __align__(16) float sxi[COMPLEX ? TK : 1][TN];

  const int t = threadIdx.x;
  const int tx = t % 16;  // column group: c = tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = t / 16;  // row pair: k1 = ty*2 + {0, 1}
  const long long b = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) * TN;
  const int row0 = blockIdx.y * TM;
  const float* xrb = xr + (size_t)b * n1 * n2;
  const float* xib = COMPLEX ? xi + (size_t)b * n1 * n2 : nullptr;

  float ar[2][8], ai[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ar[i][j] = ai[i][j] = 0.f;

  for (int a0 = 0; a0 < n1; a0 += TK) {
    // F1 tile: rows row0.., depth a0..; coalesced along a, stored [a][row].
#pragma unroll
    for (int i = 0; i < (TM * TK) / THREADS; ++i) {
      const int q = t + i * THREADS;
      const int r = q / TK, k = q % TK;
      const bool ok = row0 + r < rows && (!DEPTH_MASK || a0 + k < n1);
      const size_t off = (size_t)(row0 + r) * n1 + a0 + k;
      sfr[k][r] = ok ? __ldg(f1r + off) : 0.f;
      sfi[k][r] = ok ? __ldg(f1i + off) : 0.f;
    }
    // x tile: depth a0.., columns col0..; float4 per thread, zero past the edge.
#pragma unroll
    for (int i = 0; i < (TK * TN) / (4 * THREADS); ++i) {
      const int q = t + i * THREADS;
      const int k = q / (TN / 4), c4 = (q % (TN / 4)) * 4;
      const bool ok = col0 + c4 < ncols && (!DEPTH_MASK || a0 + k < n1);
      const size_t off = (size_t)(a0 + k) * n2 + col0 + c4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&sxr[k][c4]) = ok ? ldg4(xrb + off) : zero;
      if constexpr (COMPLEX) *reinterpret_cast<float4*>(&sxi[k][c4]) = ok ? ldg4(xib + off) : zero;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float fr[2] = {sfr[k][ty * 2], sfr[k][ty * 2 + 1]};
      const float fi[2] = {sfi[k][ty * 2], sfi[k][ty * 2 + 1]};
      float vr[8], vi[8];
      const float4 v0 = lds4(&sxr[k][tx * 4]);
      const float4 v1 = lds4(&sxr[k][64 + tx * 4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = f4(v0, q);
        vr[4 + q] = f4(v1, q);
      }
      if constexpr (COMPLEX) {
        const float4 w0 = lds4(&sxi[k][tx * 4]);
        const float4 w1 = lds4(&sxi[k][64 + tx * 4]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          vi[q] = f4(w0, q);
          vi[4 + q] = f4(w1, q);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ar[i][j] = fmaf(fr[i], vr[j], ar[i][j]);
          ai[i][j] = fmaf(fi[i], vr[j], ai[i][j]);
          if constexpr (COMPLEX) {
            ar[i][j] = fmaf(-fi[i], vi[j], ar[i][j]);
            ai[i][j] = fmaf(fr[i], vi[j], ai[i][j]);
          }
        }
    }
    __syncthreads();
  }

  // Epilogue: Y = P * W.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k1 = row0 + ty * 2 + i;
    if (k1 >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cb = col0 + h * 64 + tx * 4;
      if (cb >= ncols) continue;
      // W for the four columns cb..cb+3.
      const float4 full_r = ldg4(twr + (size_t)k1 * n2 + cb);
      const float4 full_i = ldg4(twi + (size_t)k1 * n2 + cb);
      float outr[4], outi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float pr = ar[i][h * 4 + q], pi = ai[i][h * 4 + q];
        const float wr = f4(full_r, q), wi = f4(full_i, q);
        outr[q] = pr * wr - pi * wi;
        outi[q] = pr * wi + pi * wr;
      }
      const size_t o = ((size_t)b * rows + k1) * ncols + cb;
      *reinterpret_cast<float4*>(yr + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(yi + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
    }
  }
}

// Launch over (B, n1, n2) -> (B, rows, ncols); returns cudaGetLastError().
inline int launch_stage_a_tile(const float* xr, const float* xi, const float* f1r, const float* f1i,
                        const float* twr, const float* twi, float* yr, float* yi, int batch,
                        int n1, int n2, int rows, int ncols, void* stream) {
  using namespace stage_a_tile;
  if (batch < 1 || n1 < 1 || n2 % 4 || ncols % 4 || ncols < 4 || ncols > n2 || rows < 1 ||
      rows > n1)
    return (int)cudaErrorInvalidValue;
  const long long col_blocks = (ncols + TN - 1) / TN;
  if (col_blocks * batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(col_blocks * batch), (rows + TM - 1) / TM);
  const bool mask = n1 % TK != 0;
  const auto kernel = xi ? (mask ? stage_a_tile_kernel<true, true> : stage_a_tile_kernel<true, false>)
                         : (mask ? stage_a_tile_kernel<false, true> : stage_a_tile_kernel<false, false>);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, f1r, f1i, twr, twi, yr, yi, n1, n2, rows, ncols, (int)col_blocks);
  return (int)cudaGetLastError();
}

}  // namespace gft

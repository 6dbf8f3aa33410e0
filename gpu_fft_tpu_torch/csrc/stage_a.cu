// Stage A of the staged large-n transform: column DFT + factored twiddle.
//
// Replaces the Pallas kernel gpu_fft_tpu/kernels/fused.py:stage_a (the
// factored-twiddle bodies _stage_a_real_kernel / _stage_a_complex_kernel and
// _tw_block).  Over a (B, n1, n2) view of x it computes, for k1 < rows and
// c < ncols,
//   Y[b, k1, c] = (sum_a F1[k1, a] x[b, a, c]) * two[k1, c / ct] * twi[k1, c % ct]
// where two (n1, n2/ct) and twi (n1, ct) are the plan's factored twiddle and
// ct is the PLAN's column tile (this kernel's own tile width is TN).
//
// What bounds it on an H100: a batched (rows x n1) @ (n1 x ncols) product
// with n1 <= 256, so each output costs only n1 complex MACs while x is read
// from device memory once per row tile; at these depths the kernel sits near
// the memory/compute balance point of the CUDA cores.  The design: each block
// computes a TM x TN output tile, staging TK-deep slices of F1 (transposed,
// padded against bank conflicts) and of x (float4, coalesced) through shared
// memory, 2 x 8 outputs per thread in registers, and applies the twiddle in
// the epilogue so the (n1, n2) twiddle is never read from memory.  fp32 FMA
// on CUDA cores, 4-product complex arithmetic.  Offsets are 64-bit: B * n
// passes 2^31 at B = 128, n = 2^24.
#include "common.cuh"

namespace {

constexpr int TM = 32;   // output rows k1 per block
constexpr int TN = 128;  // output columns c per block
constexpr int TK = 32;   // contraction depth per shared-memory stage
constexpr int THREADS = 256;

template <bool COMPLEX>
__global__ void __launch_bounds__(THREADS)
stage_a_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ f1r, const float* __restrict__ f1i,
               const float* __restrict__ two_r, const float* __restrict__ two_i,
               const float* __restrict__ twi_r, const float* __restrict__ twi_i,
               float* __restrict__ yr, float* __restrict__ yi, int n1, int n2, int ct, int rows,
               int ncols, int col_blocks) {
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
      const bool ok = row0 + r < rows;
      const size_t off = (size_t)(row0 + r) * n1 + a0 + k;
      sfr[k][r] = ok ? __ldg(f1r + off) : 0.f;
      sfi[k][r] = ok ? __ldg(f1i + off) : 0.f;
    }
    // x tile: depth a0.., columns col0..; float4 per thread, zero past ncols.
#pragma unroll
    for (int i = 0; i < (TK * TN) / (4 * THREADS); ++i) {
      const int q = t + i * THREADS;
      const int k = q / (TN / 4), c4 = (q % (TN / 4)) * 4;
      const bool ok = col0 + c4 < ncols;
      const size_t off = (size_t)(a0 + k) * n2 + col0 + c4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&sxr[k][c4]) = ok ? gft::ldg4(xrb + off) : zero;
      if constexpr (COMPLEX) *reinterpret_cast<float4*>(&sxi[k][c4]) = ok ? gft::ldg4(xib + off) : zero;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float fr[2] = {sfr[k][ty * 2], sfr[k][ty * 2 + 1]};
      const float fi[2] = {sfi[k][ty * 2], sfi[k][ty * 2 + 1]};
      float vr[8], vi[8];
      const float4 v0 = gft::lds4(&sxr[k][tx * 4]);
      const float4 v1 = gft::lds4(&sxr[k][64 + tx * 4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = gft::f4(v0, q);
        vr[4 + q] = gft::f4(v1, q);
      }
      if constexpr (COMPLEX) {
        const float4 w0 = gft::lds4(&sxi[k][tx * 4]);
        const float4 w1 = gft::lds4(&sxi[k][64 + tx * 4]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          vi[q] = gft::f4(w0, q);
          vi[4 + q] = gft::f4(w1, q);
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

  // Epilogue: W[k1, c] = two[k1, c / ct] * twi[k1, c % ct], then Y = P * W.
  const int n_outer = n2 / ct;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k1 = row0 + ty * 2 + i;
    if (k1 >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cb = col0 + h * 64 + tx * 4;
      if (cb >= ncols) continue;
      float outr[4], outi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = cb + q;
        const float o_r = __ldg(two_r + (size_t)k1 * n_outer + c / ct);
        const float o_i = __ldg(two_i + (size_t)k1 * n_outer + c / ct);
        const float in_r = __ldg(twi_r + (size_t)k1 * ct + c % ct);
        const float in_i = __ldg(twi_i + (size_t)k1 * ct + c % ct);
        const float wr = o_r * in_r - o_i * in_i;
        const float wi = o_r * in_i + o_i * in_r;
        const float pr = ar[i][h * 4 + q], pi = ai[i][h * 4 + q];
        outr[q] = pr * wr - pi * wi;
        outi[q] = pr * wi + pi * wr;
      }
      const size_t o = ((size_t)b * rows + k1) * ncols + cb;
      *reinterpret_cast<float4*>(yr + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(yi + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
    }
  }
}

}  // namespace

extern "C" int gft_stage_a(const float* xr, const float* xi, const float* f1r, const float* f1i,
                           const float* two_r, const float* two_i, const float* twi_r,
                           const float* twi_i, float* yr, float* yi, int batch, int n1, int n2,
                           int ct, int rows, int ncols, void* stream) {
  if (batch < 1 || n1 % TK || ct < 4 || ct % 4 || n2 % ct || ncols % 4 || ncols < 4 ||
      ncols > n2 || rows < 1 || rows > n1)
    return (int)cudaErrorInvalidValue;
  const long long col_blocks = (ncols + TN - 1) / TN;
  if (col_blocks * batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(col_blocks * batch), (rows + TM - 1) / TM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xi)
    stage_a_kernel<true><<<grid, THREADS, 0, s>>>(xr, xi, f1r, f1i, two_r, two_i, twi_r, twi_i, yr,
                                                  yi, n1, n2, ct, rows, ncols, (int)col_blocks);
  else
    stage_a_kernel<false><<<grid, THREADS, 0, s>>>(xr, xi, f1r, f1i, two_r, two_i, twi_r, twi_i,
                                                   yr, yi, n1, n2, ct, rows, ncols,
                                                   (int)col_blocks);
  return (int)cudaGetLastError();
}

// The tiled column-DFT kernel shared by stage A (K3, K3-legacy) and the f32
// variant of the stage-A dot ablation (S3 f32_highest).
//
// Over a (B, n1, n2) view of x it computes, for k1 < rows and c < ncols,
//   P[b, k1, c] = sum_a F1[k1, a] x[b, a, c]
// and writes Y = P * W[k1, c], where the twiddle W comes from one of three
// sources (the TW template parameter):
//   TW_NONE      W = 1: the bare product (S3's f32 variant);
//   TW_FACTORED  W = two[k1, c / ct] * twi[k1, c % ct], the production plan's
//                factored table, rebuilt in the epilogue (K3);
//   TW_FULL      W = tw[k1 * n2 + c], a materialized (n1, n2) table read with
//                coalesced float4 loads in the epilogue (K3-legacy).
//
// Design: each block computes a TM x TN output tile, staging TK-deep slices
// of F1 (transposed, padded against bank conflicts) and of x (float4,
// coalesced) through shared memory, 2 x 8 outputs per thread in registers.
// Where n1 is not a multiple of TK (the legacy sweep's n1 = 16) the depth
// tile is masked; that is its own instantiation (DEPTH_MASK), so the main
// path's n1 of 128 or 256 runs the unmasked loop.
// fp32 FMA on CUDA cores, 4-product complex arithmetic.  Offsets are 64-bit:
// B * n passes 2^31 at B = 128, n = 2^24.
#pragma once

#include "common.cuh"

namespace gft {

constexpr int TW_NONE = 0;
constexpr int TW_FACTORED = 1;
constexpr int TW_FULL = 2;

namespace stage_a_tile {
constexpr int TM = 32;   // output rows k1 per block
constexpr int TN = 128;  // output columns c per block
constexpr int TK = 32;   // contraction depth per shared-memory stage
constexpr int THREADS = 256;
}  // namespace stage_a_tile

// tw_a / tw_b: two_r / two_i (TW_FACTORED) or twr / twi (TW_FULL);
// tw_c / tw_d: twi_r / twi_i (TW_FACTORED only).
template <bool COMPLEX, int TW, bool DEPTH_MASK>
__global__ void __launch_bounds__(stage_a_tile::THREADS)
stage_a_tile_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ f1r, const float* __restrict__ f1i,
                    const float* __restrict__ tw_a, const float* __restrict__ tw_b,
                    const float* __restrict__ tw_c, const float* __restrict__ tw_d,
                    float* __restrict__ yr, float* __restrict__ yi, int n1, int n2, int ct,
                    int rows, int ncols, int col_blocks) {
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
  const int n_outer = TW == TW_FACTORED ? n2 / ct : 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k1 = row0 + ty * 2 + i;
    if (k1 >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cb = col0 + h * 64 + tx * 4;
      if (cb >= ncols) continue;
      float4 full_r, full_i;  // TW_FULL: W for the four columns cb..cb+3
      if constexpr (TW == TW_FULL) {
        full_r = ldg4(tw_a + (size_t)k1 * n2 + cb);
        full_i = ldg4(tw_b + (size_t)k1 * n2 + cb);
      }
      float outr[4], outi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float pr = ar[i][h * 4 + q], pi = ai[i][h * 4 + q];
        if constexpr (TW == TW_NONE) {
          outr[q] = pr;
          outi[q] = pi;
        } else {
          float wr, wi;
          if constexpr (TW == TW_FULL) {
            wr = f4(full_r, q);
            wi = f4(full_i, q);
          } else {
            const int c = cb + q;
            const float o_r = __ldg(tw_a + (size_t)k1 * n_outer + c / ct);
            const float o_i = __ldg(tw_b + (size_t)k1 * n_outer + c / ct);
            const float in_r = __ldg(tw_c + (size_t)k1 * ct + c % ct);
            const float in_i = __ldg(tw_d + (size_t)k1 * ct + c % ct);
            wr = o_r * in_r - o_i * in_i;
            wi = o_r * in_i + o_i * in_r;
          }
          outr[q] = pr * wr - pi * wi;
          outi[q] = pr * wi + pi * wr;
        }
      }
      const size_t o = ((size_t)b * rows + k1) * ncols + cb;
      *reinterpret_cast<float4*>(yr + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(yi + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
    }
  }
}

// Launch over (B, n1, n2) -> (B, rows, ncols); returns cudaGetLastError().
template <int TW>
int launch_stage_a_tile(const float* xr, const float* xi, const float* f1r, const float* f1i,
                        const float* tw_a, const float* tw_b, const float* tw_c,
                        const float* tw_d, float* yr, float* yi, int batch, int n1, int n2,
                        int ct, int rows, int ncols, void* stream) {
  using namespace stage_a_tile;
  if (batch < 1 || n1 < 1 || n2 % 4 || ncols % 4 || ncols < 4 || ncols > n2 || rows < 1 ||
      rows > n1)
    return (int)cudaErrorInvalidValue;
  const long long col_blocks = (ncols + TN - 1) / TN;
  if (col_blocks * batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(col_blocks * batch), (rows + TM - 1) / TM);
  const bool mask = n1 % TK != 0;
  const auto kernel = xi ? (mask ? stage_a_tile_kernel<true, TW, true>
                                 : stage_a_tile_kernel<true, TW, false>)
                         : (mask ? stage_a_tile_kernel<false, TW, true>
                                 : stage_a_tile_kernel<false, TW, false>);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, f1r, f1i, tw_a, tw_b, tw_c, tw_d, yr, yi, n1, n2, ct, rows, ncols, (int)col_blocks);
  return (int)cudaGetLastError();
}

}  // namespace gft

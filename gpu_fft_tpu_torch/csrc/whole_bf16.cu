// K1F and K2F: the whole four-step of a B = 1 transform on the bf16 tensor
// cores, the "fast" (GPU_FFT_TPU_PRECISION=fast) counterparts of K1 / K2.
//
// Replaces gpu_fft_tpu/kernels/fused.py:whole_transform (K1, bodies
// _whole_real_kernel / _whole_complex_kernel and _whole_stage2) and
// whole_transform_packed (K2, _whole_packed_real_kernel /
// _whole_packed_complex_kernel) as they run under "fast", where every dot
// takes lax.Precision.DEFAULT: bf16 operands, fp32 accumulation.  Per row
// of n = n1 * 128 (x viewed (n1, 128) = [a, c]):
//   stage 1  P (n1 x 128) = F1 (n1 x n1) X, K1 in the Karatsuba form
//            (complex input) and K2 in the 4-product form of its stacked
//            [F1r; F1i]; real input takes Fr x and Fi x in both;
//   twiddle  Z = P * TW in fp32, then Z rounded to bf16 as stage 2 takes it;
//   stage 2  Y (128 x n1) = F2 (128 x 128) Z^T (the contraction over c),
//            K1 Karatsuba, K2 4-product; Y[j, k1] is the natural-order
//            spectrum k = k1 + n1 * j.
// The products are mma_bf16.cuh's.  A DFT table is read from its fragment
// image in global memory (L2-resident: at most 4 x 32 KB for F1 and
// 4 x 32 KB for F2); x and Z live in shared memory as bf16 operands.
//
// What bounds it on an H100: at n = 16,384 (n1 = 128) complex input, K1F
// takes 3 + 3 products of 128^3 multiply-adds, 25 MFLOP -> 0.025 us at
// 989 TFLOP/s, and moves 2 x 64 KB in and 128 KB out -> 0.08 us at
// 3.35 TB/s; both are far under the ~1 us a launch costs.  On one SM the
// same products take ~14 us of mma.sync work (B = 1 on the path), so a row
// is spread over n1 / 16 blocks.
//
// Layout: the k1 rows split the work with no exchange between blocks:
// Z's row k1 needs F1's row k1 and all of x, and Y's column k1 needs Z's
// row k1 alone.  So block (b, r) of 512 threads owns rows k1 = 16 r ..
// 16 r + 15 (n1 = 8: one block, rows and depth padded to 16 with zeros):
// it loads all of row b's x, converts it to its bf16 operands (REAL2: x;
// KARA3: xr + xi, xr, xi; FOUR4: xr, xi) stored [c][a] in shared memory;
// 4 warps take its 16-row tile of stage 1 (32 columns each), apply the
// twiddle to their accumulators and store Z's operands [k1][c]; after a
// barrier 8 warps take the 16-row tiles of j in stage 2 and write Y's
// columns k1.  Each block reads x (at most 128 KB) from L2 after the
// first.
#include <cuda_bf16.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace gft::bf16mma;

constexpr int N2 = 128;       // row length of the (n1, 128) view
constexpr int LD2 = N2 + 8;   // stage-2 operand row (bf16): depth c
constexpr int THREADS = 512;
constexpr int NT = 4;         // column tiles of a stage-1 unit (32 columns of c)
constexpr int ROWS = 16;      // k1 rows of a block (one m-tile)
constexpr int NT2 = ROWS / 8; // column tiles of a stage-2 unit (the block's k1)

__host__ __device__ constexpr int depth1(int n1) { return n1 < ROWS ? ROWS : n1; }

template <int F1, int F2>
constexpr int whole_smem(int n1) {
  return 2 * (Form<F1>::NB * N2 * (depth1(n1) + 8) + Form<F2>::NB * ROWS * LD2);
}

template <int F1, int F2>
__global__ void __launch_bounds__(THREADS)
whole_bf16_kernel(const float* __restrict__ xr, const float* __restrict__ xi, const uint4* __restrict__ img1,
                  const uint4* __restrict__ img2, const float* __restrict__ twr,
                  const float* __restrict__ twi, float* __restrict__ yr, float* __restrict__ yi, int n1) {
  using P1 = Form<F1>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = depth1(n1);
  const int ld1 = kp + 8;
  __nv_bfloat16* s1 = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NB1][c][a]
  __nv_bfloat16* s2 = s1 + P1::NB * N2 * ld1;                       // [NB2][k1 - k0][c]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.x * n1 * N2;
  const int mt = blockIdx.y, k0 = ROWS * mt;  // this block's tile of k1 rows
  const int rows = n1 < ROWS ? n1 : ROWS;

  // x -> stage 1's operands: unit u is column u % 128, depths 8 (u / 128) + 0..7.
  for (int u = tid; u < kp / 8 * N2; u += blockDim.x) {
    const int c = u % N2, a0 = u / N2 * 8;
    float re[8], im[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int a = a0 + j;
      re[j] = a < n1 ? xr[base + (size_t)a * N2 + c] : 0.f;
      im[j] = (xi != nullptr && a < n1) ? xi[base + (size_t)a * N2 + c] : 0.f;
    }
    store_operands<F1>(s1, N2 * ld1, ld1, c, a0, re, im);
  }
  __syncthreads();

  // Stage 1 and the twiddle: unit = 32 columns of c of the block's rows.
  const int mt1 = kp / 16;
  for (int unit = warp; unit < N2 / 32; unit += warps) {
    const int n0 = unit * 32;
    float acc[P1::NQ][NT][4];
    warp_tile<F1, NT>(acc, img1, mt1 * mt1 * 32, mt, mt1, s1, N2 * ld1, ld1, n0, NT, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kl = g + 8 * h, k1 = k0 + kl;
        if (kl < rows) {
          const int c = n0 + 8 * j + 2 * t;
          const float2 w_r = *reinterpret_cast<const float2*>(twr + k1 * N2 + c);
          const float2 w_i = *reinterpret_cast<const float2*>(twi + k1 * N2 + c);
          const float2 p0 = combined<F1>(acc, j, 2 * h), p1 = combined<F1>(acc, j, 2 * h + 1);
          float zr[2] = {p0.x * w_r.x - p0.y * w_i.x, p1.x * w_r.y - p1.y * w_i.y};
          float zi[2] = {p0.x * w_i.x + p0.y * w_r.x, p1.x * w_i.y + p1.y * w_r.y};
          __nv_bfloat16 lo[Form<F2>::NB], hi[Form<F2>::NB];
          Form<F2>::fill(zr[0], zi[0], lo);
          Form<F2>::fill(zr[1], zi[1], hi);
#pragma unroll
          for (int o = 0; o < Form<F2>::NB; ++o)
            *reinterpret_cast<uint32_t*>(s2 + (o * ROWS + kl) * LD2 + c) = pack2(lo[o], hi[o]);
        }
      }
    }
  }
  __syncthreads();

  // Stage 2: unit = a 16-row tile of j, against the block's rows / 8
  // column tiles of k1.
  for (int unit = warp; unit < N2 / 16; unit += warps) {
    float acc[Form<F2>::NQ][NT2][4];
    warp_tile<F2, NT2>(acc, img2, (N2 / 16) * (N2 / 16) * 32, unit, N2 / 16, s2, ROWS * LD2, LD2, 0, rows / 8,
                       lane);
#pragma unroll
    for (int j = 0; j < NT2; ++j) {
      if (j < rows / 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * unit + g + 8 * h, k1 = k0 + 8 * j + 2 * t;
          const float2 v0 = combined<F2>(acc, j, 2 * h), v1 = combined<F2>(acc, j, 2 * h + 1);
          const size_t at = base + (size_t)row * n1 + k1;
          *reinterpret_cast<float2*>(yr + at) = make_float2(v0.x, v1.x);
          *reinterpret_cast<float2*>(yi + at) = make_float2(v0.y, v1.y);
        }
      }
    }
  }
}

int g_smem[4][MAX_DEVICES];

template <int F1, int F2>
int launch(const float* xr, const float* xi, const void* img1, const void* img2, const float* twr,
           const float* twi, float* yr, float* yi, int batch, int n1, cudaStream_t s, int slot) {
  const int smem = whole_smem<F1, F2>(n1);
  const int err = allow_smem(whole_bf16_kernel<F1, F2>, smem, g_smem[slot]);
  if (err) return err;
  const dim3 grid(batch, n1 < ROWS ? 1 : n1 / ROWS);
  whole_bf16_kernel<F1, F2><<<grid, THREADS, smem, s>>>(xr, xi, static_cast<const uint4*>(img1),
                                                         static_cast<const uint4*>(img2), twr, twi, yr, yi,
                                                         n1);
  return (int)cudaGetLastError();
}

}  // namespace

// img1: F1's fragment image (slots r, i, s, d for K1; r, i for K2), n1
// padded to 16; img2: F2's (128 x 128); twr, twi: the (n1, 128) twiddle;
// xi null for real input; packed selects K2's product forms.
extern "C" int gft_whole_bf16(const float* xr, const float* xi, const void* img1, const void* img2,
                              const float* twr, const float* twi, float* yr, float* yi, int batch, int n1,
                              int packed, void* stream) {
  if (batch < 1 || batch > 65535 || n1 < 8 || n1 > 128 || (n1 & (n1 - 1))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool real = xi == nullptr;
  if (packed) {
    if (real) return launch<REAL2, FOUR4>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, s, 0);
    return launch<FOUR4, FOUR4>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, s, 1);
  }
  if (real) return launch<REAL2, KARA3>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, s, 2);
  return launch<KARA3, KARA3>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, s, 3);
}

// K3F and K3-legacy-fast (K3LF): stage A of the staged transform on the
// bf16 tensor cores, the "fast" (GPU_FFT_TPU_PRECISION=fast) counterparts
// of K3 and K3-legacy (stage_a.cu).
//
// Replaces gpu_fft_tpu/kernels/fused.py:stage_a as it runs under "fast",
// where its dots take lax.Precision.DEFAULT, in both of its plan layouts:
// K3F the factored twiddle (bodies _stage_a_real_kernel /
// _stage_a_complex_kernel with _tw_block, :109 / :128), K3LF the
// materialized (n1, n2) table of the ablation harnesses' plans (bodies
// _stage_a_real_kernel_full / _stage_a_complex_kernel_full, :153 / :162).
// Over a (B, n1, n2) view,
//   P[k1, c] = sum_a F1[k1, a] x[a, c]   (real input Fr x and Fi x; complex
//              input Karatsuba: Fr (xr + xi), Fd xr, Fs xi)
// with x rounded to bf16 as it is loaded (fp32 in device memory) and fp32
// accumulation, then Y = P * W in fp32, W from one of twiddle.cuh's
// sources: Factored, W[k1, c] = two[k1, c / ct] * twi[k1, c % ct], as
// stage_a.cu applies it, or Table, W[k1, c] = twr + i twi at k1 * n2 + c.
// `rows` keeps the first k1 rows (the real-input half-row cut) and `ncols`
// the first columns (the irfft fold's first column tiles).
//
// What bounds it on an H100: memory.  At 2^20 (n1 = 128, n2 = 8,192) real
// input with rows = 72, K3F reads x (4 MB) and writes 72 / 128 of the
// complex output (4.7 MB): 8.7 MB -> 2.6 us at 3.35 TB/s, against
// 2 x 72 x 128 x 8,192 multiply-adds (0.30 GFLOP) -> 0.3 us at 989 TFLOP/s.
// K3LF also reads the table, 8 bytes an output: 21.0 MB -> 6.3 us at 2^20
// real input, all rows, against 0.54 GFLOP -> 0.5 us.
//
// Layout: one block of 256 threads per 32 columns of one signal.  The
// block loads its (n1, 32) tile of x once, converts it to its bf16
// operands (REAL2: x; KARA3: xr + xi, xr, xi) and stores them [c][a] in
// shared memory; its 8 warps walk the 16-row tiles of the kept rows with
// mma_bf16.cuh's products, F1 read from its fragment image (L2-resident),
// and each applies the twiddle to its accumulators and stores them: a
// lane's two values of a row are an even column pair, so it reads the
// pair's twiddle with 8-byte loads (Table: one float2 a plane) and stores
// each output plane as one float2.  A block does not overlap its loads
// with its products: the other blocks on the SM do, which is why the tile
// is 32 columns and not 64: 1.06-1.81x faster at 2^17 ... 2^22 on an H100
// 80GB HBM3 (700 W), but 2% slower on the irfft tiles at 2^22 and 9%
// slower at 2^24 real input.
#include <cuda_bf16.h>

#include <cstdint>

#include "mma_bf16.cuh"
#include "twiddle.cuh"

namespace {

using namespace gft::bf16mma;

constexpr int CW = 32;  // columns of a block
constexpr int THREADS = 256;
constexpr int NT = CW / 8;  // column tiles of a warp's unit: the block's columns

template <int F>
constexpr int stage_a_smem(int n1) {
  return 2 * Form<F>::NB * CW * (n1 + 8);
}

template <int F, class Tw>
__global__ void __launch_bounds__(THREADS)
stage_a_bf16_kernel(const float* __restrict__ xr, const float* __restrict__ xi, const uint4* __restrict__ img,
                    Tw tw, float* __restrict__ yr, float* __restrict__ yi, int n1, int n2, int rows, int ncols) {
  using P = Form<F>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NB][c][a]
  const int ld = n1 + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * CW, b = blockIdx.y;
  const size_t xbase = (size_t)b * n1 * n2 + c0;

  // x -> the operands: unit u is column u % 32, depths 8 (u / 32) + 0..7.
  for (int u = tid; u < n1 / 8 * CW; u += blockDim.x) {
    const int c = u % CW, a0 = u / CW * 8;
    float re[8], im[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t at = xbase + (size_t)(a0 + j) * n2 + c;
      re[j] = xr[at];
      im[j] = xi != nullptr ? xi[at] : 0.f;
    }
    store_operands<F>(sx, CW * ld, ld, c, a0, re, im);
  }
  __syncthreads();

  const int kts = n1 / 16, mts = (rows + 15) / 16;
  for (int mt = warp; mt < mts; mt += warps) {
    float acc[P::NQ][NT][4];
    warp_tile<F, NT>(acc, img, kts * kts * 32, mt, kts, sx, CW * ld, ld, 0, NT, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k1 = 16 * mt + g + 8 * h;
        if (k1 < rows) {
          const int c = c0 + 8 * j + 2 * t;  // even: the pair c, c + 1
          float2 w[2];
          tw.pair(k1, c, w);
          float out_r[2], out_i[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 p = combined<F>(acc, j, 2 * h + e);
            out_r[e] = p.x * w[e].x - p.y * w[e].y;
            out_i[e] = p.x * w[e].y + p.y * w[e].x;
          }
          const size_t at = ((size_t)b * rows + k1) * ncols + c;
          *reinterpret_cast<float2*>(yr + at) = make_float2(out_r[0], out_r[1]);
          *reinterpret_cast<float2*>(yi + at) = make_float2(out_i[0], out_i[1]);
        }
      }
    }
  }
}

// Per instantiation: the shared-memory attribute's record.
template <int F, class Tw>
int g_smem[MAX_DEVICES];

template <int F, class Tw>
int launch(const float* xr, const float* xi, const void* img, const Tw& tw, float* yr, float* yi, int batch,
           int n1, int n2, int rows, int ncols, cudaStream_t s) {
  const int smem = stage_a_smem<F>(n1);
  const int err = allow_smem(stage_a_bf16_kernel<F, Tw>, smem, g_smem<F, Tw>);
  if (err) return err;
  stage_a_bf16_kernel<F, Tw><<<dim3(ncols / CW, batch), THREADS, smem, s>>>(
      xr, xi, static_cast<const uint4*>(img), tw, yr, yi, n1, n2, rows, ncols);
  return (int)cudaGetLastError();
}

// The limits both entries share: n1 a multiple of 16 in [16, 512], rows a
// multiple of 8 in [8, n1], ncols a multiple of 32 in [32, n2], n2 even.
bool refused(int batch, int n1, int n2, int rows, int ncols) {
  return batch < 1 || batch > 65535 || n1 < 16 || n1 > 512 || n1 % 16 || rows < 8 || rows > n1 || rows % 8 ||
         n2 % 2 || ncols < CW || ncols % CW || ncols > n2;
}

template <class Tw>
int launch_form(const float* xr, const float* xi, const void* img, const Tw& tw, float* yr, float* yi,
                int batch, int n1, int n2, int rows, int ncols, void* stream) {
  if (refused(batch, n1, n2, rows, ncols)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xi == nullptr) return launch<REAL2>(xr, xi, img, tw, yr, yi, batch, n1, n2, rows, ncols, s);
  return launch<KARA3>(xr, xi, img, tw, yr, yi, batch, n1, n2, rows, ncols, s);
}

}  // namespace

// K3F.  img: F1's fragment image, slots r, i, s, d (n1 x n1 each); two_*
// the (n1, n2 / ct) outer and twi_* the (n1, ct) inner twiddle factor, ct
// even; xi null for real input; y* (batch, rows, ncols).
extern "C" int gft_stage_a_bf16(const float* xr, const float* xi, const void* img, const float* two_r,
                                const float* two_i, const float* twi_r, const float* twi_i, float* yr,
                                float* yi, int batch, int n1, int n2, int ct, int rows, int ncols,
                                void* stream) {
  if (ct < 2 || ct % 2 || n2 % ct) return (int)cudaErrorInvalidValue;
  const gft::Factored tw{two_r, two_i, twi_r, twi_i, n2 / ct, ct};
  return launch_form(xr, xi, img, tw, yr, yi, batch, n1, n2, rows, ncols, stream);
}

// K3LF: the same with the materialized (n1, n2) table twr / twi.
extern "C" int gft_stage_a_bf16_full(const float* xr, const float* xi, const void* img, const float* twr,
                                     const float* twi, float* yr, float* yi, int batch, int n1, int n2, int rows,
                                     int ncols, void* stream) {
  const gft::Table tw{twr, twi, n2};
  return launch_form(xr, xi, img, tw, yr, yi, batch, n1, n2, rows, ncols, stream);
}

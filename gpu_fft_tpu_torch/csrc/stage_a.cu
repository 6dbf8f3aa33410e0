// Stage A of the staged large-n transform: column DFT + twiddle.
//
// Replaces the Pallas kernel gpu_fft_tpu/kernels/fused.py:188 stage_a in both
// of its plan layouts, with one radix kernel and two twiddle sources:
//   * K3, the factored twiddle (bodies :109 _stage_a_real_kernel / :128
//     _stage_a_complex_kernel, and _tw_block):
//       Y[b, k1, c] = (sum_a w_n1^(a k1) x[b, a, c]) * two[k1, c / ct] * twi[k1, c % ct]
//     for k1 < rows and c < ncols, where two (n1, n2/ct) and twi (n1, ct) are
//     the plan's factored twiddle and ct its column tile (Factored);
//   * K3-legacy, a materialized (n1, n2) twiddle (:153 / :162): the same sum
//     times tw[k1 * n2 + c] (Table, gft_stage_a_full).
// Both sources are twiddle.cuh's.
//
// What bounds it on an H100: the bytes.  A radix FFT of a column of n1 = 128
// costs 5 log2 n1 = 35 FLOP a point.  At 2^20, real input, rows = 72, that
// is 40 MFLOP (0.6 us on the fp32 CUDA cores) against x (4.2 MB), Y (4.7 MB)
// and the twi rows (1.2 MB), 3.0 us at 3.35 TB/s: 4 FLOP a byte, where the
// cores would bound it only above ~20.  The materialized table adds 8 bytes
// an output (8.4 MB at 2^20, all rows).  The TPU kernel wrote the column DFT
// as a dense (rows, n1) x (n1, ct) product, which the MXU makes nearly free;
// on CUDA cores that is 306 MFLOP at 2^20, with x read once per row tile.
//
// Design: one block per (row b, tile of W columns of the (n1, n2) view); the
// column DFTs are independent, so no cluster.  Radix-8 Stockham passes over
// n1 (the last of radix 8, 4 or 2), 8 complex values a thread in registers
// per pass, the (n1, W) tile in shared memory between passes (radix.cuh).
// The first pass reads x straight from global memory at row stride n2, a
// warp's lanes on neighbouring columns (coalesced); each thread loads the
// twiddle of the 8 outputs it will write (under x's loads for real input, in
// the last pass for complex), with the same lanes on neighbouring columns,
// so the table's rows are read coalesced too; the last pass multiplies by
// that twiddle and stores Y[b, k1, c] for k1 < rows only, coalesced along c.
// x is read once, Y written once, and no value touches global memory in
// between.  The wrapper (kernels/fused.py: stage_a_geometry) picks W, the
// block size n1 W / 8 and the dynamic shared memory, for either source.  A
// refused launch is returned as an error; nothing falls back.
#include "radix.cuh"
#include "twiddle.cuh"

namespace gft {
namespace {

// The root table (row 1 of F1) and the extent of the output.
struct StageA {
  const float *w1r, *w1i;
  int rows, ncols;
};

// The twiddle of the outputs of a radix-R pass from 2^lNs over 2^lW columns
// (stockham_pass's mapping; slot e = u R + r): tw.at(k1, c) for output k1 of
// column c = col0 + m, and 0 where the output is not stored.
template <int R, class Tw>
__device__ __forceinline__ void load_twiddle(float2* out, int T, int lNs, int lW, int col0,
                                             const StageA& p, const Tw& tw) {
  constexpr int LR = ilog2(R);
  const int ns = 1 << lNs;
#pragma unroll
  for (int u = 0; u < E / R; ++u) {
    const int q = threadIdx.x + u * T;
    const int m = q & ((1 << lW) - 1), j = q >> lW, k = j & (ns - 1);
    const int d = ((j - k) << LR) + k;
    const int c = col0 + m;
    const auto col = tw.column(c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k1 = d + r * ns;
      float2 w = make_float2(0.f, 0.f);
      if (k1 < p.rows && c < p.ncols) w = tw.at(k1, col);
      out[u * R + r] = w;
    }
  }
}

// Block (b, g): the length-n1 DFTs of columns [g W, (g+1) W) of row b's
// (n1, n2) view, W = 2^lW, with n1 W / 8 threads.
template <bool COMPLEX, class Tw>
__global__ void __launch_bounds__(1024) stage_a_radix_kernel(const float* __restrict__ xr,
                                                             const float* __restrict__ xi, StageA p,
                                                             Tw src, float* __restrict__ yr,
                                                             float* __restrict__ yi, int n1, int n2,
                                                             int lW, int col_blocks) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int ln1 = ilog2(n1);
  const size_t b = blockIdx.x / col_blocks;
  const int col0 = (blockIdx.x % col_blocks) << lW;

  extern __shared__ float2 smem[];
  float2* tile = smem;               // (n1, W) = [a][c], then the passes' results
  float2* w1 = smem + (n1 << lW);    // w_n1^a

  const float s = __ldg(p.w1i + n1 / 4) > 0.f ? 1.f : -1.f;  // Im w_n1^(n1/4) = sign
  for (int i = t; i < n1; i += T) w1[i] = make_float2(__ldg(p.w1r + i), __ldg(p.w1i + i));

  // Radix-8 passes, the last of radix 8, 2 or 4 (2^lRl) from 2^lNsl.
  const int lRl = ln1 % 3 == 0 ? 3 : ln1 % 3, lNsl = ln1 - lRl;
  float2 tw[E];
  auto twiddle = [&] {
    if (lRl == 3) load_twiddle<8>(tw, T, lNsl, lW, col0, p, src);
    else if (lRl == 2) load_twiddle<4>(tw, T, lNsl, lW, col0, p, src);
    else load_twiddle<2>(tw, T, lNsl, lW, col0, p, src);
  };
  // The twiddle is loaded between a pass's reads and its butterflies: for
  // real input in the first pass, under x's loads; for complex input in the
  // last, so that its registers are not held through the passes beside
  // x's two parts (8.5% less time at 2^22, 1.4% more for real input).
  auto first_sync = [&] {
    if constexpr (!COMPLEX) twiddle();
  };
  auto last_sync = [&] {
    if constexpr (COMPLEX) twiddle();
  };
  auto block_sync = [] { __syncthreads(); };

  const float* xrb = xr + b * n1 * n2 + col0;
  const float* xib = COMPLEX ? xi + b * n1 * n2 + col0 : nullptr;
  auto from_x = [&](int, int m, int l) {
    return make_float2(__ldg(xrb + (size_t)l * n2 + m), COMPLEX ? __ldg(xib + (size_t)l * n2 + m) : 0.f);
  };
  auto from_tile = [&](int, int m, int l) { return tile[(l << lW) + m]; };
  auto to_tile = [&](int, int m, int l, float2 v) { tile[(l << lW) + m] = v; };
  const int rows = p.rows, ncols = p.ncols;
  float* yrb = yr + b * rows * ncols + col0;
  float* yib = yi + b * rows * ncols + col0;
  auto to_y = [&](int e, int m, int l, float2 v) {
    if (l < rows && col0 + m < ncols) {
      const float2 z = cmul(v, tw[e]);
      yrb[(size_t)l * ncols + m] = z.x;
      yib[(size_t)l * ncols + m] = z.y;
    }
  };
  if (lNsl == 0) {  // n1 = 8: one pass
    stockham_pass<8>(T, ln1, 0, lW, w1, s, from_x, twiddle, to_y);
    return;
  }
  stockham_pass<8>(T, ln1, 0, lW, w1, s, from_x, first_sync, to_tile);
  for (int lNs = 3; lNs < lNsl; lNs += 3) {
    __syncthreads();
    stockham_pass<8>(T, ln1, lNs, lW, w1, s, from_tile, block_sync, to_tile);
  }
  __syncthreads();
  // The last pass writes only Y: no barrier between its reads and writes.
  if (lRl == 3) stockham_pass<8>(T, ln1, lNsl, lW, w1, s, from_tile, last_sync, to_y);
  else if (lRl == 2) stockham_pass<4>(T, ln1, lNsl, lW, w1, s, from_tile, last_sync, to_y);
  else stockham_pass<2>(T, ln1, lNsl, lW, w1, s, from_tile, last_sync, to_y);
}

template <bool COMPLEX, class Tw>
cudaError_t launch_one(const float* xr, const float* xi, const StageA& p, const Tw& tw, float* yr,
                       float* yi, int n1, int n2, int width, int col_blocks, unsigned blocks,
                       int threads, int smem, cudaStream_t stream) {
  static bool done[MAX_DEVICES];
  const cudaError_t e = configure(stage_a_radix_kernel<COMPLEX, Tw>, false, done);
  if (e != cudaSuccess) return e;
  stage_a_radix_kernel<COMPLEX, Tw><<<blocks, threads, smem, stream>>>(xr, xi, p, tw, yr, yi, n1, n2,
                                                                      ilog2(width), col_blocks);
  return cudaSuccess;
}

// n1: a power of two in [8, 512]; width: a power of two dividing n2,
// threads = n1 * width / 8 <= 1024, smem >= (n1 * width + n1) * 8 bytes;
// rows in [1, n1], ncols a multiple of 4 in [4, n2].  F1 is (n1, n1): its
// row 1 starts at n1.  Returns the launch's error, then cudaGetLastError().
template <class Tw>
int launch_radix(const float* xr, const float* xi, const float* f1r, const float* f1i, const Tw& tw,
                 float* yr, float* yi, int batch, int n1, int n2, int rows, int ncols, int width,
                 int threads, int smem, void* stream) {
  if (!pow2(n1) || n1 < 8 || n1 > 512 || !pow2(width) || n2 % width || batch < 1 ||
      (long long)n1 * width != (long long)threads * E || threads > 1024 ||
      (long long)smem < ((long long)n1 * width + n1) * (long long)sizeof(float2) || rows < 1 ||
      rows > n1 || ncols < 4 || ncols % 4 || ncols > n2)
    return (int)cudaErrorInvalidValue;
  const long long col_blocks = (ncols + width - 1) / width;
  if (col_blocks * batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const StageA p{f1r + n1, f1i + n1, rows, ncols};
  const auto launch = xi ? launch_one<true, Tw> : launch_one<false, Tw>;
  const cudaError_t e = launch(xr, xi, p, tw, yr, yi, n1, n2, width, (int)col_blocks,
                               (unsigned)(col_blocks * batch), threads, smem,
                               static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace
}  // namespace gft

// K3, the factored twiddle: ct a multiple of 4 dividing n2; the rest as
// launch_radix takes it.
extern "C" int gft_stage_a(const float* xr, const float* xi, const float* f1r, const float* f1i,
                           const float* two_r, const float* two_i, const float* twi_r,
                           const float* twi_i, float* yr, float* yi, int batch, int n1, int n2,
                           int ct, int rows, int ncols, int width, int threads, int smem,
                           void* stream) {
  if (ct < 4 || ct % 4 || n2 % ct) return (int)cudaErrorInvalidValue;
  const gft::Factored tw{two_r, two_i, twi_r, twi_i, n2 / ct, ct};
  return gft::launch_radix(xr, xi, f1r, f1i, tw, yr, yi, batch, n1, n2, rows, ncols, width, threads,
                           smem, stream);
}

// K3-legacy, the materialized (n1, n2) twiddle twr / twi.
extern "C" int gft_stage_a_full(const float* xr, const float* xi, const float* f1r,
                                const float* f1i, const float* twr, const float* twi, float* yr,
                                float* yi, int batch, int n1, int n2, int rows, int ncols,
                                int width, int threads, int smem, void* stream) {
  const gft::Table tw{twr, twi, n2};
  return gft::launch_radix(xr, xi, f1r, f1i, tw, yr, yi, batch, n1, n2, rows, ncols, width, threads,
                           smem, stream);
}

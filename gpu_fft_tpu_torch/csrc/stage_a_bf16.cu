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
// Design: dot_bf16.cuh's wgmma kernel, the one S3 and S2F run.  F1 stays
// resident in shared memory (its pre-swizzled image, kernels/fused.py:
// stage_a_bf16_image, brought in by bulk copies under the first x loads);
// blocks are persistent and walk the 64-column tiles of all B signals; x
// streams through two 64-deep chunk buffers as 8-byte loads, split into
// its bf16 operands while the previous chunk's wgmmas run; the epilogue
// (TwiddleRows) multiplies the staged planes by W and stores 16-byte
// words, masked at k1 >= rows and c >= ncols.
// - Real input (X1) reads S2's stacking: per 32 output rows their Fr rows
//   then their Fi rows, so one 64-row warpgroup tile holds Re and Im of 32
//   rows; the row cut keeps ceil(rows / 32) groups (3 at rows = 72).
// - Complex input (Kara3) reads three parts (Fr, Fd, Fs) of the same 64
//   output rows; two warpgroups share a group, each on 32 of a tile's
//   columns with three accumulator sets, combined into Re and Im in
//   registers before staging.  At n1 > 320 one group's parts do not fit a
//   block: they stream through two chunk buffers (STREAM).
// The launch rule (kernels/fused.py:stage_a_bf16_geometry) gives the
// groups a block holds and the persistent grid; where the groups do not
// fit one block (n1 = 256), the row blocks of a column tile run side by
// side and the later ones read x from L2.
#include "dot_bf16.cuh"

namespace {

using namespace gft::dot_bf16;

// The limits both entries share: n1 a multiple of 16 in [16, 512], rows a
// multiple of 8 in [8, n1], ncols a multiple of 32 in [32, n2], n2 even.
bool refused(int batch, int n1, int n2, int rows, int ncols, int grid) {
  return batch < 1 || n1 < 16 || n1 > 512 || n1 % 16 || rows < 8 || rows > n1 || rows % 8 || n2 % 2 ||
         ncols < 32 || ncols % 32 || ncols > n2 || grid < 1;
}

// img: kernels/fused.py:stage_a_bf16_image, the real-input stacking's
// ceil(n1 / 32) one-part groups, then the Karatsuba parts' ceil(n1 / 64)
// three-part groups, each (group, part) ceil(n1 / 64) swizzled 8 KB chunks.
template <class Tw>
int launch(const float* xr, const float* xi, const void* img, const Tw& tw, float* yr, float* yi, int batch,
           int n1, int n2, int rows, int ncols, int wgs, int grid, void* stream) {
  if (refused(batch, n1, n2, rows, ncols, grid)) return (int)cudaErrorInvalidValue;
  const auto* f = static_cast<const unsigned char*>(img);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xi == nullptr) {
    const TwiddleRows<32, Tw> epi{tw, yr, yi, rows, ncols};
    const int groups = (rows + 31) / 32;
    if (wgs == 1) return launch_dot_bf16<X1, 1>(xr, nullptr, f, 1, epi, batch, n1, n2, ncols, groups, grid, s);
    if (wgs == 2) return launch_dot_bf16<X1, 2>(xr, nullptr, f, 1, epi, batch, n1, n2, ncols, groups, grid, s);
    if (wgs == 3) return launch_dot_bf16<X1, 3>(xr, nullptr, f, 1, epi, batch, n1, n2, ncols, groups, grid, s);
    if (wgs == 4) return launch_dot_bf16<X1, 4>(xr, nullptr, f, 1, epi, batch, n1, n2, ncols, groups, grid, s);
    return (int)cudaErrorInvalidValue;
  }
  const TwiddleRows<64, Tw> epi{tw, yr, yi, rows, ncols};
  const int groups = (rows + 63) / 64;
  f += (size_t)(n1 + 31) / 32 * ((n1 + KA - 1) / KA) * KA * ROW;  // past the real-input groups
  if (dot_smem_bytes<Kara3>(wgs, n1, false) <= SMEM_MAX) {
    if (wgs == 1) return launch_dot_bf16<Kara3, 1>(xr, xi, f, 3, epi, batch, n1, n2, ncols, groups, grid, s);
    if (wgs == 2) return launch_dot_bf16<Kara3, 2>(xr, xi, f, 3, epi, batch, n1, n2, ncols, groups, grid, s);
    return (int)cudaErrorInvalidValue;
  }
  if (wgs == 1) return launch_dot_bf16<Kara3, 1, true>(xr, xi, f, 3, epi, batch, n1, n2, ncols, groups, grid, s);
  if (wgs == 2) return launch_dot_bf16<Kara3, 2, true>(xr, xi, f, 3, epi, batch, n1, n2, ncols, groups, grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3F.  img: F1's image (stage_a_bf16_image); two_* the (n1, n2 / ct) outer
// and twi_* the (n1, ct) inner twiddle factor, ct even; xi null for real
// input; y* (batch, rows, ncols); wgs warpgroups a block and grid
// persistent blocks from stage_a_bf16_geometry.
extern "C" int gft_stage_a_bf16(const float* xr, const float* xi, const void* img, const float* two_r,
                                const float* two_i, const float* twi_r, const float* twi_i, float* yr,
                                float* yi, int batch, int n1, int n2, int ct, int rows, int ncols, int wgs,
                                int grid, void* stream) {
  if (ct < 2 || ct % 2 || n2 % ct) return (int)cudaErrorInvalidValue;
  const gft::Factored tw{two_r, two_i, twi_r, twi_i, n2 / ct, ct};
  return launch(xr, xi, img, tw, yr, yi, batch, n1, n2, rows, ncols, wgs, grid, stream);
}

// K3LF: the same with the materialized (n1, n2) table twr / twi.
extern "C" int gft_stage_a_bf16_full(const float* xr, const float* xi, const void* img, const float* twr,
                                     const float* twi, float* yr, float* yi, int batch, int n1, int n2, int rows,
                                     int ncols, int wgs, int grid, void* stream) {
  const gft::Table tw{twr, twi, n2};
  return launch(xr, xi, img, tw, yr, yi, batch, n1, n2, rows, ncols, wgs, grid, stream);
}

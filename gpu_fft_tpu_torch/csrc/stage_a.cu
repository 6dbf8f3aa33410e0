// Stage A of the staged large-n transform: column DFT + twiddle.
//
// Replaces the Pallas kernel gpu_fft_tpu/kernels/fused.py:stage_a in both of
// its plan layouts:
//   * K3, the factored twiddle (bodies _stage_a_real_kernel /
//     _stage_a_complex_kernel and _tw_block):
//       Y[b, k1, c] = (sum_a F1[k1, a] x[b, a, c]) * two[k1, c / ct] * twi[k1, c % ct]
//     where two (n1, n2/ct) and twi (n1, ct) are the plan's factored twiddle
//     and ct is the PLAN's column tile (the kernel's own tile width is TN);
//   * K3-legacy, a materialized (n1, n2) twiddle (_stage_a_real_kernel_full /
//     _stage_a_complex_kernel_full), read as tw[k1 * n2 + c] with coalesced
//     float4 loads in the epilogue.
// Both support `rows` (the first k1 rows only) and a column limit ncols (the
// first col_tiles plan tiles); the kernel itself is stage_a_tile.cuh.
//
// What bounds it on an H100: a batched (rows x n1) @ (n1 x ncols) product
// with n1 <= 512, so each output costs only n1 complex MACs while x is read
// from device memory once per row tile; at these depths the kernel sits near
// the memory/compute balance point of the CUDA cores.  At n = 2^20, n1 = 128,
// real input, all rows: 543 MFLOP -> 8.1 us at 67 TFLOP/s fp32, against
// 21 MB -> 6.3 us at 3.35 TB/s for the legacy layout, of which its twiddle is
// 8.4 MB; the factored layout reads ~0.3 MB of twiddle instead.  The design
// keeps the twiddle out of the inner loop: it is applied once per output in
// the epilogue, either rebuilt from the two factors (K3) or streamed as
// float4 (K3-legacy).
#include "stage_a_tile.cuh"

extern "C" int gft_stage_a(const float* xr, const float* xi, const float* f1r, const float* f1i,
                           const float* two_r, const float* two_i, const float* twi_r,
                           const float* twi_i, float* yr, float* yi, int batch, int n1, int n2,
                           int ct, int rows, int ncols, void* stream) {
  if (ct < 4 || ct % 4 || n2 % ct) return (int)cudaErrorInvalidValue;
  return gft::launch_stage_a_tile<gft::TW_FACTORED>(xr, xi, f1r, f1i, two_r, two_i, twi_r, twi_i,
                                                    yr, yi, batch, n1, n2, ct, rows, ncols,
                                                    stream);
}

extern "C" int gft_stage_a_full(const float* xr, const float* xi, const float* f1r,
                                const float* f1i, const float* twr, const float* twi, float* yr,
                                float* yi, int batch, int n1, int n2, int rows, int ncols,
                                void* stream) {
  return gft::launch_stage_a_tile<gft::TW_FULL>(xr, xi, f1r, f1i, twr, twi, nullptr, nullptr, yr,
                                                yi, batch, n1, n2, 1, rows, ncols, stream);
}

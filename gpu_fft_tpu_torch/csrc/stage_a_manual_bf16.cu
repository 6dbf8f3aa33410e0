// S2F: stage A on a materialized twiddle as one bf16 dense product, the
// "fast" (GPU_FFT_TPU_PRECISION=fast) counterpart of S2 (stage_a_manual.cu).
//
// Replaces the Pallas kernel scripts/ablate_2e20_levers.py:stage_a_manual
// as it runs under "fast", where its dots (`inner`, :160-162) take
// cfg.mosaic_precision(), lax.Precision.DEFAULT: real x (n1, n2), the
// (n1, n1) column DFT F1 and a materialized (n1, n2) twiddle,
//   yr + i yi = (Fr x + i Fi x) * (twr + i twi)
// with Fr, Fi and x rounded to bf16 (to nearest even), fp32 accumulation,
// and the twiddle product in fp32.
//
// What bounds it on an H100: memory.  At n = 2^20 it reads x (4.2 MB) and
// the table (8.4 MB) and writes Yr and Yi (8.4 MB): 21 MB -> 6.3 us at
// 3.35 TB/s, for n1 = 128 and 256 alike, against 2 x 2 n1 x 2^20 bf16
// FLOP -> 0.54 us (n1 = 128) and 1.07 us (n1 = 256) at 989 TFLOP/s.
//
// Design: S2's schedule, F1 kept on chip while x streams past, is S3's
// bf16 x1 kernel (dot_bf16.cuh: F resident in shared memory from a
// pre-swizzled image by bulk copies, persistent blocks, x in 64-deep
// chunks, wgmma m64n64k16), here on S2's stacking of the LHS
// (kernels/ablation.py:manual_tables "f_img"): for every 32 output rows,
// their Fr rows then their Fi rows, so each 64-row warpgroup tile holds Re
// and Im of the same 32 output rows.  Its epilogue is K3LF's
// (dot_bf16.cuh:TwiddleRows on twiddle.cuh's Table): it reads both planes
// of a row pair from the staging tile, multiplies them by the row's twr /
// twi (16-byte loads, coalesced along the row) and stores Yr and Yi as
// 16-byte words.  S2F is K3LF at B = 1 on real input with every row kept.
// The launch shape (warpgroups a block, persistent blocks) comes from the
// pure rule kernels/ablation.py:manual_bf16_geometry, S3's bf16 x1 rule at
// B = 1.
#include "dot_bf16.cuh"

// fimg: the swizzled bf16 image of S2's stacked table, one part a 64-row
// group (manual_tables "f_img"); n1 a multiple of 32 in [32, 256], n2 of
// 64; wgs warpgroups a block (64 stacked rows each) and grid persistent
// blocks from manual_bf16_geometry.
extern "C" int gft_stage_a_manual_bf16(const float* x, const void* fimg, const float* twr, const float* twi,
                                       float* yr, float* yi, int n1, int n2, int wgs, int grid, void* stream) {
  using namespace gft::dot_bf16;
  if (n1 < 32 || n1 % 32 || n1 > 256 || n2 < BN || n2 % BN || grid < 1 || wgs < 1 || (2 * n1) % (64 * wgs))
    return (int)cudaErrorInvalidValue;
  const auto* f = static_cast<const unsigned char*>(fimg);
  const TwiddleRows<32, gft::Table> epi{gft::Table{twr, twi, n2}, yr, yi, n1, n2};
  const int groups = 2 * n1 / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgs == 1) return launch_dot_bf16<X1, 1>(x, nullptr, f, 1, epi, 1, n1, n2, n2, groups, grid, s);
  if (wgs == 2) return launch_dot_bf16<X1, 2>(x, nullptr, f, 1, epi, 1, n1, n2, n2, groups, grid, s);
  if (wgs == 4) return launch_dot_bf16<X1, 4>(x, nullptr, f, 1, epi, 1, n1, n2, n2, groups, grid, s);
  return (int)cudaErrorInvalidValue;
}

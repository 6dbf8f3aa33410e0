// Stage A on a materialized twiddle as one dense product (S2).
//
// Replaces the Pallas kernel scripts/ablate_2e20_levers.py:stage_a_manual
// (bodies `outer`, which drives pltpu.emit_pipeline over the column tiles
// from inside ONE kernel instance, and `inner`): real x (n1, n2), the
// (n1, n1) column DFT F1 and a materialized (n1, n2) twiddle,
//   yr + i yi = (F1 x) * (twr + i twi).
// It is K3-legacy's function at B = 1 on real input.  The TPU kernel's
// schedule (F1 kept on chip while x streams past) is one that only a dense
// product has, so S2 runs on the dense core.
//
// What bounds it on an H100: at n = 2^20, n1 = 128, 543 MFLOP -> 8.1 us at
// 67 TFLOP/s fp32 (the wall), against 21 MB (x 4.2, twiddle 8.4, output
// 8.4) -> 6.3 us at 3.35 TB/s.
//
// Design: dense_f32.cuh's core over the (2 n1, n2) product of the stacked
// table (kernels/ablation.py: manual_tables "f_stack"): for every 32 output
// rows k1, their Fr rows then their Fi rows form one 64-row block,
// pre-transposed to (n1, 2 n1).  A block takes one 64-row block of it and
// one column tile of x, both through the cp.async ring, one wave in all; a
// thread's pairs of rows 32 apart are then the real and imaginary parts of
// one output row, so the epilogue below multiplies by the twiddle in
// registers and stores Yr and Yi.  The twiddle's 32 x BN tile is staged in
// shared memory with the tile's first slice, so its read is under the
// FMAs.  The column tile BN comes from the pure rule
// kernels/ablation.py: manual_geometry (64, faster than 128 there).  A
// persistent walk over column tiles with the block's F1 rows resident lost
// to this one wave at 2^20 on an H100 (PERF.md, section 6).
#include "dense_f32.cuh"

namespace {

// Pair (Re, Im) of stacked rows m, m + 32 -> output row k1, times the
// twiddle of that row, staged by the kernel as the planes twr, twi.
struct TwiddleRows {
  static constexpr int STAGED = 2;
  const float* twr;
  const float* twi;
  float* yr;
  float* yi;
  int ld;  // n2
  __device__ __forceinline__ const float* staged_src(int p, int m0) const {
    return (p ? twi : twr) + (size_t)(m0 / gft::dense_f32::BM * gft::dense_f32::PAIR) * ld;
  }
  __device__ __forceinline__ void store(int, int m, int n, float4 re, float4 im,
                                        const float4 (&w)[2]) const {
    using gft::dense_f32::BM;
    using gft::dense_f32::PAIR;
    const size_t o = (size_t)(m / BM * PAIR + m % BM) * ld + n;
    const float4 wr = w[0], wi = w[1];
    *reinterpret_cast<float4*>(yr + o) = make_float4(re.x * wr.x - im.x * wi.x, re.y * wr.y - im.y * wi.y,
                                                     re.z * wr.z - im.z * wi.z, re.w * wr.w - im.w * wi.w);
    *reinterpret_cast<float4*>(yi + o) = make_float4(re.x * wi.x + im.x * wr.x, re.y * wi.y + im.y * wr.y,
                                                     re.z * wi.z + im.z * wr.z, re.w * wi.w + im.w * wr.w);
  }
};

}  // namespace

// f_stack: the (n1, 2 n1) stacked table; n1 a multiple of 32 in [32, 256],
// n2 a multiple of bn (64 or 128).
extern "C" int gft_stage_a_manual(const float* x, const float* f_stack, const float* twr,
                                  const float* twi, float* yr, float* yi, int n1, int n2, int bn,
                                  void* stream) {
  if (n1 < 32 || n1 % 32 || n1 > 256) return (int)cudaErrorInvalidValue;
  const TwiddleRows epi{twr, twi, yr, yi, n2};
  if (bn == 64) return gft::launch_dense_f32<64>(x, f_stack, epi, 1, 2 * n1, n1, n2, stream);
  if (bn == 128) return gft::launch_dense_f32<128>(x, f_stack, epi, 1, 2 * n1, n1, n2, stream);
  return (int)cudaErrorInvalidValue;
}

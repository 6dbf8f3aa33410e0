// The stage-A dot in three precisions (S3).
//
// Replaces the Pallas kernel of scripts/ablate_mosaic_x6.py:build (bodies
// kern_f32, kern_x6, kern_x1): Yr = Fr x and Yi = Fi x for a constant
// (n1, n1) pair (Fr, Fi) against x (B, n1, n2), in
//   f32_highest  fp32 FMA on the CUDA cores;
//   bf16_x6      the 6-term bf16 ladder of _x6: F arrives split on the host
//                into three bf16 parts (split3_bf16), x is split in the
//                kernel with __float2bfloat16_rn (round to nearest even, as
//                astype does), and the products
//                  a1b1 + (a1b2 + a2b1) + (a1b3 + a2b2 + a3b1)
//                run on the tensor cores with fp32 accumulators, one
//                accumulator per parenthesised group, summed in that order;
//   bf16_x1      one bf16 product of the rounded operands.
// Both kernels read the LHS stacked, [Fr; Fi] as one (2 n1, n1) operand:
// stacked rows below n1 go to Yr, the rest to Yi.
//
// What bounds it on an H100, at n1 = 128, n2 = 8192: f32 does 537 MFLOP ->
// 8.0 us at 67 TFLOP/s (compute); bf16_x6 does 3.2 GFLOP -> 3.3 us at
// 989 TFLOP/s but moves 12.7 MB (x read, Yr and Yi written) -> 3.8 us at
// 3.35 TB/s, so memory is the wall, as it is for bf16_x1 (3.8 us).
//
// f32: dense_f32.cuh (64 x 64 block tiles, 8 x 8 outputs a thread, a
// cp.async ring over the depth, one wave) on the pre-transposed stacked
// table, its epilogue splitting the stacked rows into Yr and Yi.
//
// bf16: dot_bf16.cuh's wgmma kernel (F resident in shared memory from a
// pre-swizzled image by bulk copies, persistent blocks, x in 64-deep
// chunks; dot_tables "f_img"), its epilogue splitting the staged stacked
// rows into Yr and Yi.  The launch rule (kernels/ablation.py:dot_geometry)
// takes the largest row block whose block fits the shared memory: 256
// stacked rows for x1 and 128 for x6 at n1 = 128.
#include "dense_f32.cuh"
#include "dot_bf16.cuh"

namespace {

// ── f32 ─────────────────────────────────────────────────────────────────────

// Stacked rows [Fr; Fi] of the product -> Yr, Yi; rows m and m + PAIR.
struct SplitRows {
  static constexpr int STAGED = 0;
  float* yr;
  float* yi;
  int n1, n2;
  __device__ __forceinline__ void put(int b, int m, int n, float4 v) const {
    float* y = m < n1 ? yr : yi;
    const int r = m < n1 ? m : m - n1;
    *reinterpret_cast<float4*>(y + ((size_t)b * n1 + r) * n2 + n) = v;
  }
  __device__ __forceinline__ void store(int b, int m, int n, float4 lo, float4 hi) const {
    put(b, m, n, lo);
    put(b, m + gft::dense_f32::PAIR, n, hi);
  }
};

// ── bf16 on wgmma (dot_bf16.cuh) ─────────────────────────────────────────────

// Staged stacked rows [Fr; Fi] -> Yr, Yi, as 16-byte stores.
struct StagedSplit {
  float* yr;
  float* yi;
  int n1, n2;
  template <int RB, int THREADS>
  __device__ __forceinline__ void store(const float* stg, int m0, int b, int c0, int t) const {
    using gft::dot_bf16::BN;
    using gft::dot_bf16::SLD;
#pragma unroll
    for (int i = 0; i < RB * BN / 4 / THREADS; ++i) {
      const int q = t + i * THREADS;
      const int r = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
      const int m = m0 + r;
      float* y = m < n1 ? yr : yi;
      const int row = m < n1 ? m : m - n1;
      *reinterpret_cast<float4*>(y + ((size_t)b * n1 + row) * n2 + c0 + c4) =
          *reinterpret_cast<const float4*>(stg + r * SLD + c4);
    }
  }
};

}  // namespace

// at: the (n1, 2 n1) stacked table [Fr; Fi] transposed.
extern "C" int gft_stage_a_dot_f32(const float* x, const float* at, float* yr, float* yi,
                                   int batch, int n1, int n2, void* stream) {
  return gft::launch_dense_f32<64>(x, at, SplitRows{yr, yi, n1, n2}, batch, 2 * n1, n1, n2, stream);
}

// fimg: the swizzled image of the stacked bf16 parts (dot_tables "f_img",
// three parts a row group); wgs consumer warpgroups a block (64 stacked
// rows each), grid persistent blocks (dot_geometry).
extern "C" int gft_stage_a_dot_bf16(const float* x, const void* fimg, float* yr, float* yi, int batch,
                                    int n1, int n2, int parts, int wgs, int grid, void* stream) {
  using namespace gft::dot_bf16;
  if (batch < 1 || n1 < 32 || n1 % 32 || n2 < BN || n2 % BN || grid < 1 || wgs < 1 || (2 * n1) % (64 * wgs))
    return (int)cudaErrorInvalidValue;
  const auto* f = static_cast<const unsigned char*>(fimg);
  const StagedSplit epi{yr, yi, n1, n2};
  const int groups = 2 * n1 / 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts == 1 && wgs == 1) return launch_dot_bf16<X1, 1>(x, nullptr, f, 3, epi, batch, n1, n2, n2, groups, grid, s);
  if (parts == 1 && wgs == 2) return launch_dot_bf16<X1, 2>(x, nullptr, f, 3, epi, batch, n1, n2, n2, groups, grid, s);
  if (parts == 1 && wgs == 4) return launch_dot_bf16<X1, 4>(x, nullptr, f, 3, epi, batch, n1, n2, n2, groups, grid, s);
  if (parts == 3 && wgs == 1) return launch_dot_bf16<X6, 1>(x, nullptr, f, 3, epi, batch, n1, n2, n2, groups, grid, s);
  if (parts == 3 && wgs == 2) return launch_dot_bf16<X6, 2>(x, nullptr, f, 3, epi, batch, n1, n2, n2, groups, grid, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 tensor-core products for the "fast" kernels K1F / K2F
// (whole_bf16.cuh): mma.sync m16n8k16, bf16 operands, fp32 accumulators,
// as the JAX bodies' dots compute under lax.Precision.DEFAULT
// (gpu_fft_tpu/kernels/fused.py:_dot, _dot_nt).
//
// A (the DFT table, 16 rows a tile) arrives as a "fragment image" built on
// the host (kernels/fused.py:frag_image): per table slot, per 16-row tile,
// per 16-deep tile, 32 lanes x 8 bf16 in the order of the mma's A
// registers, so one 16-byte read a lane loads a fragment.  B (the data)
// lies in shared memory as [column][depth], depth contiguous, so each B
// register is one 32-bit read.
//
// A kernel that keeps a table on chip holds the NS slots a form reads, in
// the order table(0 .. NS - 1) of the image's slots; product q reads its
// held slot sidx(q) (warp_tile_smem).
//
// A complex product takes one of three forms, each a set of real products
// P_q = A_slot(q) x B_operand(q) and a combination:
//   REAL2  real data x:       P0 = Fr x, P1 = Fi x;          (P0, P1)
//   KARA3  Karatsuba:         P0 = Fr (xr + xi), P1 = Fd xr,
//                             P2 = Fs xi;                    (P0 - P2, P0 + P1)
//   FOUR4  the 4-product one: P0 = Fr xr, P1 = Fi xr,
//                             P2 = Fr xi, P3 = Fi xi;        (P0 - P3, P1 + P2)
// with Fs = Fr + Fi and Fd = Fi - Fr (plan.py's f64-derived tables).  The
// operands are rounded to bf16 where the dot takes them: xr + xi is summed
// in fp32 first.  Each P_q keeps its own accumulator and the combination
// runs in fp32, as the JAX bodies combine their dots.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace gft {
namespace bf16mma {

enum FormId { REAL2 = 0, KARA3 = 1, FOUR4 = 2 };

// Table slots of a fragment image.
enum Slot { SLOT_R = 0, SLOT_I = 1, SLOT_S = 2, SLOT_D = 3 };

template <int F>
struct Form;

template <>
struct Form<REAL2> {
  static constexpr int NQ = 2;  // products
  static constexpr int NB = 1;  // bf16 operands of the data
  static constexpr int NS = 2;  // table slots read: r, i
  __device__ __forceinline__ static int table(int s) { return s; }
  __device__ __forceinline__ static int sidx(int q) { return q; }
  __device__ __forceinline__ static int operand(int) { return 0; }
  __device__ __forceinline__ static void fill(float re, float, __nv_bfloat16 (&o)[NB]) {
    o[0] = __float2bfloat16_rn(re);
  }
  __device__ __forceinline__ static float2 combine(const float (&p)[NQ]) { return make_float2(p[0], p[1]); }
};

template <>
struct Form<KARA3> {
  static constexpr int NQ = 3;
  static constexpr int NB = 3;  // xr + xi, xr, xi
  static constexpr int NS = 3;  // r, d, s
  __device__ __forceinline__ static int table(int s) { return s == 0 ? SLOT_R : s == 1 ? SLOT_D : SLOT_S; }
  __device__ __forceinline__ static int sidx(int q) { return q; }
  __device__ __forceinline__ static int operand(int q) { return q; }
  __device__ __forceinline__ static void fill(float re, float im, __nv_bfloat16 (&o)[NB]) {
    o[0] = __float2bfloat16_rn(re + im);
    o[1] = __float2bfloat16_rn(re);
    o[2] = __float2bfloat16_rn(im);
  }
  __device__ __forceinline__ static float2 combine(const float (&p)[NQ]) {
    return make_float2(p[0] - p[2], p[0] + p[1]);
  }
};

template <>
struct Form<FOUR4> {
  static constexpr int NQ = 4;
  static constexpr int NB = 2;  // xr, xi
  static constexpr int NS = 2;  // r, i
  __device__ __forceinline__ static int table(int s) { return s; }
  __device__ __forceinline__ static int sidx(int q) { return q & 1; }
  __device__ __forceinline__ static int operand(int q) { return q >> 1; }
  __device__ __forceinline__ static void fill(float re, float im, __nv_bfloat16 (&o)[NB]) {
    o[0] = __float2bfloat16_rn(re);
    o[1] = __float2bfloat16_rn(im);
  }
  __device__ __forceinline__ static float2 combine(const float (&p)[NQ]) {
    return make_float2(p[0] - p[3], p[1] + p[2]);
  }
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d (16 x 8) += A (16 x 16, row) B (16 x 8, col); bf16 in, fp32 out.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Stores the data's bf16 operands for 8 consecutive depths of one column:
// re[j], im[j] are depth d0 + j; operand o goes to bsm + o * bstride +
// col * ld + d0 as one 16-byte word (d0 a multiple of 8, ld * 2 bytes a
// multiple of 16).
template <int F>
__device__ __forceinline__ void store_operands(__nv_bfloat16* bsm, int bstride, int ld, int col, int d0,
                                               const float (&re)[8], const float (&im)[8]) {
  using P = Form<F>;
  uint32_t w[P::NB][4];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    __nv_bfloat16 lo[P::NB], hi[P::NB];
    P::fill(re[j], im[j], lo);
    P::fill(re[j + 1], im[j + 1], hi);
#pragma unroll
    for (int o = 0; o < P::NB; ++o) w[o][j / 2] = pack2(lo[o], hi[o]);
  }
#pragma unroll
  for (int o = 0; o < P::NB; ++o)
    *reinterpret_cast<uint4*>(bsm + o * bstride + col * ld + d0) = make_uint4(w[o][0], w[o][1], w[o][2], w[o][3]);
}

// One warp's tile: acc[q][j] = A_slot(q) (rows 16 mt .. 16 mt + 15) x
// B_operand(q) (columns n0 + 8 j .. + 7), over KTS depth tiles of 16, A
// held in shared memory: the NS slots of the form, each `slot_stride`
// uint4s apart, [mt][kt][lane], so that a fragment is one conflict-free
// 16-byte read a lane; B lies at bsm as [column][depth], `ld` bf16 a
// column, operands `bstride` apart.  Fragment layout (PTX ISA,
// mma.m16n8k16 .bf16): lane = 4 g + t; A registers (g, 2t..), (g + 8,
// 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B registers (depth 2t..,
// column g), (depth 2t + 8.., column g); C values (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
template <int F, int NT, int KTS>
__device__ __forceinline__ void warp_tile_smem(float (&acc)[Form<F>::NQ][NT][4], const uint4* a_sm, int slot_stride,
                                               int mt, const __nv_bfloat16* bsm, int bstride, int ld, int n0,
                                               int lane) {
  using P = Form<F>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < P::NQ; ++q)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KTS; ++kt) {
    uint4 a[P::NS];
#pragma unroll
    for (int s = 0; s < P::NS; ++s) a[s] = a_sm[s * slot_stride + (mt * KTS + kt) * 32 + lane];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* col = bsm + (n0 + 8 * j + g) * ld + 16 * kt + 2 * t;
      uint32_t b[P::NB][2];
#pragma unroll
      for (int o = 0; o < P::NB; ++o) {
        b[o][0] = *reinterpret_cast<const uint32_t*>(col + o * bstride);
        b[o][1] = *reinterpret_cast<const uint32_t*>(col + o * bstride + 8);
      }
#pragma unroll
      for (int q = 0; q < P::NQ; ++q) mma16816(acc[q][j], a[P::sidx(q)], b[P::operand(q)][0], b[P::operand(q)][1]);
    }
  }
}

// The combined (re, im) of accumulator value e of column tile j.
template <int F, int NT>
__device__ __forceinline__ float2 combined(const float (&acc)[Form<F>::NQ][NT][4], int j, int e) {
  float p[Form<F>::NQ];
#pragma unroll
  for (int q = 0; q < Form<F>::NQ; ++q) p[q] = acc[q][j][e];
  return Form<F>::combine(p);
}

// Devices whose launch configuration a kernel records (whole_bf16.cuh).
constexpr int MAX_DEVICES = 64;

}  // namespace bf16mma
}  // namespace gft

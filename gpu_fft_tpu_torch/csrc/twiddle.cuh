// The two twiddle sources of stage A, shared by its kernels:
//   * K3 and K3F (stage_a.cu, stage_a_bf16.cu), the plan's factored twiddle
//     W[k1, c] = two[k1, c / ct] * twi[k1, c % ct] (Factored), and
//   * K3-legacy and K3-legacy-fast (the same files), the materialized
//     (n1, n2) table of the ablation harnesses' plans, W[k1, c] =
//     twr[k1 * n2 + c] + i twi[k1 * n2 + c] (Table).
// A source is read two ways: the radix kernel takes one output's W with
// column(c) and at(k1, column(c)); the bf16 kernel's epilogue
// (dot_bf16.cuh:TwiddleRows) takes the W of columns c .. c + 3, c a
// multiple of 4, with quad(k1, c): 16-byte loads a plane where the four
// lie in one aligned run (Factored: ct a multiple of 4; Table: n2), else
// two column pairs (ct, n2 even).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gft {

// K3's twiddle: two[k1, c / ct] * twi[k1, c % ct], rebuilt per output.  A
// column's (c / ct, c % ct) is taken once for all the rows a thread loads
// (per output, the division cost K3 3-8%).
struct Factored {
  const float *two_r, *two_i, *twi_r, *twi_i;
  int n_outer, ct;
  struct Col {
    int co, ci;
  };
  __device__ __forceinline__ Col column(int c) const {
    const int co = c / ct;
    return {co, c - co * ct};
  }
  __device__ __forceinline__ float2 at(int k1, Col c) const {
    const size_t o = (size_t)k1 * n_outer + c.co, i = (size_t)k1 * ct + c.ci;
    const float o_r = __ldg(two_r + o), o_i = __ldg(two_i + o);
    const float i_r = __ldg(twi_r + i), i_i = __ldg(twi_i + i);
    return make_float2(o_r * i_r - o_i * i_i, o_r * i_i + o_i * i_r);
  }
  // W of the even column c and of c + 1: both share c / ct (ct even).
  __device__ __forceinline__ void pair(int k1, int c, float2 (&w)[2]) const {
    const float o_r = two_r[k1 * n_outer + c / ct], o_i = two_i[k1 * n_outer + c / ct];
    const float2 i_r = *reinterpret_cast<const float2*>(twi_r + k1 * ct + c % ct);
    const float2 i_i = *reinterpret_cast<const float2*>(twi_i + k1 * ct + c % ct);
    w[0] = make_float2(o_r * i_r.x - o_i * i_i.x, o_r * i_i.x + o_i * i_r.x);
    w[1] = make_float2(o_r * i_r.y - o_i * i_i.y, o_r * i_i.y + o_i * i_r.y);
  }
  __device__ __forceinline__ void quad(int k1, int c, float4& wr, float4& wi) const {
    if (ct % 4 == 0) {  // the four share c / ct: one outer factor, a 16-byte inner read
      const int co = c / ct;
      const float o_r = __ldg(two_r + k1 * n_outer + co), o_i = __ldg(two_i + k1 * n_outer + co);
      const float4 i_r = __ldg(reinterpret_cast<const float4*>(twi_r + k1 * ct + c - co * ct));
      const float4 i_i = __ldg(reinterpret_cast<const float4*>(twi_i + k1 * ct + c - co * ct));
      wr = make_float4(o_r * i_r.x - o_i * i_i.x, o_r * i_r.y - o_i * i_i.y, o_r * i_r.z - o_i * i_i.z,
                       o_r * i_r.w - o_i * i_i.w);
      wi = make_float4(o_r * i_i.x + o_i * i_r.x, o_r * i_i.y + o_i * i_r.y, o_r * i_i.z + o_i * i_r.z,
                       o_r * i_i.w + o_i * i_r.w);
      return;
    }
    float2 lo[2], hi[2];
    pair(k1, c, lo);
    pair(k1, c + 2, hi);
    wr = make_float4(lo[0].x, lo[1].x, hi[0].x, hi[1].x);
    wi = make_float4(lo[0].y, lo[1].y, hi[0].y, hi[1].y);
  }
};

// K3-legacy's twiddle: the materialized (n1, n2) table.
struct Table {
  const float *twr, *twi;
  int n2;
  __device__ __forceinline__ int column(int c) const { return c; }
  __device__ __forceinline__ float2 at(int k1, int c) const {
    const size_t o = (size_t)k1 * n2 + c;
    return make_float2(__ldg(twr + o), __ldg(twi + o));
  }
  __device__ __forceinline__ void quad(int k1, int c, float4& wr, float4& wi) const {
    const size_t o = (size_t)k1 * n2 + c;
    if (n2 % 4 == 0) {
      wr = __ldg(reinterpret_cast<const float4*>(twr + o));
      wi = __ldg(reinterpret_cast<const float4*>(twi + o));
      return;
    }
    const float2* r = reinterpret_cast<const float2*>(twr + o);
    const float2* i = reinterpret_cast<const float2*>(twi + o);
    const float2 r0 = __ldg(r), r1 = __ldg(r + 1), i0 = __ldg(i), i1 = __ldg(i + 1);
    wr = make_float4(r0.x, r0.y, r1.x, r1.y);
    wi = make_float4(i0.x, i0.y, i1.x, i1.y);
  }
};

}  // namespace gft

// Launch-floor probes: S5, the minimal copy, and S4, the operand-count probe.
//
// Replace two Pallas kernels of the JAX package's calibration scripts:
//   S5 scripts/calibrate_latency.py:pallas_min (body `_copy_kernel`)
//        o = x * (1 + 2^-20) on one (8, 128) f32 tile;
//   S4 scripts/ablate_whole_packed.py:probe(k)
//        o = x * (1 + 2^-20) + sum_{i<k} t_i[0:8, :] * 2^-24, summed in that
//        order, over k (128, 128) f32 table operands.
//
// What bounds them on an H100: nothing of their own.  The tile is 4 KB in
// and 4 KB out (nanoseconds at 3.35 TB/s) and 1,024 multiplies per operand;
// their time is the launch.  That is what they measure: S5 the card's floor
// for one kernel, S4 how that floor grows with the count of pointer
// operands.  Neither is a redesign target: they are the floor.
//
// Design: one block of 256 threads, one float4 per thread.  S4 is one
// instantiation per k in {0, 1, 2, 4, 8}, each taking exactly k table
// pointers by value, so its parameter block grows with k as the TPU
// kernel's operand list did.  Products and sums are rounded one at a time
// (__fmul_rn / __fadd_rn: no FMA contraction) in the script's order, so each
// kernel agrees with its plain torch version bit for bit.
#include "common.cuh"

namespace {

constexpr int TILE = 8 * 128;         // floats in the (8, 128) tile
constexpr int THREADS = TILE / 4;     // one float4 each
constexpr float SCALE = 1.0f + 0x1p-20f;
constexpr float TABLE_SCALE = 0x1p-24f;

__device__ __forceinline__ float4 scale4(const float4 v) {
  return make_float4(__fmul_rn(v.x, SCALE), __fmul_rn(v.y, SCALE), __fmul_rn(v.z, SCALE),
                     __fmul_rn(v.w, SCALE));
}

__global__ void __launch_bounds__(THREADS)
copy_min_kernel(const float4* __restrict__ x, float4* __restrict__ o) {
  o[threadIdx.x] = scale4(x[threadIdx.x]);
}

template <int K>
struct Operands {
  const float4* t[K];
};
template <>
struct Operands<0> {};

// Rows [0, 8) of a (128, 128) table are its first 1,024 floats.
template <int K>
__global__ void __launch_bounds__(THREADS)
operand_probe_kernel(const float4* __restrict__ x, Operands<K> ops, float4* __restrict__ o) {
  const int i = threadIdx.x;
  float4 acc = scale4(x[i]);
  if constexpr (K > 0) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const float4 w = __ldg(ops.t[r] + i);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w.x, TABLE_SCALE));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w.y, TABLE_SCALE));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w.z, TABLE_SCALE));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w.w, TABLE_SCALE));
    }
  }
  o[i] = acc;
}

template <int K>
int launch_probe(const float* x, const float* const* tables, float* o, cudaStream_t s) {
  Operands<K> ops;
  if constexpr (K > 0) {
    for (int r = 0; r < K; ++r) ops.t[r] = reinterpret_cast<const float4*>(tables[r]);
  }
  operand_probe_kernel<K><<<1, THREADS, 0, s>>>(reinterpret_cast<const float4*>(x), ops,
                                                reinterpret_cast<float4*>(o));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gft_copy_min(const float* x, float* o, void* stream) {
  copy_min_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o));
  return (int)cudaGetLastError();
}

// t0..t7: the first k table pointers are read, the rest ignored.
extern "C" int gft_operand_probe(const float* x, const float* t0, const float* t1, const float* t2,
                                 const float* t3, const float* t4, const float* t5,
                                 const float* t6, const float* t7, float* o, int k,
                                 void* stream) {
  const float* tables[8] = {t0, t1, t2, t3, t4, t5, t6, t7};
  for (int r = 0; r < k && r < 8; ++r)
    if (!tables[r]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 0: return launch_probe<0>(x, tables, o, s);
    case 1: return launch_probe<1>(x, tables, o, s);
    case 2: return launch_probe<2>(x, tables, o, s);
    case 4: return launch_probe<4>(x, tables, o, s);
    case 8: return launch_probe<8>(x, tables, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

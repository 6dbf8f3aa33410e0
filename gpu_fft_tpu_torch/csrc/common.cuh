// Shared helpers for the Hopper kernels of gpu_fft_tpu_torch.
//
// Every C entry point takes raw device pointers and a cudaStream_t passed as
// void*, launches on that stream without synchronising, and returns
// cudaGetLastError() as an int so the ctypes wrapper can raise on failure.
#pragma once

#include <cuda_runtime.h>

namespace gft {

// 16-byte read through the read-only (non-coherent) cache path.
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float f4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

}  // namespace gft

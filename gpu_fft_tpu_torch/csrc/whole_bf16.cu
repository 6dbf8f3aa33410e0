// K1F and K2F (the "fast" whole transform): the C entry and K1F's product
// forms.  The kernel, its design and what bounds it: whole_bf16.cuh.
#include "whole_bf16.cuh"

// img1: F1's fragment image (slots r, i, s, d for K1; r, i for K2), n1
// padded to 16; img2: F2's (128 x 128); twr, twi: the (n1, 128) twiddle;
// xi null for real input; packed selects K2's product forms.  n1 a power
// of two in [8, 128], batch <= 65,535 rows; cluster (C, the blocks a row:
// a power of two <= 8), threads (<= 512) and smem as kernels/fused.py:
// whole_bf16_geometry gives them; anything else is cudaErrorInvalidValue.
extern "C" int gft_whole_bf16(const float* xr, const float* xi, const void* img1, const void* img2,
                              const float* twr, const float* twi, float* yr, float* yi, int batch, int n1,
                              int packed, int cluster, int threads, int smem, void* stream) {
  if (batch < 1 || batch > 65535 || cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool real = xi == nullptr;
  if (packed) return gft::whole_bf16_packed(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, cluster, threads, smem, s);
  if (real) return by_n1<REAL2, KARA3>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, cluster, threads, smem, s);
  return by_n1<KARA3, KARA3>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, cluster, threads, smem, s);
}

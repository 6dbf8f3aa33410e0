// K2F's product forms of the "fast" whole transform (whole_bf16.cuh), in a
// file of their own so that they compile beside K1F's.
#include "whole_bf16.cuh"

namespace gft {

int whole_bf16_packed(const float* xr, const float* xi, const void* img1, const void* img2, const float* twr,
                      const float* twi, float* yr, float* yi, int batch, int n1, int cluster, int threads,
                      int smem, cudaStream_t s) {
  using bf16mma::FOUR4;
  using bf16mma::REAL2;
  if (xi == nullptr) return by_n1<REAL2, FOUR4>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, cluster, threads, smem, s);
  return by_n1<FOUR4, FOUR4>(xr, xi, img1, img2, twr, twi, yr, yi, batch, n1, cluster, threads, smem, s);
}

}  // namespace gft

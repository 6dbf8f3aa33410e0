// Left-matmul fused four-step for real input (S1), one launch per batch.
//
// Replaces the Pallas kernel scripts/ablate_engines.py:111
// fused_fft_pallas_lm (body `_lm_real_kernel`, tables `lm_tables`).  x (B, n)
// real with n = n1 * n2 from balanced_split (n1 <= n2, n2 in {64, 128, 256}),
// each row viewed (n1, n2) = [a, c]:
//   P[k1, c] = sum_a F1[k1, a] x[a, c]         stage 1, the left matmul
//   Z[k1, c] = P[k1, c] * TW[k1, c]            twiddle, (n1, n2) = [k1, c]
//   Y[j, k1] = sum_c F2[c, j] Z[k1, c]         stage 2
// and Y flattened as j * n1 + k1 is the spectrum in natural order.  That is
// the whole transform of K1 (whole_transform.cu) with n2 in place of 128.
//
// What bounds it on an H100: at B = 1 neither bytes nor FLOP, but the
// latency of the dependent steps of one transform, spread over as many SMs
// as it can use (65,536 points: 0.26 MB in, 0.52 MB out, 5.6 MFLOP as a
// radix FFT); at B = 16 the bytes (x, TW and Y: 13 MB, 3.9 us).  The TPU
// kernel computes both factor DFTs as dense products (n1 + n2 MACs a point,
// Karatsuba in stage 2), which the MXU makes nearly free; on CUDA cores that
// is 168 MFLOP at (1, 65,536), and a block that owns a set of rows k1 either
// recomputes stage 1 or leaves most SMs idle.
//
// Design: K1's kernel, whole_kernel<n2, false> of radix.cuh: each factor DFT
// a radix-8 Stockham FFT, one cluster of C blocks per transform (C from the
// wrapper, kernels/fused.py:lm_geometry), block r running stage 1 on columns
// [r n2/C, (r+1) n2/C), multiplying by TW in its last pass, then stage 2 on
// rows [r n1/C, (r+1) n1/C) read from its cluster's shared memory.  Nothing
// is read twice or recomputed.  It reads row 1 of F1 and of F2 (the root
// tables) and TW; F2 holds no imaginary table, so Im w_n2^c is taken from
// sinpif, and the Karatsuba tables f2s, f2d of the TPU kernel's interface
// are not read.  fp32 CUDA cores.  A refused launch is returned as an
// error; nothing falls back.
#include "radix.cuh"

extern "C" int gft_fused_lm(const float* x, const float* f1r, const float* f1i, const float* twr,
                            const float* twi, const float* f2r, const float* f2s,
                            const float* f2d, float* yr, float* yi, int batch, int n1, int n2,
                            int cluster, int threads, int smem, void* stream) {
  (void)f2s;
  (void)f2d;
  if (n1 > n2 || (n2 != 64 && n2 != 128 && n2 != 256)) return (int)cudaErrorInvalidValue;
  // F1 is (n1, n1), F2 (n2, n2): row 1 starts at n1 and n2; F2[0, 0] = 1.
  const gft::Tables tab{f1r + n1, f1i + n1, twr, twi, f2r + n2, nullptr, f2r};
  const auto launch = n2 == 64    ? gft::launch_whole<64, true>
                      : n2 == 128 ? gft::launch_whole<128, true>
                                  : gft::launch_whole<256, true>;
  return launch(x, nullptr, tab, yr, yi, batch, n1, cluster, threads, smem, stream);
}

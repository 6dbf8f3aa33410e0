// Whole-transform kernel: one length-n FFT per row in ONE launch, as a radix
// FFT that keeps the row on chip, one thread-block cluster per transform.
//
// Replaces the Pallas kernels gpu_fft_tpu/kernels/fused.py:424
// whole_transform (K1: separate tables) and :383 whole_transform_packed (K2:
// every table in one (4*n1 + 256, 128) buffer).  One kernel serves both: the
// C entry points only point it at the table rows it reads.
//
// Math (n = n1 * 128, x viewed as (n1, 128) = [a, c], w_L = exp(sign 2 pi i / L)):
//   P[k1, c] = sum_a w_n1^(a k1) x[a, c]           stage 1, column DFTs
//   Z[k1, c] = P[k1, c] * TW[k1, c]                the plan's twiddle
//   Y[j, k1] = scale * sum_c w_128^(c j) Z[k1, c]  stage 2, row DFTs
// and Y flattened as j * n1 + k1 is the spectrum in natural order.  The plan
// holds F1 = [w_n1^(a k)], TW and F2 = scale * [w_128^(c j)]; the kernel reads
// TW, the root tables w_n1^a and w_128^c (row 1 of F1 and of F2 / F2[0, 0]),
// the sign (the imaginary part of w_n1^(n1/4)) and the scale (F2[0, 0]).
//
// What bounds it on an H100: at B = 1 and n <= 65,536 the transform is a few
// hundred KB and 5 n log2 n = 1.2 MFLOP at n = 16,384, so neither bytes nor
// FLOP bound it but the latency of its dependent steps, spread over as many
// SMs as the row can use.  The TPU kernel writes both factor DFTs as dense
// products (n1 + 128 MACs per point), which the MXU makes nearly free; on
// fp32 CUDA cores that is 50 MFLOP at 16,384, and the dense 128 x 128 F2
// alone (128 KB) does not fit shared memory beside the data.  So here each
// factor DFT is a radix-8 (then 4 or 2) Stockham FFT: every thread holds 8
// complex values per pass in registers, and a pass reads them, twiddles, runs
// the butterfly and writes them back to shared memory in autosorted order.
// A cluster of C blocks shares the row, so that a block holds 1,024-4,096
// values (the time of a block grows with its share, measured): block r reads
// columns [r*128/C, (r+1)*128/C) of x straight from global memory in its
// first stage-1 pass, and its last stage-1 pass multiplies by TW (loaded at
// the block's start, coalesced along the columns, so that it arrives under
// the passes before) and stores Z by columns.  After one cluster barrier the
// block's first stage-2 pass reads rows [r*n1/C, (r+1)*n1/C) of Z from the
// blocks that own their columns (distributed shared memory, contiguous along
// the rows); a second barrier lets each block overwrite its own tile, and the
// last pass writes Y to global memory.  Nothing is read twice or recomputed.
// fp32 CUDA cores, no tensor cores, no TF32.
//
// The kernel, whole_kernel<128, COMPLEX>, and its Stockham passes are in
// radix.cuh, shared with S1 (fused_lm.cu, the same kernel at another N2) and
// K3 (stage_a.cu, stage 1 alone).  The wrapper (kernels/fused.py:
// whole_geometry) picks C, the block size (n / (8 C) threads) and the dynamic
// shared memory; the entry points check them and launch with
// cudaLaunchKernelEx.  A refused launch is returned as an error; nothing
// falls back.
#include "radix.cuh"

namespace {
constexpr int N2 = 128;  // row length of the (n1, 128) view
}  // namespace

extern "C" int gft_whole_split(const float* xr, const float* xi, const float* f1r, const float* f1i,
                               const float* twr, const float* twi, const float* f2r,
                               const float* f2i, float* yr, float* yi, int batch, int n1,
                               int cluster, int threads, int smem, void* stream) {
  // F1 is (n1, n1), F2 (128, 128): row 1 starts at n1 and 128.
  const gft::Tables tab{f1r + n1, f1i + n1, twr, twi, f2r + N2, f2i + N2, f2r};
  return gft::launch_whole<N2>(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem, stream);
}

// packed: (4 n1 + 256, 128) rows [F1r; F1i; TWr; TWi; F2r; F2i]
// (gpu_fft_tpu/plan.py:get_whole_packed_plan), F1 in columns [0, n1).
extern "C" int gft_whole_packed(const float* xr, const float* xi, const float* packed, float* yr,
                                float* yi, int batch, int n1, int cluster, int threads, int smem,
                                void* stream) {
  const float* f2r = packed + (size_t)4 * n1 * N2;
  const float* f2i = f2r + N2 * N2;
  const gft::Tables tab{packed + N2, packed + (size_t)(n1 + 1) * N2, packed + (size_t)2 * n1 * N2,
                        packed + (size_t)3 * n1 * N2, f2r + N2, f2i + N2, f2r};
  return gft::launch_whole<N2>(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem, stream);
}

extern "C" const char* gft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

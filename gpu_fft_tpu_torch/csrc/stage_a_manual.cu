// Stage A with F1 resident and the column tiles pipelined by hand (S2).
//
// Replaces the Pallas kernel scripts/ablate_2e20_levers.py:stage_a_manual
// (bodies `outer`, which drives pltpu.emit_pipeline over the column tiles
// from inside ONE kernel instance, and `inner`): real x (n1, n2), the
// (n1, n1) column DFT F1 and a materialized (n1, n2) twiddle,
//   yr + i yi = (F1 x) * (twr + i twi).
// It is K3-legacy at B = 1 with real input; only the schedule differs.
//
// What bounds it on an H100: the same work as K3-legacy.  At n = 2^20,
// n1 = 128: 543 MFLOP -> 8.1 us at 67 TFLOP/s fp32 (the wall), against
// 21 MB (x 4.2, twiddle 8.4, output 8.4) -> 6.3 us at 3.35 TB/s.
//
// Design: the Hopper counterpart of "F1 resident, column tiles pipelined by
// hand" is a persistent kernel.  The grid is at most one block per SM; a
// block owns TM = 32 rows k1 of the output, keeps those F1 rows in shared
// memory (transposed, 32 KB at n1 = 128) for its whole run, and walks its
// share of the TN = 64-wide column tiles.  The x tile (n1 x TN) and the two
// twiddle tiles (TM x TN) of tile j+1 are copied into the other slot of a
// two-stage shared-memory ring with cp.async (16 bytes a thread,
// commit_group / wait_group 1) while tile j computes, so the copy engine and
// the FMA pipes overlap as emit_pipeline's double-buffered DMA does on the
// TPU.  2 x 4 outputs per thread, fp32 FMA on CUDA cores, schoolbook complex
// product in the epilogue.  128 KB of dynamic shared memory at n1 = 128
// (cudaFuncAttributeMaxDynamicSharedMemorySize), 224 KB at n1 = 256.
#include "common.cuh"

namespace {

constexpr int TM = 32;   // output rows k1 per block (F1 rows resident)
constexpr int TN = 64;   // columns per pipelined tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory (floats): sfr[n1][TM], sfi[n1][TM], then STAGES slots of
// { x[n1][TN], twr[TM][TN], twi[TM][TN] }.
__global__ void __launch_bounds__(THREADS, 1)
stage_a_manual_kernel(const float* __restrict__ x, const float* __restrict__ f1r,
                      const float* __restrict__ f1i, const float* __restrict__ twr,
                      const float* __restrict__ twi, float* __restrict__ yr,
                      float* __restrict__ yi, int n1, int n2, int row_blocks, int per_row) {
  extern __shared__ __align__(16) float smem[];
  float* sfr = smem;
  float* sfi = sfr + n1 * TM;
  float* ring = sfi + n1 * TM;
  const int slot = n1 * TN + 2 * TM * TN;

  const int t = threadIdx.x;
  const int row0 = (blockIdx.x % row_blocks) * TM;
  const int n_tiles = n2 / TN;

  // F1 rows row0.., resident for the block's whole run, stored [a][row].
  for (int q = t; q < TM * n1; q += THREADS) {
    const int r = q / n1, a = q % n1;
    sfr[a * TM + r] = __ldg(f1r + (size_t)(row0 + r) * n1 + a);
    sfi[a * TM + r] = __ldg(f1i + (size_t)(row0 + r) * n1 + a);
  }

  auto issue = [&](int tile, int stage) {
    float* sx = ring + stage * slot;
    float* swr = sx + n1 * TN;
    float* swi = swr + TM * TN;
    const int c0 = tile * TN;
    for (int q = t; q < n1 * (TN / 4); q += THREADS) {
      const int k = q / (TN / 4), c4 = (q % (TN / 4)) * 4;
      cp_async16(sx + k * TN + c4, x + (size_t)k * n2 + c0 + c4);
    }
    for (int q = t; q < TM * (TN / 4); q += THREADS) {
      const int r = q / (TN / 4), c4 = (q % (TN / 4)) * 4;
      const size_t g = (size_t)(row0 + r) * n2 + c0 + c4;
      cp_async16(swr + r * TN + c4, twr + g);
      cp_async16(swi + r * TN + c4, twi + g);
    }
  };

  int tile = blockIdx.x / row_blocks;
  int stage = 0;
  if (tile < n_tiles) issue(tile, 0);
  cp_async_commit();

  const int tx = t % 16;  // columns tx*4 + {0..3}
  const int ty = t / 16;  // rows ty*2 + {0, 1}
  for (; tile < n_tiles; tile += per_row) {
    const int next = tile + per_row;
    if (next < n_tiles) issue(next, stage ^ 1);
    cp_async_commit();    // (possibly empty) group of tile j+1
    cp_async_wait<1>();   // this thread's copies of tile j have landed
    __syncthreads();      // ... and every other thread's (and F1, first time)

    const float* sx = ring + stage * slot;
    const float* swr = sx + n1 * TN;
    const float* swi = swr + TM * TN;
    float ar[2][4], ai[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ar[i][j] = ai[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < n1; ++k) {
      const float2 fr = *reinterpret_cast<const float2*>(sfr + k * TM + ty * 2);
      const float2 fi = *reinterpret_cast<const float2*>(sfi + k * TM + ty * 2);
      const float4 v = gft::lds4(sx + k * TN + tx * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = gft::f4(v, j);
        ar[0][j] = fmaf(fr.x, xv, ar[0][j]);
        ar[1][j] = fmaf(fr.y, xv, ar[1][j]);
        ai[0][j] = fmaf(fi.x, xv, ai[0][j]);
        ai[1][j] = fmaf(fi.y, xv, ai[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const float4 wr = gft::lds4(swr + r * TN + tx * 4);
      const float4 wi = gft::lds4(swi + r * TN + tx * 4);
      float outr[4], outi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = gft::f4(wr, j), b = gft::f4(wi, j);
        outr[j] = ar[i][j] * a - ai[i][j] * b;
        outi[j] = ar[i][j] * b + ai[i][j] * a;
      }
      const size_t o = (size_t)(row0 + r) * n2 + tile * TN + tx * 4;
      *reinterpret_cast<float4*>(yr + o) = make_float4(outr[0], outr[1], outr[2], outr[3]);
      *reinterpret_cast<float4*>(yi + o) = make_float4(outi[0], outi[1], outi[2], outi[3]);
    }
    __syncthreads();  // every thread is done with this slot before it is refilled
    stage ^= 1;
  }
  cp_async_wait<0>();
}

}  // namespace

// Device queries and the shared-memory attribute are set once per device
// and size, so a launch captured into a CUDA graph makes no such call.
constexpr int MAX_DEVICES = 64;
static int g_sms[MAX_DEVICES];
static size_t g_smem_set[MAX_DEVICES];

extern "C" int gft_stage_a_manual(const float* x, const float* f1r, const float* f1i,
                                  const float* twr, const float* twi, float* yr, float* yi,
                                  int n1, int n2, void* stream) {
  if (n1 < TM || n1 % TM || n1 > 256 || n2 < TN || n2 % TN) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int row_blocks = n1 / TM;
  const int n_tiles = n2 / TN;
  int per_row = g_sms[dev] / row_blocks;
  if (per_row < 1) per_row = 1;
  if (per_row > n_tiles) per_row = n_tiles;
  const size_t smem = (size_t)(2 * n1 * TM + STAGES * (n1 * TN + 2 * TM * TN)) * sizeof(float);
  if (smem > g_smem_set[dev]) {
    e = cudaFuncSetAttribute(stage_a_manual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[dev] = smem;
  }
  stage_a_manual_kernel<<<row_blocks * per_row, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, f1r, f1i, twr, twi, yr, yi, n1, n2, row_blocks, per_row);
  return (int)cudaGetLastError();
}

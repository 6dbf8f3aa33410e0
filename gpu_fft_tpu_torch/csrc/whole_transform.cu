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
// The wrapper (kernels/fused.py:whole_geometry) picks C, the block size
// (n / (8 C) threads) and the dynamic shared memory; the entry points check
// them and launch with cudaLaunchKernelEx.  A refused launch is returned as
// an error; nothing falls back.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int N2 = 128;     // row length of the (n1, 128) view
constexpr int LOG_N2 = 7;
constexpr int E = 8;        // complex values a thread holds in a pass
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 64;
constexpr float SQRT_HALF = 0.70710678118654752f;

// Where the kernel reads the plan: root tables (row 1 of F1 and F2), TW, F2[0, 0].
struct Tables {
  const float *w1r, *w1i, *twr, *twi, *w2r, *w2i, *scale;
};

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// Row stride (float2) of the stage-2 tile: rows x 128 values, padded so that
// the 16 lanes of a half-warp (row fastest, then column) hit distinct banks.
__host__ __device__ constexpr int stage2_ld(int rows) { return N2 + (rows < 16 ? 16 / rows : 1); }

// Dynamic shared memory (float2): the block's tile (stage 1: n1 x 128/C,
// its result Z as 128/C columns of n1 + 1, stage 2: n1/C rows of stage2_ld),
// then the two root tables.
__host__ __device__ inline int smem_values(int n1, int cluster) {
  const int rows = n1 / cluster;
  const int tile1 = N2 / cluster * (n1 + 1), tile2 = rows * stage2_ld(rows);
  return (tile1 > tile2 ? tile1 : tile2) + n1 + N2;
}

__device__ __forceinline__ float2 operator+(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 operator-(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (s i): a quarter turn in the transform's direction.
__device__ __forceinline__ float2 rot(float2 a, float s) { return make_float2(-s * a.y, s * a.x); }

// In-place DFT of R values in natural order, w_R = exp(s 2 pi i / R).
template <int R>
__device__ __forceinline__ void dft(float2* v, float s);

template <>
__device__ __forceinline__ void dft<2>(float2* v, float) {
  const float2 a = v[0], b = v[1];
  v[0] = a + b;
  v[1] = a - b;
}

template <>
__device__ __forceinline__ void dft<4>(float2* v, float s) {
  const float2 t0 = v[0] + v[2], t1 = v[0] - v[2];
  const float2 t2 = v[1] + v[3], t3 = rot(v[1] - v[3], s);
  v[0] = t0 + t2;
  v[2] = t0 - t2;
  v[1] = t1 + t3;
  v[3] = t1 - t3;
}

template <>
__device__ __forceinline__ void dft<8>(float2* v, float s) {
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e, s);
  dft<4>(o, s);
  const float2 r1 = rot(o[1], s), r3 = rot(o[3], s);
  o[1] = make_float2(SQRT_HALF * (o[1].x + r1.x), SQRT_HALF * (o[1].y + r1.y));  // w_8
  o[2] = rot(o[2], s);                                                            // w_8^2
  o[3] = make_float2(SQRT_HALF * (r3.x - o[3].x), SQRT_HALF * (r3.y - o[3].y));  // w_8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = e[k] + o[k];
    v[k + 4] = e[k] - o[k];
  }
}

// One radix-R Stockham pass over M transforms of length L = 2^lL, from Ns =
// 2^lNs (the length already combined) to Ns * R.  Thread t takes the
// butterflies q = t + u * T (u < E / R): transform m = q % M, butterfly
// j = q / M, whose inputs are elements j + r L / R and whose outputs are
// elements d + r Ns, d = (j / Ns) Ns R + j % Ns.  src(e, m, l) reads element
// l of transform m into the thread's slot e = u R + r, dst(e, m, l, v)
// writes it; sync() runs between the reads and the writes (the pass is in
// place).
template <int R, class Src, class Sync, class Dst>
__device__ __forceinline__ void stockham_pass(int T, int lL, int lNs, int lM, const float2* w, float s,
                                              Src src, Sync sync, Dst dst) {
  constexpr int U = E / R;
  constexpr int LR = ilog2(R);
  const int ns = 1 << lNs;
  const int step = 1 << (lL - LR);
  const int tw_shift = lL - lNs - LR;  // twiddle of input r: w_L^(k r L / (Ns R))
  float2 v[U][R];
  int m[U], j[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = threadIdx.x + u * T;
    m[u] = q & ((1 << lM) - 1);
    j[u] = q >> lM;
#pragma unroll
    for (int r = 0; r < R; ++r) v[u][r] = src(u * R + r, m[u], j[u] + r * step);
  }
  sync();
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = j[u] & (ns - 1);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[u][r] = cmul(v[u][r], w[(k * r) << tw_shift]);
    }
    dft<R>(v[u], s);
    const int d = ((j[u] - k) << LR) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst(u * R + r, m[u], d + r * ns, v[u][r]);
  }
}

// TW[l, c] of the outputs of a radix-R pass from 2^lNs over 2^lW columns
// (stockham_pass's mapping; slot e = u R + r), from the (n1, 128) tables
// twr / twi offset to the block's first column.
template <int R>
__device__ __forceinline__ void load_tw(float2* tw, int T, int lNs, int lW, const float* twr,
                                        const float* twi) {
  constexpr int LR = ilog2(R);
  const int ns = 1 << lNs;
#pragma unroll
  for (int u = 0; u < E / R; ++u) {
    const int q = threadIdx.x + u * T;
    const int m = q & ((1 << lW) - 1), j = q >> lW, k = j & (ns - 1);
    const int d = ((j - k) << LR) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t o = ((size_t)(d + r * ns) << LOG_N2) + m;
      tw[u * R + r] = make_float2(__ldg(twr + o), __ldg(twi + o));
    }
  }
}

// Block (rank r of cluster b): stage 1 on columns [r W, (r+1) W) of row b,
// stage 2 on its rows [r M2, (r+1) M2), W = 128 / C, M2 = n1 / C.
template <bool COMPLEX>
__global__ void __launch_bounds__(1024) whole_kernel(const float* __restrict__ xr,
                                                     const float* __restrict__ xi, Tables tab,
                                                     float* __restrict__ yr, float* __restrict__ yi,
                                                     int n1) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int ln1 = ilog2(n1), lC = ilog2(C);
  const int lW = LOG_N2 - lC, lM2 = ln1 - lC;
  const int W = 1 << lW, M2 = 1 << lM2;
  const int ld2 = stage2_ld(M2);
  const int ldz = n1 + 1;  // column stride of Z (stage 1's result)
  const size_t base = (size_t)(blockIdx.x / C) * n1 * N2;

  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* w1 = smem + (smem_values(n1, C) - n1 - N2);
  float2* w2 = w1 + n1;

  // Stage 1 runs radix-8 passes, the last of radix 8, 2 or 4 (2^lRl) from
  // 2^lNsl.  Its outputs' TW values are loaded now, coalesced along the
  // block's columns, so that they arrive under the passes before it.
  const int lRl = ln1 % 3 == 0 ? 3 : ln1 % 3, lNsl = ln1 - lRl;
  float2 tw[E];
  {
    const float* twr = tab.twr + rank * W;
    const float* twi = tab.twi + rank * W;
    if (lRl == 3) load_tw<8>(tw, T, lNsl, lW, twr, twi);
    else if (lRl == 2) load_tw<4>(tw, T, lNsl, lW, twr, twi);
    else load_tw<2>(tw, T, lNsl, lW, twr, twi);
  }
  const float s = __ldg(tab.w1i + n1 / 4) > 0.f ? 1.f : -1.f;  // Im w_n1^(n1/4) = sign
  const float scale = __ldg(tab.scale);
  for (int i = t; i < n1; i += T) w1[i] = make_float2(__ldg(tab.w1r + i), __ldg(tab.w1i + i));
  for (int i = t; i < N2; i += T) w2[i] = make_float2(__ldg(tab.w2r + i) / scale, __ldg(tab.w2i + i) / scale);

  auto block_sync = [] { __syncthreads(); };
  auto no_sync = [] {};
  auto cluster_sync = [&] {
    if (C > 1) cluster.sync();
    else __syncthreads();
  };

  // ── Stage 1: column DFTs of length n1 on the (n1, W) tile [a][c] ────────
  // The first pass reads x, the last writes Z = P * TW as columns [c][k1].
  const float* xrb = xr + base + rank * W;
  const float* xib = COMPLEX ? xi + base + rank * W : nullptr;
  auto from_x = [&](int, int m, int l) {
    return make_float2(__ldg(xrb + ((size_t)l << LOG_N2) + m),
                       COMPLEX ? __ldg(xib + ((size_t)l << LOG_N2) + m) : 0.f);
  };
  auto tile1 = [&](int, int m, int l) { return tile[(l << lW) + m]; };
  auto to_tile1 = [&](int, int m, int l, float2 v) { tile[(l << lW) + m] = v; };
  auto to_z = [&](int e, int m, int l, float2 v) { tile[m * ldz + l] = cmul(v, tw[e]); };
  if (lNsl == 0) {  // n1 = 8: one pass
    stockham_pass<8>(T, ln1, 0, lW, w1, s, from_x, no_sync, to_z);
  } else {
    stockham_pass<8>(T, ln1, 0, lW, w1, s, from_x, no_sync, to_tile1);
    for (int lNs = 3; lNs < lNsl; lNs += 3) {
      __syncthreads();
      stockham_pass<8>(T, ln1, lNs, lW, w1, s, tile1, block_sync, to_tile1);
    }
    __syncthreads();
    if (lRl == 3) stockham_pass<8>(T, ln1, lNsl, lW, w1, s, tile1, block_sync, to_z);
    else if (lRl == 2) stockham_pass<4>(T, ln1, lNsl, lW, w1, s, tile1, block_sync, to_z);
    else stockham_pass<2>(T, ln1, lNsl, lW, w1, s, tile1, block_sync, to_z);
  }
  cluster_sync();  // every block's Z is in its shared memory

  // ── Stage 2: row DFTs of length 128 on the (M2, 128) tile [k1][c] ──────
  // Pass 1 (radix 8) reads row k1 of Z from the blocks that own its columns.
  auto from_cluster = [&](int, int m, int l) {
    const float2* owner = C > 1 ? cluster.map_shared_rank(tile, l >> lW) : tile;
    return owner[(l & (W - 1)) * ldz + rank * M2 + m];
  };
  auto tile2 = [&](int, int m, int l) { return tile[m * ld2 + l]; };
  auto to_tile2 = [&](int, int m, int l, float2 v) { tile[m * ld2 + l] = v; };
  // After this barrier no block reads another's tile, so each overwrites its own.
  stockham_pass<8>(T, LOG_N2, 0, lM2, w2, s, from_cluster, cluster_sync, to_tile2);
  __syncthreads();
  stockham_pass<8>(T, LOG_N2, 3, lM2, w2, s, tile2, block_sync, to_tile2);
  __syncthreads();
  float* yrb = yr + base + rank * M2;
  float* yib = yi + base + rank * M2;
  auto to_y = [&](int, int m, int l, float2 v) {
    yrb[(size_t)l * n1 + m] = scale * v.x;
    yib[(size_t)l * n1 + m] = scale * v.y;
  };
  stockham_pass<2>(T, LOG_N2, 6, lM2, w2, s, tile2, no_sync, to_y);
}

// Kernel attributes are set once per device and instantiation, so that a
// launch captured into a CUDA graph makes no such call.
template <bool COMPLEX>
cudaError_t configure() {
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(whole_kernel<COMPLEX>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(whole_kernel<COMPLEX>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

template <bool COMPLEX>
cudaError_t launch_one(const float* xr, const float* xi, const Tables& tab, float* yr, float* yi,
                       int batch, int n1, int cluster, int threads, int smem, cudaStream_t stream) {
  cudaError_t e = configure<COMPLEX>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, whole_kernel<COMPLEX>, xr, xi, tab, yr, yi, n1);
}

// n1: a power of two in [8, 512]; cluster: a power of two <= min(16, n1);
// threads = n1 * 128 / (8 * cluster) <= 1024; smem >= smem_values * 8 bytes.
int launch(const float* xr, const float* xi, const Tables& tab, float* yr, float* yi, int batch,
           int n1, int cluster, int threads, int smem, void* stream) {
  const bool pow2 = n1 > 0 && !(n1 & (n1 - 1)) && cluster > 0 && !(cluster & (cluster - 1));
  if (!pow2 || n1 < 8 || n1 > 512 || cluster > MAX_CLUSTER || cluster > n1 || batch < 1 ||
      (long long)batch * cluster > 0x7fffffffLL || threads > 1024 ||
      (long long)threads * E * cluster != (long long)n1 * N2 ||
      (long long)smem < (long long)smem_values(n1, cluster) * (long long)sizeof(float2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      xi ? launch_one<true>(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem, s)
         : launch_one<false>(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" int gft_whole_split(const float* xr, const float* xi, const float* f1r, const float* f1i,
                               const float* twr, const float* twi, const float* f2r,
                               const float* f2i, float* yr, float* yi, int batch, int n1,
                               int cluster, int threads, int smem, void* stream) {
  // F1 is (n1, n1), F2 (128, 128): row 1 starts at n1 and 128.
  const Tables tab{f1r + n1, f1i + n1, twr, twi, f2r + N2, f2i + N2, f2r};
  return launch(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem, stream);
}

// packed: (4 n1 + 256, 128) rows [F1r; F1i; TWr; TWi; F2r; F2i]
// (gpu_fft_tpu/plan.py:get_whole_packed_plan), F1 in columns [0, n1).
extern "C" int gft_whole_packed(const float* xr, const float* xi, const float* packed, float* yr,
                                float* yi, int batch, int n1, int cluster, int threads, int smem,
                                void* stream) {
  const float* f2r = packed + (size_t)4 * n1 * N2;
  const float* f2i = f2r + N2 * N2;
  const Tables tab{packed + N2, packed + (size_t)(n1 + 1) * N2, packed + (size_t)2 * n1 * N2,
                   packed + (size_t)3 * n1 * N2, f2r + N2, f2i + N2, f2r};
  return launch(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem, stream);
}

extern "C" const char* gft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

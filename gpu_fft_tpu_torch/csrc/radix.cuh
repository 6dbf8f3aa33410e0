// The radix-FFT core of the port's transform kernels: radix-2/4/8 butterflies,
// one Stockham pass, and the whole-transform kernel built from them.
//
//   * whole_kernel<N2, COMPLEX, LM>: one length-n FFT per row, n = n1 * N2,
//     on one thread-block cluster per row (K1 and K2 at N2 = 128,
//     whole_transform.cu; S1 at N2 = 64, 128 or 256, fused_lm.cu);
//   * dft<R> and stockham_pass: the column DFTs of stage A (K3, stage_a.cu).
//
// Everything here has internal linkage, so that each kernel source compiles
// its own instantiations and no two objects of the library share a kernel.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace gft {
namespace {

namespace cg = cooperative_groups;

constexpr int E = 8;  // complex values a thread holds in a pass
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 64;
constexpr float SQRT_HALF = 0.70710678118654752f;

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

__host__ __device__ constexpr bool pow2(int v) { return v > 0 && !(v & (v - 1)); }

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
// elements d + r Ns, d = (j / Ns) Ns R + j % Ns.  src(e, m, l) reads
// element l of transform m into the thread's slot e = u R + r, dst(e, m, l, v)
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

// ── The whole transform: n = n1 * N2 on one cluster per row ────────────────

// Where the kernel reads the plan: root tables (row 1 of F1 and F2), TW,
// F2[0, 0].  w2i is not read by the kernel for S1's tables (LM below).
struct Tables {
  const float *w1r, *w1i, *twr, *twi, *w2r, *w2i, *scale;
};

// Row stride (float2) of the stage-2 tile: rows x N2 values, padded so that
// the 16 lanes of a half-warp (row fastest, then column) hit distinct banks.
template <int N2>
__host__ __device__ constexpr int stage2_ld(int rows) { return N2 + (rows < 16 ? 16 / rows : 1); }

// Dynamic shared memory (float2): the block's tile (stage 1: n1 x N2/C,
// its result Z as N2/C columns of n1 + 1, stage 2: n1/C rows of stage2_ld),
// then the two root tables.
template <int N2>
__host__ __device__ inline int smem_values(int n1, int cluster) {
  const int rows = n1 / cluster;
  const int tile1 = N2 / cluster * (n1 + 1), tile2 = rows * stage2_ld<N2>(rows);
  return (tile1 > tile2 ? tile1 : tile2) + n1 + N2;
}

// TW[l, c] of the outputs of a radix-R pass from 2^lNs over 2^lW columns
// (stockham_pass's mapping; slot e = u R + r), from the (n1, N2) tables
// twr / twi offset to the block's first column.
template <int R, int N2>
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
      const size_t o = ((size_t)(d + r * ns) << ilog2(N2)) + m;
      tw[u * R + r] = make_float2(__ldg(twr + o), __ldg(twi + o));
    }
  }
}

// Block (rank r of cluster b): stage 1 on columns [r W, (r+1) W) of row b,
// stage 2 on its rows [r M2, (r+1) M2), W = N2 / C, M2 = n1 / C.  LM: S1's
// tables, whose F2 has no imaginary part: Im w_N2^c = s sin(2 pi c / N2)
// from sinpif (F2[0, 0] = 1).
template <int N2, bool COMPLEX, bool LM>
__global__ void __launch_bounds__(1024) whole_kernel(const float* __restrict__ xr,
                                                     const float* __restrict__ xi, Tables tab,
                                                     float* __restrict__ yr, float* __restrict__ yi,
                                                     int n1) {
  constexpr int LOG_N2 = ilog2(N2);
  // Stage 2 runs radix-8 passes, the last of radix 8, 2 or 4 from 2^LNS2.
  constexpr int LR2 = LOG_N2 % 3 == 0 ? 3 : LOG_N2 % 3, LNS2 = LOG_N2 - LR2;
  static_assert(N2 >= 64 && N2 <= 256 && pow2(N2), "N2 is 64, 128 or 256");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int ln1 = ilog2(n1), lC = ilog2(C);
  const int lW = LOG_N2 - lC, lM2 = ln1 - lC;
  const int W = 1 << lW, M2 = 1 << lM2;
  const int ld2 = stage2_ld<N2>(M2);
  const int ldz = n1 + 1;  // column stride of Z (stage 1's result)
  const size_t base = (size_t)(blockIdx.x / C) * n1 * N2;

  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* w1 = smem + (smem_values<N2>(n1, C) - n1 - N2);
  float2* w2 = w1 + n1;

  // Stage 1 runs radix-8 passes, the last of radix 8, 2 or 4 (2^lRl) from
  // 2^lNsl.  Its outputs' TW values are loaded now, coalesced along the
  // block's columns, so that they arrive under the passes before it.
  const int lRl = ln1 % 3 == 0 ? 3 : ln1 % 3, lNsl = ln1 - lRl;
  float2 tw[E];
  {
    const float* twr = tab.twr + rank * W;
    const float* twi = tab.twi + rank * W;
    if (lRl == 3) load_tw<8, N2>(tw, T, lNsl, lW, twr, twi);
    else if (lRl == 2) load_tw<4, N2>(tw, T, lNsl, lW, twr, twi);
    else load_tw<2, N2>(tw, T, lNsl, lW, twr, twi);
  }
  const float s = __ldg(tab.w1i + n1 / 4) > 0.f ? 1.f : -1.f;  // Im w_n1^(n1/4) = sign
  const float scale = __ldg(tab.scale);
  for (int i = t; i < n1; i += T) w1[i] = make_float2(__ldg(tab.w1r + i), __ldg(tab.w1i + i));
  for (int i = t; i < N2; i += T) {
    if constexpr (LM) w2[i] = make_float2(__ldg(tab.w2r + i), s * sinpif(2.f * i / N2));
    else w2[i] = make_float2(__ldg(tab.w2r + i) / scale, __ldg(tab.w2i + i) / scale);
  }

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

  // ── Stage 2: row DFTs of length N2 on the (M2, N2) tile [k1][c] ────────
  // Pass 1 (radix 8) reads row k1 of Z from the blocks that own its columns.
  auto from_cluster = [&](int, int m, int l) {
    const float2* owner = C > 1 ? cluster.map_shared_rank(tile, l >> lW) : tile;
    return owner[(l & (W - 1)) * ldz + rank * M2 + m];
  };
  auto tile2 = [&](int, int m, int l) { return tile[m * ld2 + l]; };
  auto to_tile2 = [&](int, int m, int l, float2 v) { tile[m * ld2 + l] = v; };
  // After this barrier no block reads another's tile, so each overwrites its own.
  stockham_pass<8>(T, LOG_N2, 0, lM2, w2, s, from_cluster, cluster_sync, to_tile2);
#pragma unroll
  for (int lNs = 3; lNs < LNS2; lNs += 3) {
    __syncthreads();
    stockham_pass<8>(T, LOG_N2, lNs, lM2, w2, s, tile2, block_sync, to_tile2);
  }
  __syncthreads();
  float* yrb = yr + base + rank * M2;
  float* yib = yi + base + rank * M2;
  auto to_y = [&](int, int m, int l, float2 v) {
    yrb[(size_t)l * n1 + m] = scale * v.x;
    yib[(size_t)l * n1 + m] = scale * v.y;
  };
  stockham_pass<1 << LR2>(T, LOG_N2, LNS2, lM2, w2, s, tile2, no_sync, to_y);
}

// Kernel attributes are set once per device and kernel, so that a launch
// captured into a CUDA graph makes no such call.
template <class Kernel>
cudaError_t configure(Kernel kernel, bool cluster, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

template <int N2, bool COMPLEX, bool LM>
cudaError_t launch_whole_one(const float* xr, const float* xi, const Tables& tab, float* yr,
                             float* yi, int batch, int n1, int cluster, int threads, int smem,
                             cudaStream_t stream) {
  static bool done[MAX_DEVICES];
  cudaError_t e = configure(whole_kernel<N2, COMPLEX, LM>, true, done);
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
  return cudaLaunchKernelEx(&cfg, whole_kernel<N2, COMPLEX, LM>, xr, xi, tab, yr, yi, n1);
}

// n1: a power of two in [8, 512]; cluster: a power of two <= min(16, n1);
// threads = n1 * N2 / (8 * cluster) <= 1024; smem >= smem_values * 8 bytes.
// Returns the launch's error, then cudaGetLastError().  xi null: real input.
// LM: S1's tables, real input only.
template <int N2, bool LM = false>
int launch_whole(const float* xr, const float* xi, const Tables& tab, float* yr, float* yi,
                 int batch, int n1, int cluster, int threads, int smem, void* stream) {
  if (!pow2(n1) || !pow2(cluster) || n1 < 8 || n1 > 512 || cluster > MAX_CLUSTER || cluster > n1 ||
      batch < 1 || (long long)batch * cluster > 0x7fffffffLL || threads > 1024 ||
      (long long)threads * E * cluster != (long long)n1 * N2 ||
      (long long)smem < (long long)smem_values<N2>(n1, cluster) * (long long)sizeof(float2) ||
      (LM && xi))
    return (int)cudaErrorInvalidValue;
  auto launch = launch_whole_one<N2, false, LM>;
  if constexpr (!LM) {
    if (xi) launch = launch_whole_one<N2, true, false>;
  }
  const cudaError_t e = launch(xr, xi, tab, yr, yi, batch, n1, cluster, threads, smem,
                               static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace
}  // namespace gft

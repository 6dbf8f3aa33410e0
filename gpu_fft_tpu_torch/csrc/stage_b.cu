// Stage B of the staged large-n transform (K4): the row transforms of
// length n2 = m1 * 128 over stage A's (B, n1, n2) output, the global digit
// reversal folded into their store, the transform's scale applied there.
//
// It replaces no Pallas kernel: the JAX package leaves stage B to XLA as
// einsums (gpu_fft_tpu/kernels/fused_jnp.py:stage_b_jnp), which the torch
// engine kernels/fused_torch.py:stage_b copies as contractions.  Math, for
// each row (b, k1) of Y (stage A's twiddle already applied), viewed
// (m1, 128) = [a, c], w_L = exp(sign 2 pi i / L):
//   P[k, c] = sum_a w_m1^(a k) Y[b, k1, a 128 + c]      column DFTs
//   Z[k, c] = P[k, c] * w_n2^(k c)                      the row twiddle
//   X[b, (j m1 + k) n1 + k1] = scale * sum_c w_128^(c j) Z[k, c]
// which is K1's four-step (radix.cuh, whole_kernel<128, true>) with m1 in
// K1's n1 role and another store: X is the spectrum in natural order.
//
// What bounds it on an H100: the bytes.  Y is read once and X written once,
// 16 bytes a complex point (1.07 GB at B = 64, n = 2^20: 0.32 ms at
// 3.35 TB/s), against 5 log2(n2) = 65 FLOP a point on the CUDA cores.
//
// The store is the transpose of the digit reversal: row k1 of Y owns the
// outputs k1 + n1 k2, one float in n1 of each plane.  Written a row at a
// time, each 4-byte store would take a 32-byte sector of its own (2.4x the
// time at the matched filter's shape, measured).  So a cluster of G C
// blocks takes G consecutive rows k1 of one signal, C blocks a row: block
// (g, r) runs K1's row transform on row g, stage 1 on its 128 / C columns,
// stage 2 on its m1 / C rows k (Z exchanged among the C blocks of the row
// over distributed shared memory, as K1 does), and its last pass leaves the
// results in its shared memory in the order of k2.  After a cluster barrier
// block rho stores the k2 in [rho n2 / (G C), (rho + 1) n2 / (G C)) of all G
// rows, gathered from the G blocks that hold them, G lanes a k2, so that at
// G = 8 every store fills whole 32-byte sectors.  A second barrier keeps
// every block's shared memory until the gathers are done.  Nothing is read
// twice, and the row transforms exchange no more than K1's (dealing stage 2
// out by k over all G C blocks instead, Z exchanged across the G rows,
// measured 6-8% slower).  G is capped by the cluster (at most 16 blocks): a row of n2 > 16,384 needs
// C >= 4 blocks of 1,024 threads, so there G = 16 / C.  fp32 on the CUDA
// cores, no tensor cores, no TF32.
//
// The wrapper (kernels/fused.py: stage_b_geometry) picks G, C, the block
// size (n2 / (8 C) threads) and the dynamic shared memory; the entry point
// checks them and launches with cudaLaunchKernelEx.  A refused launch is
// returned as an error; nothing falls back.
#include "radix.cuh"

namespace gft {
namespace {

constexpr int N2 = 128;  // the row's minor factor; m1 = n2 / 128
constexpr int LOG_N2 = 7;

// Root tables (row 1 of F1 (m1, m1) and of F2 (128, 128), unscaled) and the
// row twiddle laid out (m1, 128) = [k, c].
struct StageB {
  const float *w1r, *w1i, *twr, *twi, *w2r, *w2i;
};

// Cluster of G * C blocks on rows row0 .. row0 + G - 1 of the (B n1, n2)
// input; block rank = g C + r.  n1 is stage A's n1 (the output's stride),
// m1 = n2 / 128.
template <int G>
__global__ void __launch_bounds__(1024) stage_b_kernel(const float* __restrict__ xr,
                                                       const float* __restrict__ xi, StageB tab,
                                                       float* __restrict__ yr, float* __restrict__ yi,
                                                       int n1, int m1, float scale) {
  constexpr int LG = ilog2(G);
  // Stage 2: two radix-8 passes, then one of radix 2 from 2^6.
  constexpr int LNS2 = 6;
  cg::cluster_group cluster = cg::this_cluster();
  const int CG = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lm1 = ilog2(m1), lCG = ilog2(CG), lC = lCG - LG, C = 1 << lC;
  const int g = rank >> lC, r = rank & (C - 1);
  const int lW = LOG_N2 - lC, W = 1 << lW;
  const int lM2 = lm1 - lC, M2 = 1 << lM2;
  const int ld2 = stage2_ld<N2>(M2);
  const int ldz = m1 + 1;  // column stride of Z (stage 1's result)
  const size_t n2 = (size_t)m1 << LOG_N2;
  const size_t row0 = (size_t)(blockIdx.x >> lCG) << LG;

  extern __shared__ float2 smem[];
  float2* tile = smem;
  float2* w1 = smem + (smem_values<N2>(m1, C) - m1 - N2);
  float2* w2 = w1 + m1;

  // Stage 1 runs radix-8 passes, the last of radix 8, 2 or 4 (2^lRl) from
  // 2^lNsl; its outputs' twiddle is loaded now, under the passes before.
  const int lRl = lm1 % 3 == 0 ? 3 : lm1 % 3, lNsl = lm1 - lRl;
  float2 tw[E];
  {
    const float* twr = tab.twr + r * W;
    const float* twi = tab.twi + r * W;
    if (lRl == 3) load_tw<8, N2>(tw, T, lNsl, lW, twr, twi);
    else if (lRl == 2) load_tw<4, N2>(tw, T, lNsl, lW, twr, twi);
    else load_tw<2, N2>(tw, T, lNsl, lW, twr, twi);
  }
  const float s = __ldg(tab.w1i + m1 / 4) > 0.f ? 1.f : -1.f;  // Im w_m1^(m1/4) = sign
  for (int i = t; i < m1; i += T) w1[i] = make_float2(__ldg(tab.w1r + i), __ldg(tab.w1i + i));
  for (int i = t; i < N2; i += T) w2[i] = make_float2(__ldg(tab.w2r + i), __ldg(tab.w2i + i));

  auto block_sync = [] { __syncthreads(); };
  auto cluster_sync = [&] {
    if (CG > 1) cluster.sync();
    else __syncthreads();
  };
  // Between stage 1 and stage 2 only the C blocks of a row share data.
  auto row_sync = [&] {
    if (C > 1) cluster.sync();
    else __syncthreads();
  };

  // ── Stage 1: column DFTs of length m1 of row g on its (m1, W) tile ──────
  const size_t in = (row0 + g) * n2 + r * W;
  const float* xrb = xr + in;
  const float* xib = xi + in;
  auto from_x = [&](int, int m, int l) {
    return make_float2(__ldg(xrb + ((size_t)l << LOG_N2) + m), __ldg(xib + ((size_t)l << LOG_N2) + m));
  };
  whole_stage1(T, lm1, lW, ldz, w1, s, tile, tw, from_x);
  row_sync();  // the row's Z is in the shared memory of its C blocks

  // ── Stage 2: row DFTs of length 128 on rows k in [r M2, (r+1) M2) ──────
  // Pass 1 reads row k of Z from the block of row g that owns its column.
  auto from_row = [&](int, int m, int l) {
    const float2* owner = C > 1 ? cluster.map_shared_rank(tile, (g << lC) + (l >> lW)) : tile;
    return owner[(l & (W - 1)) * ldz + r * M2 + m];
  };
  auto tile2 = [&](int, int m, int l) { return tile[m * ld2 + l]; };
  auto to_tile2 = [&](int, int m, int l, float2 v) { tile[m * ld2 + l] = v; };
  // After this barrier no block reads another's tile, so each overwrites its own.
  stockham_pass<8>(T, LOG_N2, 0, lM2, w2, s, from_row, row_sync, to_tile2);
  __syncthreads();
  stockham_pass<8>(T, LOG_N2, 3, lM2, w2, s, tile2, block_sync, to_tile2);
  __syncthreads();
  // The last pass leaves output j of row k = r M2 + m, that is k2 = j m1 + k,
  // at tile[j M2 + m].
  auto to_k2 = [&](int, int m, int l, float2 v) { tile[(l << lM2) + m] = make_float2(scale * v.x, scale * v.y); };
  stockham_pass<2>(T, LOG_N2, LNS2, lM2, w2, s, tile2, block_sync, to_k2);
  cluster_sync();  // every row's outputs are in the cluster's shared memory

  // ── The store: X[b, k2 n1 + k1] for the G rows k1 of each k2 ─────────
  // A warp's lanes take 32 / G neighbouring k2 and the G rows of each: the
  // G lanes of one k2 fill one run of G floats, and a store instruction
  // touches 32 / G runs (at G = 8, four whole 32-byte sectors; the same
  // runs stored by fewer, wider stores, more k2 an instruction, measured
  // 1.4-1.9x slower).  Its reads take the G blocks of a cluster in turn.
  const int ln1 = ilog2(n1);
  const size_t out = (row0 >> ln1) * ((size_t)n1 * n2) + (row0 & (n1 - 1));
  const int lane = t & 31, q = lane & (G - 1), nw = T >> 5;
  const int p0 = rank * (int)(n2 >> lCG) + (lane >> LG);
  const float2* owner = tile;
  if (CG > 1) owner = cluster.map_shared_rank(tile, q << lC);
#pragma unroll
  for (int u = 0; u < E; ++u) {
    const int p = p0 + (((t >> 5) + u * nw) << (5 - LG));  // k2
    const int k = p & (m1 - 1);
    const float2* src = C > 1 ? cluster.map_shared_rank(tile, (q << lC) + (k >> lM2)) : owner;
    const float2 v = src[((p >> lm1) << lM2) + (k & (M2 - 1))];
    yr[out + (size_t)p * n1 + q] = v.x;
    yi[out + (size_t)p * n1 + q] = v.y;
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <int G>
cudaError_t launch_g(const float* xr, const float* xi, const StageB& tab, float* yr, float* yi,
                     int n1, int m1, float scale, unsigned blocks, int cluster, int threads, int smem,
                     cudaStream_t stream) {
  static bool done[MAX_DEVICES];
  const cudaError_t e = configure(stage_b_kernel<G>, true, done);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
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
  return cudaLaunchKernelEx(&cfg, stage_b_kernel<G>, xr, xi, tab, yr, yi, n1, m1, scale);
}

}  // namespace
}  // namespace gft

// F1 is (m1, m1) and F2 (128, 128), unscaled: their row 1 starts at m1 and
// 128.  twr / twi: (m1, 128).  x, y: (batch, n1, m1 * 128), y the spectrum
// of each row (batch, n1 m1 128) in natural order, times scale.  n1: a power
// of two; m1: a power of two in [8, 512]; rows (G): 1, 2, 4 or 8, dividing
// n1 and cluster; cluster: a power of two <= min(16, m1); threads =
// m1 * 128 / (8 * cluster / rows) in [32, 1024]; smem >= smem_values(m1, C) * 8
// bytes.  Returns the launch's error, then cudaGetLastError().
extern "C" int gft_stage_b(const float* xr, const float* xi, const float* f1r, const float* f1i,
                           const float* f2r, const float* f2i, const float* twr, const float* twi,
                           float* yr, float* yi, int batch, int n1, int m1, int rows, int cluster,
                           int threads, int smem, float scale, void* stream) {
  using namespace gft;
  if (!xi || !pow2(n1) || !pow2(m1) || m1 < 8 || m1 > 512 || !pow2(rows) || rows > 8 || !pow2(cluster) ||
      rows > n1 || cluster % rows || cluster > MAX_CLUSTER || cluster > m1 || batch < 1 ||
      threads > 1024 || threads < 32 || (long long)threads * E * (cluster / rows) != (long long)m1 * N2 ||
      (long long)smem < (long long)smem_values<N2>(m1, cluster / rows) * (long long)sizeof(float2) ||
      (long long)batch * (n1 / rows) * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const StageB tab{f1r + m1, f1i + m1, twr, twi, f2r + N2, f2i + N2};
  const auto launch = rows == 8 ? launch_g<8> : rows == 4 ? launch_g<4> : rows == 2 ? launch_g<2> : launch_g<1>;
  const cudaError_t e = launch(xr, xi, tab, yr, yi, n1, m1, scale,
                               (unsigned)((long long)batch * (n1 / rows) * cluster), cluster, threads, smem,
                               static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// K1F and K2F: the whole four-step of a transform on the bf16 tensor
// cores, the "fast" (GPU_FFT_TPU_PRECISION=fast) counterparts of K1 / K2.
//
// Replaces gpu_fft_tpu/kernels/fused.py:whole_transform (K1, bodies
// _whole_real_kernel / _whole_complex_kernel and _whole_stage2) and
// whole_transform_packed (K2, _whole_packed_real_kernel /
// _whole_packed_complex_kernel) as they run under "fast", where every dot
// takes lax.Precision.DEFAULT: bf16 operands, fp32 accumulation.  Per row
// of n = n1 * 128 (x viewed (n1, 128) = [a, c]):
//   stage 1  P (n1 x 128) = F1 (n1 x n1) X, K1 in the Karatsuba form
//            (complex input) and K2 in the 4-product form of its stacked
//            [F1r; F1i]; real input takes Fr x and Fi x in both;
//   twiddle  Z = P * TW in fp32, then Z rounded to bf16 as stage 2 takes it;
//   stage 2  Y (128 x n1) = F2 (128 x 128) Z^T (the contraction over c),
//            K1 Karatsuba, K2 4-product; Y[j, k1] is the natural-order
//            spectrum k = k1 + n1 * j.
// The products are mma_bf16.cuh's mma.sync m16n8k16 (wgmma's 64-row tiles
// would not fit n1 < 64, and the products are not what bounds it).
//
// What bounds it on an H100: not the tensor cores (K1F complex at 16,384 is
// 3 + 3 products of 128^3 multiply-adds, 25 MFLOP, 0.025 us at 989
// TFLOP/s) nor HBM (x, the twiddle and Y, 0.38 MB at 16,384 complex, 0.11
// us at 3.35 TB/s; the tables stay in L2), but latency: the 0.971 us
// launch wall, one L2 round trip for the data and the tables, the cluster
// barriers, and the bytes each SM takes in from L2 and, several times
// slower a byte, from its peers' shared memory (PERF.md).  So every table
// arrives by bulk (TMA) copies that one thread issues once its own loads
// are in flight (tma.cuh); the products read their A fragments
// from shared memory with the depth loops unrolled (n1 is a template
// argument); no byte of x, F1, F2 or the twiddle leaves L2 twice within a
// row but where n1 <= 16; and the exchange between blocks is kept to Z's
// columns a block's k1 need.
//
// Decomposition: C blocks a row (kernels/fused.py:whole_bf16_geometry picks
// C, the block size and the shared memory; whole_bf16_split, the Python
// mirror of Layout::parts, says V; whole_bf16_slices gives each block's
// share and whole_bf16_traffic its bytes).  Stage 2 of block r computes
// Y's rows j of part r / V of C / V and its columns k1 of part r % V, over
// all 128 of depth c, from those F2 rows (bulk copies, multicast to the
// blocks of the same j rows when V > 1).
// Stage 1 runs
//   n1 <= 16 (C = 8 blocks, no cluster): in every block, on all 128
//     columns: each reads all of x, F1 and the twiddle, so the blocks need
//     no barrier (n1 = 16 complex: 16 + 16 + 1.5 KB a block);
//   n1 = 32, the broadcast (a cluster of 8, V = 1): in every block on all
//     128 columns, x, F1 and the twiddle multicast to the cluster (block r
//     copies the r-th C-th of each, the twiddle a row a copy into rows
//     padded free of bank conflicts), so no Z crosses between blocks;
//   n1 >= 64, the exchange (V = min(C, n1 / 16), a cluster of 8): on the
//     columns c in [r 128/C, (r + 1) 128/C), its x and twiddle columns read
//     once, F1 by multicast; the Z columns are staged in x's operands' place
//     and each row k1 goes, 16 bytes a distributed-shared-memory store, to
//     the blocks of its k1 part; one cluster barrier, then stage 2.
// A warp takes one unit of each stage: stage 1 a 16-row tile of k1 by 16
// columns of c (tiles of F1 in depth a), stage 2 a 16-row tile of j by 16
// columns of k1 (8 for n1 = 8); the block has as many warps as the larger
// stage has units (at least 4).  n1 = 8 pads stage 1's rows and depth to
// 16 (the image is zero there, x's operands too).
//
// Shared memory (bf16): F1's held slots [s][mt][kt][lane][8], n1p^2 each
// (n1p = max(n1, 16)); the block's F2 rows [s][mt][kt][lane][8]; x's
// operands [o][c][a], row n1p + 8 (the exchange stages Z's columns there
// after stage 1, row columns + 8); Z's operands [o][k1][c], row 136 (the
// broadcast lands x's fp32 planes there first); the broadcast's fp32
// twiddle, row 136.  Rows are padded so the B reads are free of bank
// conflicts.
//
// Bytes a block reads from L2 at B = 1 (whole_bf16_traffic; x and twiddle
// fp32, the tables bf16; K1F real / complex input):
//   n1 = 8 (1,024): x 4 / 8 KB, twiddle 8 KB, F1 1 / 1.5 KB, F2 12 KB (its
//     16 rows; K2F 8 KB); 25,984 / 38,784 bytes of shared memory;
//   n1 = 32 (4,096): x 2 / 4 KB, twiddle 4 KB, F1 0.5 / 0.75 KB issued (each
//     block receives the whole 4 / 6 KB, x's 16 / 32 KB and the twiddle's
//     32 KB), F2 12 KB; no peer bytes; 87,552 / 116,736 bytes;
//   n1 = 128 (16,384): x 8 / 16 KB, twiddle 16 KB, F1 8 / 12 KB issued (64 /
//     96 KB received), F2 12 KB issued (96 KB received), and 10.5 KB of Z
//     from the peers; 195,328 / 228,096 bytes.
//
// The kernel, its layout and launch live here; whole_bf16.cu instantiates
// K1F's product forms and holds the C entry, whole_bf16_packed.cu K2F's,
// so that the two compile in parallel.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "mma_bf16.cuh"
#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gft::bf16mma;

constexpr int N2 = 128;        // row length of the (n1, 128) view
constexpr int LD2 = N2 + 8;    // Z's operand row (bf16): depth c
constexpr int MAX_CLUSTER = 8;  // 128 / C >= 16 rows j and columns c a block
constexpr int MAX_THREADS = 512;  // 16 units a stage at the most: 128 registers a thread
constexpr int SMEM_LIMIT = 232448;

// The block's layout, for the kernel and the C entry's checks alike, by
// c = the blocks a row.  The mode follows from n1 and c: no cluster for
// n1 <= 16 or c = 1; the broadcast at n1 = 32; the exchange from 64, with
// stage 2 split into V = min(c, n1 / 16) parts of k1 by c / V parts of j.
template <int N1, int F1, int F2>
struct Layout {
  static constexpr int NP = N1 < 16 ? 16 : N1;  // stage 1's rows and depth, padded to a tile
  static constexpr int KT1 = NP / 16;            // its depth tiles (= its row tiles)
  static constexpr int LD1 = NP + 8;             // x's operand row (bf16): depth a
  static constexpr int NT2 = N1 < 16 ? 1 : 2;    // k1 column tiles of a stage-2 unit
  static constexpr int F1_SLOT = NP * NP;        // bf16 of one F1 slot
  static constexpr int PLANES = F1 == REAL2 ? 1 : 2;  // x's fp32 planes
  static constexpr int TWLD = N2 + 8;  // the broadcast's twiddle row (fp32), free of bank conflicts
  __host__ __device__ static constexpr int min2(int a, int b) { return a < b ? a : b; }
  __host__ __device__ static constexpr int max2(int a, int b) { return a > b ? a : b; }
  __host__ __device__ static constexpr bool bcast(int c) { return c > 1 && N1 == 32; }
  __host__ __device__ static constexpr bool exchange(int c) { return c > 1 && N1 >= 64; }
  __host__ __device__ static constexpr int parts(int c) { return exchange(c) ? min2(c, N1 / 16) : 1; }  // V
  __host__ __device__ static constexpr int cols(int c) { return exchange(c) ? N2 / c : N2; }  // stage 1's c
  __host__ __device__ static constexpr int rows(int c) { return N2 * parts(c) / c; }  // stage 2's rows j
  __host__ __device__ static constexpr int krows(int c) { return N1 / parts(c); }     // its columns k1
  __host__ __device__ static constexpr int ldo(int c) { return cols(c) + 8; }         // staged Z row
  __host__ __device__ static constexpr int f2_slot(int c) { return rows(c) * N2; }
  __host__ __device__ static constexpr int units1(int c) { return KT1 * (cols(c) / 16); }
  __host__ __device__ static constexpr int units2(int c) { return rows(c) / 16 * (krows(c) / (8 * NT2)); }
  __host__ __device__ static constexpr int xunits(int c) { return cols(c) * (NP / 8); }
  __host__ __device__ static constexpr int warps(int c) { return max2(max2(units1(c), units2(c)), 4); }
  // bf16 elements of x's operands (the exchange stages Z's columns there)
  __host__ __device__ static constexpr int xz(int c) {
    return max2(Form<F1>::NB * cols(c) * LD1, exchange(c) ? Form<F2>::NB * N1 * ldo(c) : 0);
  }
  // ... of Z's operands (the broadcast lands x's fp32 planes there first)
  __host__ __device__ static constexpr int zsize(int c) {
    return max2(Form<F2>::NB * krows(c) * LD2, bcast(c) ? 2 * PLANES * N1 * N2 : 0);
  }
  __host__ __device__ static constexpr int f2_at() { return Form<F1>::NS * F1_SLOT; }
  __host__ __device__ static constexpr int x_at(int c) { return f2_at() + Form<F2>::NS * f2_slot(c); }
  __host__ __device__ static constexpr int z_at(int c) { return x_at(c) + xz(c); }
  __host__ __device__ static constexpr int tw_at(int c) { return z_at(c) + zsize(c); }
  __host__ __device__ static constexpr int bytes(int c) {
    return 2 * (tw_at(c) + (bcast(c) ? 4 * N1 * TWLD : 0));  // the broadcast's fp32 twiddle
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// img1: F1's fragment image (slots r, i, s, d for K1; r, i for K2), n1
// padded to 16; img2: F2's (128 x 128); twr, twi: the (n1, 128) twiddle;
// xi null for real input.  Grid: C blocks a row, rows in order; block r is
// (u, v) = (r / V, r % V) of stage 2's split.
// One block an SM: up to 128 registers a thread.
template <int N1, int F1, int F2>
__global__ void __launch_bounds__(MAX_THREADS, 1)
whole_bf16_kernel(const float* __restrict__ xr, const float* __restrict__ xi, const __nv_bfloat16* __restrict__ img1,
                  const __nv_bfloat16* __restrict__ img2, const float* __restrict__ twr,
                  const float* __restrict__ twi, float* __restrict__ yr, float* __restrict__ yi, int cluster) {
  using L = Layout<N1, F1, F2>;
  const bool bcast = L::bcast(cluster), exchange = L::exchange(cluster);  // each false but at its n1
  using P1 = Form<F1>;
  using P2 = Form<F2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // F1, the block's F2 rows, the broadcast's x and twiddle
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* f1s = sm;
  __nv_bfloat16* f2s = sm + L::f2_at();
  __nv_bfloat16* xs = sm + L::x_at(cluster);  // x's operands; Z's staged columns after stage 1
  __nv_bfloat16* zs = sm + L::z_at(cluster);  // the broadcast's x planes (fp32) first
  const float* tws = reinterpret_cast<const float*>(sm + L::tw_at(cluster));  // the broadcast's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = L::parts(cluster), r = blockIdx.x % cluster, u = r / split, v = r % split;
  const size_t base = (size_t)(blockIdx.x / cluster) * N1 * N2;
  const int w = L::cols(cluster), c0 = exchange ? r * w : 0;  // stage 1's columns
  const int jr = L::rows(cluster), kr = L::krows(cluster);    // stage 2's rows j and columns k1
  const int f2_slot = L::f2_slot(cluster);
  const uint32_t bar1 = gft::smem_u32(&bars[0]), bar2 = gft::smem_u32(&bars[1]), bar3 = gft::smem_u32(&bars[2]);
  constexpr uint32_t PLANE = 4 * N1 * N2;  // bytes of an fp32 (n1, 128) plane

  // The twiddle of this warp's stage-1 unit (16 rows k1 from 16 mt1, 16
  // columns from c0 + 16 cu), in registers until the epilogue.
  const int units1 = L::units1(cluster);
  const int mt1 = warp % L::KT1, cu = warp / L::KT1;
  float2 w_r[2][2], w_i[2][2];
  if (warp < units1 && !bcast) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k1 = 16 * mt1 + g + 8 * h, c = c0 + 16 * cu + 8 * j + 2 * t;
        if (k1 < N1) {
          w_r[h][j] = __ldg(reinterpret_cast<const float2*>(twr + k1 * N2 + c));
          w_i[h][j] = __ldg(reinterpret_cast<const float2*>(twi + k1 * N2 + c));
        }
      }
  }

  // x: thread u loads column c0 + u % w, depths 8 (u / w) .. + 7.
  const bool has_x = tid < L::xunits(cluster);
  const int xc = tid % w, xa = tid / w * 8;
  float re[8], im[8];
  if (has_x && !bcast) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int a = xa + j;
      const size_t at = base + (size_t)a * N2 + c0 + xc;
      re[j] = a < N1 ? __ldg(xr + at) : 0.f;
      im[j] = (xi != nullptr && a < N1) ? __ldg(xi + at) : 0.f;
    }
  }
  // The tables, once this thread's loads are in flight (one thread issues
  // every copy: spreading them over a warp's lanes was slower): now, or by
  // multicast once every block of the cluster has its barriers.  F2's rows
  // j of the block now (by multicast to the blocks of the same u with the
  // exchange), F1 now or by multicast with the exchange and the broadcast.
  if (tid == 0) {
    gft::mbar_init(bar1, 1);
    gft::mbar_init(bar2, 1);
    if (bcast) gft::mbar_init(bar3, 1);
    gft::mbar_init_fence();
    gft::mbar_expect_tx(bar1, 2 * P1::NS * L::F1_SLOT);
    gft::mbar_expect_tx(bar2, 2 * P2::NS * f2_slot);
    if (bcast) gft::mbar_expect_tx(bar3, (L::PLANES + 2) * PLANE);
    if (!exchange) {
#pragma unroll
      for (int s = 0; s < P2::NS; ++s)
        gft::bulk_load(gft::smem_u32(f2s + s * f2_slot),
                       img2 + (size_t)P2::table(s) * N2 * N2 + (size_t)u * f2_slot, 2 * f2_slot, bar2);
    }
    if (!exchange && !bcast) {
#pragma unroll
      for (int s = 0; s < P1::NS; ++s)
        gft::bulk_load(gft::smem_u32(f1s + s * L::F1_SLOT), img1 + (size_t)P1::table(s) * L::F1_SLOT,
                       2 * L::F1_SLOT, bar1);
    }
  }

  if (exchange || bcast) {
    // Every block's barriers are initialised (the loads above stay in
    // flight meanwhile); then this block multicasts its C-th of each plane
    // of x and of the twiddle (the broadcast), its C-th of each F1 slot to
    // the cluster and (the exchange) its V-th of each of its F2 slots to
    // the blocks of its u.
    cluster_arrive_relaxed();
    cluster_wait();
    if (tid == 0) {
      const uint16_t all = (uint16_t)((1u << cluster) - 1);
      if (bcast) {
        const uint32_t piece = PLANE / cluster, rows = N1 / cluster;
#pragma unroll
        for (int p = 0; p < L::PLANES; ++p)
          gft::bulk_load_multicast(gft::smem_u32(zs) + p * PLANE + r * piece, (p ? xi : xr) + base + r * piece / 4,
                                   piece, bar3, all);
        // the twiddle a row a copy, into rows of TWLD
        for (int i = 0; i < 2 * rows; ++i) {
          const int p = i / rows, k1 = r * rows + i % rows;
          gft::bulk_load_multicast(gft::smem_u32(tws) + 4 * (p * N1 + k1) * L::TWLD, (p ? twi : twr) + k1 * N2,
                                   4 * N2, bar3, all);
        }
      }
      const uint32_t piece = 2 * L::F1_SLOT / cluster;
#pragma unroll
      for (int s = 0; s < P1::NS; ++s)
        gft::bulk_load_multicast(gft::smem_u32(f1s + s * L::F1_SLOT) + r * piece,
                                 img1 + (size_t)P1::table(s) * L::F1_SLOT + (size_t)r * piece / 2, piece, bar1, all);
      if (exchange) {
        const uint32_t piece2 = 2 * f2_slot / split;
#pragma unroll
        for (int s = 0; s < P2::NS; ++s)
          gft::bulk_load_multicast(
              gft::smem_u32(f2s + s * f2_slot) + v * piece2,
              img2 + (size_t)P2::table(s) * N2 * N2 + (size_t)u * f2_slot + (size_t)v * piece2 / 2, piece2, bar2,
              (uint16_t)(((1u << split) - 1) << (u * split)));
      }
    }
  }
  if (bcast) {
    gft::wait_phase0(bar3);
    const float* xin = reinterpret_cast<const float*>(zs);
    if (has_x) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        re[j] = xin[(xa + j) * N2 + xc];
        im[j] = L::PLANES > 1 ? xin[N1 * N2 + (xa + j) * N2 + xc] : 0.f;
      }
    }
  }
  if (has_x) store_operands<F1>(xs, w * L::LD1, L::LD1, xc, xa, re, im);
  __syncthreads();  // x's operands stored; the barriers initialised
  gft::wait_phase0(bar1);

  // Stage 1 and the twiddle -> Z's operands at their columns c: in zs
  // (rows k1, all columns), or with the exchange staged in place of x's
  // operands (rows k1, this block's columns).
  float acc1[P1::NQ][2][4];
  if (warp < units1)
    warp_tile_smem<F1, 2, L::KT1>(acc1, reinterpret_cast<const uint4*>(f1s), L::F1_SLOT / 8, mt1, xs,
                                  w * L::LD1, L::LD1, 16 * cu, lane);
  if (exchange) __syncthreads();  // x's operands read: the staging overwrites them
  __nv_bfloat16* zt = exchange ? xs : zs;
  const int zld = exchange ? L::ldo(cluster) : LD2;
  if (warp < units1) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k1 = 16 * mt1 + g + 8 * h;
        if (k1 < N1) {
          const int c = 16 * cu + 8 * j + 2 * t;  // of the block's columns
          const float2 p0 = combined<F1>(acc1, j, 2 * h), p1 = combined<F1>(acc1, j, 2 * h + 1);
          const float* tw = tws + k1 * L::TWLD + c;  // the broadcast's (c0 = 0)
          const float2 a = bcast ? *reinterpret_cast<const float2*>(tw) : w_r[h][j];
          const float2 b = bcast ? *reinterpret_cast<const float2*>(tw + N1 * L::TWLD) : w_i[h][j];
          const float zr[2] = {p0.x * a.x - p0.y * b.x, p1.x * a.y - p1.y * b.y};
          const float zi[2] = {p0.x * b.x + p0.y * a.x, p1.x * b.y + p1.y * a.y};
          __nv_bfloat16 lo[P2::NB], hi[P2::NB];
          P2::fill(zr[0], zi[0], lo);
          P2::fill(zr[1], zi[1], hi);
#pragma unroll
          for (int o = 0; o < P2::NB; ++o)
            *reinterpret_cast<uint32_t*>(zt + (o * N1 + k1) * zld + c) = pack2(lo[o], hi[o]);
        }
      }
  }
  __syncthreads();

  if (exchange) {
    // The staged Z columns to the blocks whose k1 they are (this one
    // among them), 16 bytes a store, at the same offset in each; then one
    // cluster barrier (release / acquire) before anyone reads them.
    cg::cluster_group cl = cg::this_cluster();
    const int per_row = w / 8, cu2 = cluster / split;
    for (int i = tid; i < P2::NB * N1 * per_row; i += blockDim.x) {
      const int row = i / per_row, ch = i % per_row, o = row / N1, k1 = row % N1;
      const uint4 val = *reinterpret_cast<const uint4*>(xs + row * zld + 8 * ch);
      __nv_bfloat16* p = zs + (o * kr + k1 % kr) * LD2 + c0 + 8 * ch;
      for (int q = 0; q < cu2; ++q) *reinterpret_cast<uint4*>(cl.map_shared_rank(p, q * split + k1 / kr)) = val;
    }
    cl.sync();
  }
  gft::wait_phase0(bar2);
  if (bcast) cluster_arrive_relaxed();  // every multicast into this block has landed

  // Stage 2: unit = a 16-row tile of the block's j by NT2 column tiles of
  // its k1.
  if (warp < L::units2(cluster)) {
    const int tiles = jr / 16;
    const int mt2 = warp % tiles, n0 = 8 * L::NT2 * (warp / tiles);
    float acc[P2::NQ][L::NT2][4];
    warp_tile_smem<F2, L::NT2, N2 / 16>(acc, reinterpret_cast<const uint4*>(f2s), f2_slot / 8, mt2, zs,
                                        kr * LD2, LD2, n0, lane);
#pragma unroll
    for (int j = 0; j < L::NT2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = u * jr + 16 * mt2 + g + 8 * h, k1 = v * kr + n0 + 8 * j + 2 * t;
        const float2 v0 = combined<F2>(acc, j, 2 * h), v1 = combined<F2>(acc, j, 2 * h + 1);
        const size_t at = base + (size_t)row * N1 + k1;
        *reinterpret_cast<float2*>(yr + at) = make_float2(v0.x, v1.x);
        *reinterpret_cast<float2*>(yi + at) = make_float2(v0.y, v1.y);
      }
  }
  if (bcast) cluster_wait();  // no block leaves while its multicasts may still land elsewhere
}

// The shared-memory size is opted into once per device and kernel, at the
// card's limit less the kernel's static barriers, so that a launch
// captured into a CUDA graph makes no such call.
template <class Kernel>
cudaError_t configure(Kernel kernel, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  done[dev] = true;
  return cudaSuccess;
}

template <int N1, int F1, int F2>
int launch(const float* xr, const float* xi, const void* img1, const void* img2, const float* twr,
           const float* twi, float* yr, float* yi, int batch, int cluster, int threads, int smem,
           cudaStream_t s) {
  using L = Layout<N1, F1, F2>;
  if (threads % 32 || threads > MAX_THREADS || threads < 32 * L::warps(cluster) || threads < L::xunits(cluster) ||
      smem < L::bytes(cluster) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static bool done[MAX_DEVICES];
  auto kernel = whole_bf16_kernel<N1, F1, F2>;
  cudaError_t e = configure(kernel, done);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::exchange(cluster) || L::bcast(cluster) ? (unsigned)cluster : 1u;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, xr, xi, static_cast<const __nv_bfloat16*>(img1),
                         static_cast<const __nv_bfloat16*>(img2), twr, twi, yr, yi, cluster);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int F1, int F2>
int by_n1(const float* xr, const float* xi, const void* img1, const void* img2, const float* twr, const float* twi,
          float* yr, float* yi, int batch, int n1, int cluster, int threads, int smem,
          cudaStream_t s) {
  switch (n1) {
    case 8: return launch<8, F1, F2>(xr, xi, img1, img2, twr, twi, yr, yi, batch, cluster, threads, smem, s);
    case 16: return launch<16, F1, F2>(xr, xi, img1, img2, twr, twi, yr, yi, batch, cluster, threads, smem, s);
    case 32: return launch<32, F1, F2>(xr, xi, img1, img2, twr, twi, yr, yi, batch, cluster, threads, smem, s);
    case 64: return launch<64, F1, F2>(xr, xi, img1, img2, twr, twi, yr, yi, batch, cluster, threads, smem, s);
    case 128: return launch<128, F1, F2>(xr, xi, img1, img2, twr, twi, yr, yi, batch, cluster, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

namespace gft {

// K2F's half of gft_whole_bf16 (whole_bf16_packed.cu).
int whole_bf16_packed(const float* xr, const float* xi, const void* img1, const void* img2, const float* twr,
                      const float* twi, float* yr, float* yi, int batch, int n1, int cluster, int threads,
                      int smem, cudaStream_t s);

}  // namespace gft

// The stage-A dot on the bf16 tensor cores: a stacked table F against x
// (B, n1, n2) on wgmma, the results handed to an epilogue.
//
// Computes, for the 64-row groups g < `groups` of F and the first `ncols`
// columns of every signal b, the products of the group's bf16 F parts with
// the bf16 operands of x, split in the kernel with __float2bfloat16_rn
// (round to nearest even, as a DEFAULT dot and astype round), accumulated
// in fp32 and combined into OUT planes of 64 rows (a Form, below), and
// hands each block's finished tile to an epilogue functor from a padded
// fp32 staging tile:
//   Epi::store<RB, THREADS>(stg, m0, b, c0, t)
// stores the tile of the block's WGS = RB / 64 groups, group m0 / 64 on,
// for columns c0 .. c0 + 63 of signal b (group w's plane p, row r at
// stg + ((w * OUT + p) * 64 + r) * SLD); thread t of THREADS takes its
// share.  Four kernels run on it:
// - S3's bf16 variants (stage_a_dot.cu, replacing the Pallas bodies
//   kern_x6 / kern_x1 of scripts/ablate_mosaic_x6.py:build), F = [Fr; Fi]
//   (X6 / X1), whose epilogue splits the stacked rows into Yr and Yi;
// - S2F (stage_a_manual_bf16.cu, replacing scripts/ablate_2e20_levers.py:
//   stage_a_manual under "fast"), and K3F / K3LF on real input
//   (stage_a_bf16.cu), F interleaving Fr and Fi by 32 rows (X1), whose
//   epilogue multiplies each row pair by the twiddle;
// - K3F / K3LF on complex input, the Karatsuba three (Kara3): per 64
//   output rows the parts Fr, Fd, Fs against xr + xi, xr, xi, combined
//   into Re and Im before staging.
//
// Design, wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulate), both
// operands read from shared memory in the K-major 128-byte-swizzled layout:
// - A block owns WGS groups (NS consumer warpgroups per 64 rows, each on
//   64 / NS of a tile's columns) and keeps their F parts resident in shared
//   memory for its whole run.  The host lays the parts out as the shared
//   memory holds them (kernels/fused.py:swizzled_image), so they arrive by
//   a few bulk (TMA) copies that one thread issues, counted by an mbarrier,
//   under the first x loads.  Blocks are persistent and walk their share of
//   the 64-column tiles of x over all B signals, so F is read from L2 once
//   per block and x once per row block (once in all where one block holds
//   all the groups).  A warpgroup past the last group multiplies what its
//   unloaded share of the table holds, into rows no epilogue stores.  The
//   launch rules (kernels/ablation.py:dot_geometry, kernels/fused.py:
//   stage_a_bf16_geometry) take the most groups a block that fit the
//   shared memory; where even one group's parts do not fit at every depth
//   (Kara3 at n1 > 320) they stream through two chunk buffers (STREAM).
// - x enters in 64-deep chunks (one swizzle atom): each thread loads 8
//   depths of a column pair (of each of the PLANES fp32 planes) as 8-byte
//   words (of one column, 4-byte ones, where a block has a thread for each
//   column), splits them into the form's bf16 operands in registers and
//   stores each operand's 8 values of a column as one 16-byte word of the
//   column's row, so the stores are free of bank conflicts and the
//   operands split once per block.  Two
//   chunk buffers: chunk i + 1 is stored while the warpgroups' wgmmas on
//   chunk i run, and chunk i + 2's global loads are in flight meanwhile.
//   Columns at or past `ncols` are not loaded.
// - A tile's results leave through the staging tile, so the epilogue can
//   store them as coalesced 16-byte words; the next tile's first loads are
//   in flight under it.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "tma.cuh"
#include "twiddle.cuh"

namespace gft {
namespace dot_bf16 {

constexpr int BN = 64;   // x columns per tile (the wgmma N)
constexpr int KA = 64;   // depth of a 128-byte swizzle atom (bf16)
constexpr int ROW = 128; // bytes of an atom row
constexpr int SLD = BN + 8;  // padded row of the staging tile (floats)
// Dynamic shared memory a block may opt into on an H100: 232,448 bytes
// less the static barriers.
constexpr int SMEM_MAX = 232448 - 16;

// K-major operand, 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1,024 bytes apart (SBO), the leading offset unused (1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pins the accumulators at this point of the program: the compiler sees
// them read and written here, so no use moves across a wgmma wait.
template <int A>
__device__ __forceinline__ void pin(float (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, this thread's 32) += A (64 x 16) B (16 x 64).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, this thread's 16) += A (64 x 16) B (16 x 32).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x A / 2, this thread's A values) += A (64 x 16) B (16 x A / 2).
template <int A>
__device__ __forceinline__ void wgmma_tile(float (&d)[A], uint64_t da, uint64_t db) {
  if constexpr (A == 32)
    wgmma_m64n64k16(d, da, db);
  else
    wgmma_m64n32k16(d, da, db);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The product forms.  A form has PARTS bf16 parts of F a group, reads
// PLANES fp32 planes of x and splits them into OPS bf16 operands (split),
// keeps ACC accumulator sets, issues its wgmmas for one 16-deep step on
// the parts' descriptors da and the operands' db (mma), and combines the
// sets into OUT staged planes (combine: value i of plane p).  NS
// warpgroups share a group, each on 64 / NS of a tile's columns (Kara3: 2,
// so its three sets take half the registers and a block twice the
// threads).

// One bf16 product: F's single part against x rounded to bf16.
struct X1 {
  static constexpr int PARTS = 1, PLANES = 1, OPS = 1, ACC = 1, OUT = 1, NS = 1;
  __device__ __forceinline__ static void split(float re, float, __nv_bfloat16 (&h)[OPS]) {
    h[0] = __float2bfloat16_rn(re);
  }
  template <int A>
  __device__ __forceinline__ static void mma(float (&acc)[ACC][A], const uint64_t (&da)[PARTS],
                                             const uint64_t (&db)[OPS]) {
    wgmma_tile(acc[0], da[0], db[0]);
  }
  template <int A>
  __device__ __forceinline__ static float combine(const float (&acc)[ACC][A], int, int i) { return acc[0][i]; }
};

// The 6-term ladder of _x6 on F and x each split into three bf16 parts:
//   a1b1 + (a1b2 + a2b1) + (a1b3 + a2b2 + a3b1)
// in three accumulator sets (one per parenthesised group), summed in that
// order at the end of a tile.
struct X6 {
  static constexpr int PARTS = 3, PLANES = 1, OPS = 3, ACC = 3, OUT = 1, NS = 1;
  __device__ __forceinline__ static void split(float re, float, __nv_bfloat16 (&h)[OPS]) {
    h[0] = __float2bfloat16_rn(re);
    const float r1 = re - __bfloat162float(h[0]);
    h[1] = __float2bfloat16_rn(r1);
    h[2] = __float2bfloat16_rn(r1 - __bfloat162float(h[1]));
  }
  template <int A>
  __device__ __forceinline__ static void mma(float (&acc)[ACC][A], const uint64_t (&da)[PARTS],
                                             const uint64_t (&db)[OPS]) {
    wgmma_tile(acc[0], da[0], db[0]);  // a1 b1
    wgmma_tile(acc[1], da[0], db[1]);  // a1 b2
    wgmma_tile(acc[1], da[1], db[0]);  // a2 b1
    wgmma_tile(acc[2], da[0], db[2]);  // a1 b3
    wgmma_tile(acc[2], da[1], db[1]);  // a2 b2
    wgmma_tile(acc[2], da[2], db[0]);  // a3 b1
  }
  template <int A>
  __device__ __forceinline__ static float combine(const float (&acc)[ACC][A], int, int i) {
    return (acc[0][i] + acc[1][i]) + acc[2][i];
  }
};

// Karatsuba on complex x: parts Fr, Fd = Fi - Fr, Fs = Fr + Fi against
// bf16(xr + xi) (summed in fp32 first), bf16(xr), bf16(xi), each in its
// own set; Re = P0 - P2 and Im = P0 + P1 in fp32 (mma_bf16.cuh's KARA3).
struct Kara3 {
  static constexpr int PARTS = 3, PLANES = 2, OPS = 3, ACC = 3, OUT = 2, NS = 2;
  __device__ __forceinline__ static void split(float re, float im, __nv_bfloat16 (&h)[OPS]) {
    h[0] = __float2bfloat16_rn(re + im);
    h[1] = __float2bfloat16_rn(re);
    h[2] = __float2bfloat16_rn(im);
  }
  template <int A>
  __device__ __forceinline__ static void mma(float (&acc)[ACC][A], const uint64_t (&da)[PARTS],
                                             const uint64_t (&db)[OPS]) {
#pragma unroll
    for (int q = 0; q < 3; ++q) wgmma_tile(acc[q], da[q], db[q]);
  }
  template <int A>
  __device__ __forceinline__ static float combine(const float (&acc)[ACC][A], int p, int i) {
    return p == 0 ? acc[0][i] - acc[2][i] : acc[0][i] + acc[1][i];
  }
};

// Bytes of dynamic shared memory: the F parts of WGS groups (resident: every
// depth chunk; streamed: two chunks), two x chunk buffers of every
// operand, the staging tile, and the slack that aligns the base to 1,024.
template <class Form>
constexpr int dot_smem_bytes(int wgs, int n1, bool stream) {
  return Form::PARTS * (stream ? 2 : (n1 + KA - 1) / KA) * 64 * wgs * ROW + 2 * Form::OPS * BN * ROW +
         64 * Form::OUT * wgs * SLD * 4 + 1024;
}

// fimg: the F parts as the blocks hold them (fused.py:swizzled_image):
// per 64-row group g, per part p of the image's img_parts, per 64-deep
// chunk c, the 64 x 128-byte swizzled rows, 8 KB, so a block's parts of
// one group are one run of bytes (the kernel reads the first PARTS of
// them).  grid: row_blocks * per_rb persistent blocks, row_blocks =
// ceil(groups / WGS); block i owns groups (i / per_rb) * WGS on and the
// column tiles i % per_rb + j * per_rb of the B * ceil(ncols / 64).
// STREAM: where a group's parts at every depth do not fit (Kara3 at n1 >
// 320), they pass through two chunk buffers beside x's instead: chunk i +
// 2's copies are issued once chunk i's wgmmas are done, each buffer
// counted by its own barrier.
template <class Form, int WGS, bool STREAM, class Epi>
__global__ void __launch_bounds__(128 * WGS * Form::NS, 1)
stage_a_dot_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ xi,
                         const unsigned char* __restrict__ fimg, int img_parts, Epi epi, int batch, int n1, int n2,
                         int ncols, int groups, int per_rb) {
  constexpr int NS = Form::NS, THREADS = 128 * WGS * NS;
  constexpr int NW = BN / NS, A = NW / 2;  // a warpgroup's columns and accumulators a set
  constexpr int PARTS = Form::PARTS, OPS = Form::OPS, PLANES = Form::PLANES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t fbar[2];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kchunks = (n1 + KA - 1) / KA;
  const int fchunks = STREAM ? 2 : kchunks;                  // depth chunks of F held
  unsigned char* fs = base;  // resident [group][part][chunk][row][128 B]; streamed [stage][group][part][row][128 B]
  unsigned char* xs = fs + PARTS * fchunks * 64 * WGS * ROW;  // [stage][operand][column][128 B]
  float* stg = reinterpret_cast<float*>(xs + 2 * OPS * BN * ROW);  // [group][plane][row][SLD]

  const int t = threadIdx.x;
  const int wg = t / 128 / NS, half = t / 128 % NS, warp = (t % 128) / 32, lane = t % 32;
  const int rb = blockIdx.x / per_rb;
  const int first = blockIdx.x % per_rb;
  const int g0 = rb * WGS;
  const int live = min(WGS, groups - g0);  // groups of this block in the image
  const int col_tiles = (ncols + BN - 1) / BN;
  const int tiles = batch * col_tiles;
  const int my_tiles = first < tiles ? (tiles - first + per_rb - 1) / per_rb : 0;
  const int iters = my_tiles * kchunks;

  // The block's F groups, every part: resident, one bulk copy per (group,
  // part) run of the image, counted by fbar[0]; streamed, one per (group,
  // part) chunk into the chunk's buffer, counted by that buffer's barrier.
  // One thread issues them.
  const uint32_t bar = smem_u32(&fbar[0]);
  const uint32_t run = kchunks * KA * ROW;  // bytes of one (group, part)
  auto fetch_f = [&](int it) {  // streamed: iteration it's chunk into buffer it & 1
    const uint32_t b = bar + 8 * (it & 1);
    const int kc = it % kchunks;
    mbar_expect_tx(b, live * PARTS * KA * ROW);
    for (int i = 0; i < live * PARTS; ++i) {
      const int g = g0 + i / PARTS, p = i % PARTS;
      bulk_load(smem_u32(fs) + ((it & 1) * WGS * PARTS + i) * KA * ROW,
                fimg + (size_t)(g * img_parts + p) * run + (size_t)kc * KA * ROW, KA * ROW, b);
    }
  };
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_init_fence();
    if constexpr (STREAM) {
      for (int it = 0; it < min(2, iters); ++it) fetch_f(it);
    } else {
      mbar_expect_tx(bar, live * PARTS * run);
      for (int i = 0; i < live * PARTS; ++i) {
        const int g = g0 + i / PARTS, p = i % PARTS;
        bulk_load(smem_u32(fs) + i * run, fimg + (size_t)(g * img_parts + p) * run, run, bar);
      }
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // x chunk `it` of this block: unit u = t + i * THREADS is W columns W (u %
  // (64 / W)) .. + W - 1 and depths 8 (u / (64 / W)) .. + 7 of the chunk:
  // one W * 4-byte load a depth and plane, so a warp's load is a contiguous
  // run.  W = 2 (8-byte loads, n2 being even), or 1 where a block has a
  // thread for each of the chunk's 512 (depth octet, column) units.
  constexpr int W = THREADS >= 8 * BN ? 1 : 2;
  constexpr int GROUPS = BN / W;  // column groups of a chunk
  constexpr int UNITS = (KA / 8 * GROUPS + THREADS - 1) / THREADS;  // units a thread, per chunk
  using Vec = std::conditional_t<W == 2, float2, float>;
  Vec v[UNITS][PLANES][8];
  auto unit_live = [&](int i, int kv, int c0) {
    const int u = t + i * THREADS;
    return (UNITS * THREADS == KA / 8 * GROUPS || u < KA / 8 * GROUPS) && (u / GROUPS) * 8 < kv &&
           c0 + W * (u % GROUPS) < ncols;
  };
  auto load = [&](int it) {
    const int tile = first + (it / kchunks) * per_rb;
    const int kc = it % kchunks;
    const int b = tile / col_tiles, c0 = (tile % col_tiles) * BN;
    const int kv = min(KA, n1 - kc * KA);
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = t + i * THREADS;
      if (unit_live(i, kv, c0)) {
        const size_t at = ((size_t)b * n1 + kc * KA + (u / GROUPS) * 8) * n2 + c0 + W * (u % GROUPS);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[i][0][j] = __ldg(reinterpret_cast<const Vec*>(x + at + (size_t)j * n2));
          if constexpr (PLANES == 2) v[i][1][j] = __ldg(reinterpret_cast<const Vec*>(xi + at + (size_t)j * n2));
        }
      }
    }
  };
  // Each unit stores its 8 depths of a column and operand as one 16-byte
  // word of the column's row; with W = 2 the two columns go in an order
  // that alternates with u % 32 / 4, so a warp's words of one store land on
  // 8 distinct 16-byte slots.  A unit that was not loaded (depths past n1,
  // columns past ncols) stores what its registers hold: no wgmma reads
  // those depths, and no epilogue stores those columns.
  auto pick = [](const Vec& q, int side) {
    if constexpr (W == 2)
      return side ? q.y : q.x;
    else
      return q;
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = t + i * THREADS;
      const int m = u % GROUPS, g = u / GROUPS;
      if (UNITS * THREADS == KA / 8 * GROUPS || u < KA / 8 * GROUPS) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int side = W == 2 ? e ^ ((m >> 2) & 1) : 0, n = W * m + side;
          uint32_t w[OPS][4];
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            __nv_bfloat16 lo[OPS], hi[OPS];
            Form::split(pick(v[i][0][j], side), PLANES == 2 ? pick(v[i][PLANES - 1][j], side) : 0.f, lo);
            Form::split(pick(v[i][0][j + 1], side), PLANES == 2 ? pick(v[i][PLANES - 1][j + 1], side) : 0.f, hi);
#pragma unroll
            for (int p = 0; p < OPS; ++p) w[p][j / 2] = pack2(lo[p], hi[p]);
          }
#pragma unroll
          for (int p = 0; p < OPS; ++p) {
            unsigned char* dst = xs + ((stage * OPS + p) * BN + n) * ROW + ((g ^ (n % 8)) * 16);
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
          }
        }
      }
    }
  };

  float acc[Form::ACC][A];
#pragma unroll
  for (int q = 0; q < Form::ACC; ++q)
#pragma unroll
    for (int i = 0; i < A; ++i) acc[q][i] = 0.f;

  if (iters > 0) {
    load(0);
    store(0);
    if (iters > 1) load(1);
  }
  if constexpr (!STREAM) wait_phase0(bar);
  fence_async_smem();
  __syncthreads();

  const uint32_t fs_a = smem_u32(fs), xs_a = smem_u32(xs);
  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1;
    const int kc = it % kchunks;
    const int ksteps = min(KA, n1 - kc * KA) / 16;
#pragma unroll
    for (int q = 0; q < Form::ACC; ++q) pin(acc[q]);
    if constexpr (STREAM) wait_parity(bar + 8 * stage, (it >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KA / 16; ++s) {
      if (s < ksteps) {
        uint64_t da[PARTS], db[OPS];
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
          da[p] = desc_sw128(fs_a + s * 32 +
                             (STREAM ? (stage * WGS + wg) * PARTS + p : (wg * PARTS + p) * kchunks + kc) * (KA * ROW));
#pragma unroll
        for (int p = 0; p < OPS; ++p) db[p] = desc_sw128(xs_a + ((stage * OPS + p) * BN + half * NW) * ROW + s * 32);
        Form::mma(acc, da, db);
      }
    }
    wgmma_commit();
    if (it + 1 < iters) store(stage ^ 1);
    if (it + 2 < iters) load(it + 2);
    wgmma_wait_all();
#pragma unroll
    for (int q = 0; q < Form::ACC; ++q) pin(acc[q]);

    if (kc == kchunks - 1) {
      // Fragment -> staging: value 4j + e sits at row 16 warp + lane / 4
      // (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + e % 2.
#pragma unroll
      for (int p = 0; p < Form::OUT; ++p) {
        const int r0 = (wg * Form::OUT + p) * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int c = half * NW + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<float2*>(stg + r0 * SLD + c) =
              make_float2(Form::combine(acc, p, 4 * j), Form::combine(acc, p, 4 * j + 1));
          *reinterpret_cast<float2*>(stg + (r0 + 8) * SLD + c) =
              make_float2(Form::combine(acc, p, 4 * j + 2), Form::combine(acc, p, 4 * j + 3));
        }
      }
      __syncthreads();
      const int tile = first + (it / kchunks) * per_rb;
      epi.template store<64 * WGS, THREADS>(stg, g0 * 64, tile / col_tiles, (tile % col_tiles) * BN, t);
#pragma unroll
      for (int q = 0; q < Form::ACC; ++q)
#pragma unroll
        for (int i = 0; i < A; ++i) acc[q][i] = 0.f;
    }
    fence_async_smem();
    __syncthreads();
    if constexpr (STREAM) {
      if (t == 0 && it + 2 < iters) fetch_f(it + 2);  // this buffer's wgmmas are done
    }
  }
}

// The stage-A epilogue (S2F; K3F and K3LF): Y = P * W for the output rows
// k1 < rows and columns c < ncols of signal b, Yr and Yi (B, rows, ncols).
// Each group holds GR output rows: warpgroup w's staged rows w * 2 GR + r
// (Re) and w * 2 GR + GR + r (Im) are output row (m0 / 64 + w) GR + r
// (GR = 32 on S2's pair stacking, one X1 plane; 64 with Kara3's two
// planes).  A thread reads 4 columns of both planes and their W (twiddle.cuh:
// quad) as 16-byte words and stores Yr and Yi as 16-byte words.
template <int GR, class Tw>
struct TwiddleRows {
  Tw tw;
  float* yr;
  float* yi;
  int rows, ncols;
  template <int RB, int THREADS>
  __device__ __forceinline__ void store(const float* stg, int m0, int b, int c0, int t) const {
#pragma unroll
    for (int i = 0; i < GR * (RB / 64) * (BN / 4) / THREADS; ++i) {
      const int q = t + i * THREADS;
      const int r = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
      const int k1 = m0 / 64 * GR + r, c = c0 + c4;
      if (k1 < rows && c < ncols) {
        const int s = r / GR * 2 * GR + r % GR;  // the Re row; Im is GR below
        const float4 re = *reinterpret_cast<const float4*>(stg + s * SLD + c4);
        const float4 im = *reinterpret_cast<const float4*>(stg + (s + GR) * SLD + c4);
        float4 wr, wi;
        tw.quad(k1, c, wr, wi);
        const size_t o = ((size_t)b * rows + k1) * ncols + c;
        *reinterpret_cast<float4*>(yr + o) = make_float4(re.x * wr.x - im.x * wi.x, re.y * wr.y - im.y * wi.y,
                                                         re.z * wr.z - im.z * wi.z, re.w * wr.w - im.w * wi.w);
        *reinterpret_cast<float4*>(yi + o) = make_float4(re.x * wi.x + im.x * wr.x, re.y * wi.y + im.y * wr.y,
                                                         re.z * wi.z + im.z * wr.z, re.w * wi.w + im.w * wr.w);
      }
    }
  }
};

// Launches the kernel of Form and WGS on `grid` persistent blocks (a
// multiple of the ceil(groups / WGS) row blocks) over the first `ncols`
// columns of x (and xi, for a two-plane form).  The shared-memory attribute
// is set once per device and instantiation, so a launch captured into a
// CUDA graph makes no such call.  Returns the refusal or cudaGetLastError().
template <class Form, int WGS, bool STREAM = false, class Epi>
int launch_dot_bf16(const float* x, const float* xi, const unsigned char* fimg, int img_parts, Epi epi, int batch,
                    int n1, int n2, int ncols, int groups, int grid, cudaStream_t s) {
  constexpr int MAX_DEVICES = 64;
  static int smem_set[MAX_DEVICES];
  const int row_blocks = (groups + WGS - 1) / WGS;
  if (batch < 1 || groups < 1 || ncols < 1 || ncols > n2 || grid < row_blocks || grid % row_blocks ||
      img_parts < Form::PARTS || (Form::PLANES == 2 && xi == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = dot_smem_bytes<Form>(WGS, n1, STREAM);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    // Refuses more than the card's opt-in limit less the static barrier.
    e = cudaFuncSetAttribute(stage_a_dot_wgmma_kernel<Form, WGS, STREAM, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // leave no error behind for the next launch to report
      return (int)e;
    }
    smem_set[dev] = smem;
  }
  stage_a_dot_wgmma_kernel<Form, WGS, STREAM, Epi><<<grid, 128 * WGS * Form::NS, smem, s>>>(
      x, xi, fimg, img_parts, epi, batch, n1, n2, ncols, groups, grid / row_blocks);
  return (int)cudaGetLastError();
}

}  // namespace dot_bf16
}  // namespace gft

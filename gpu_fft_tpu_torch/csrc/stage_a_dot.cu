// The stage-A dot in three precisions (S3).
//
// Replaces the Pallas kernel of scripts/ablate_mosaic_x6.py:build (bodies
// kern_f32, kern_x6, kern_x1): Yr = Fr x and Yi = Fi x for a constant
// (n1, n1) pair (Fr, Fi) against x (B, n1, n2), in
//   f32_highest  fp32 FMA on the CUDA cores;
//   bf16_x6      the 6-term bf16 ladder of _x6: F arrives split on the host
//                into three bf16 parts (split3_bf16), x is split in the
//                kernel with __float2bfloat16_rn (round to nearest even, as
//                astype does), and the products
//                  a1b1 + (a1b2 + a2b1) + (a1b3 + a2b2 + a3b1)
//                run on the tensor cores with fp32 accumulators, one
//                accumulator per parenthesised group, summed in that order;
//   bf16_x1      one bf16 product of the rounded operands.
// Both kernels read the LHS stacked, [Fr; Fi] as one (2 n1, n1) operand:
// stacked rows below n1 go to Yr, the rest to Yi.
//
// What bounds it on an H100, at n1 = 128, n2 = 8192: f32 does 537 MFLOP ->
// 8.0 us at 67 TFLOP/s (compute); bf16_x6 does 3.2 GFLOP -> 3.3 us at
// 989 TFLOP/s but moves 12.7 MB (x read, Yr and Yi written) -> 3.8 us at
// 3.35 TB/s, so memory is the wall, as it is for bf16_x1 (3.8 us).
//
// f32: dense_f32.cuh (64 x 64 block tiles, 8 x 8 outputs a thread, a
// cp.async ring over the depth) on the pre-transposed stacked table, its
// epilogue splitting the stacked rows into Yr and Yi.
//
// bf16: wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate), both
// operands read from shared memory in the K-major 128-byte-swizzled layout.
// - A block owns RB = 64 * WGS stacked rows (one consumer warpgroup per 64)
//   and keeps their F parts resident in shared memory for its whole run.
//   The host lays the parts out as the shared memory holds them
//   (dot_tables "f_img"), so they arrive by a few bulk (TMA) copies that
//   one thread issues, counted by an mbarrier, under the first x loads.
//   Blocks are persistent and walk their share of the 64-column tiles of
//   x, so F is read from L2 once per block and x once per row block (once
//   in all where RB covers all 2 n1 rows).  The launch rule
//   (kernels/ablation.py:dot_geometry) takes the largest RB whose block
//   fits the shared memory: 256 for x1 and 128 for x6 at n1 = 128.
// - x enters in 64-deep chunks (one swizzle atom): each thread loads 8
//   depths of one column, splits them into their bf16 parts in registers
//   and stores each part's 8 values as one 16-byte word of the column's
//   row, so the stores are free of bank conflicts and the parts are split
//   once per block.  Two chunk buffers: chunk i + 1 is stored while the
//   warpgroups' wgmmas on chunk i run, and chunk i + 2's global loads are
//   in flight meanwhile.
// - x6 keeps three accumulator sets (one per ladder group) and sums them in
//   the ladder's order at the end of a tile.
// - A tile's results leave through a padded staging tile in shared memory
//   as coalesced 16-byte stores.
#include <cuda_bf16.h>

#include <cstdint>

#include "dense_f32.cuh"

namespace {

// ── f32 ─────────────────────────────────────────────────────────────────────

// Stacked rows [Fr; Fi] of the product -> Yr, Yi.
struct SplitRows {
  float* yr;
  float* yi;
  int n1, n2;
  __device__ __forceinline__ void store(int b, int m, int n, float4 v) const {
    float* y = m < n1 ? yr : yi;
    const int r = m < n1 ? m : m - n1;
    *reinterpret_cast<float4*>(y + ((size_t)b * n1 + r) * n2 + n) = v;
  }
};

// ── bf16 on wgmma ────────────────────────────────────────────────────────────

constexpr int BN = 64;   // x columns per tile (the wgmma N)
constexpr int KA = 64;   // depth of a 128-byte swizzle atom (bf16)
constexpr int ROW = 128; // bytes of an atom row
constexpr int SLD = BN + 8;  // padded row of the staging tile (floats)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// A bulk (TMA) copy of `bytes` from global `src` to shared `dst`; the
// barrier at `bar` counts the bytes as they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Bytes of dynamic shared memory: the resident F parts, two x chunk
// buffers, the staging tile, and the slack that aligns the base to 1,024.
constexpr int dot_smem_bytes(int parts, int wgs, int n1) {
  return parts * ((n1 + KA - 1) / KA) * 64 * wgs * ROW + 2 * parts * BN * ROW +
         64 * wgs * SLD * 4 + 1024;
}

// fimg: the F parts as the blocks hold them (ablation.py:dot_tables
// "f_img"): per 64 stacked rows g, per part p, per 64-deep chunk c, the
// 64 x 128-byte swizzled rows, 8 KB, so a block's parts of one group are
// one run of bytes (x1 reads part 0 of each group).  grid: row_blocks *
// per_rb persistent blocks; block i owns row block i / per_rb and the
// column tiles i % per_rb + j * per_rb.
template <int PARTS, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
stage_a_dot_wgmma_kernel(const float* __restrict__ x, const unsigned char* __restrict__ fimg,
                         float* __restrict__ yr, float* __restrict__ yi, int batch, int n1, int n2,
                         int per_rb) {
  constexpr int RB = 64 * WGS;
  constexpr int THREADS = 128 * WGS;
  constexpr int G = PARTS == 3 ? 3 : 1;      // accumulator groups
  constexpr int UNITS = 8 * BN / THREADS;    // (8 depths x 1 column) loads a thread, per chunk
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t fbar;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kchunks = (n1 + KA - 1) / KA;
  unsigned char* fs = base;                                  // [group][part][chunk][row][128 B]
  unsigned char* xs = fs + PARTS * kchunks * RB * ROW;        // [stage][part][column][128 B]
  float* stg = reinterpret_cast<float*>(xs + 2 * PARTS * BN * ROW);  // [row][SLD]

  const int t = threadIdx.x;
  const int wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  const int rb = blockIdx.x / per_rb;
  const int first = blockIdx.x % per_rb;
  const int col_tiles = n2 / BN;
  const int tiles = batch * col_tiles;
  const int my_tiles = first < tiles ? (tiles - first + per_rb - 1) / per_rb : 0;
  const int iters = my_tiles * kchunks;

  // The block's F rows, every part, resident: one bulk copy per (row
  // group, part) run of the image, issued by one thread, counted by fbar.
  const uint32_t bar = smem_u32(&fbar);
  const uint32_t run = kchunks * KA * ROW;  // bytes of one (group, part)
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(WGS * PARTS * run)
                 : "memory");
    for (int i = 0; i < WGS * PARTS; ++i) {
      const int g = rb * WGS + i / PARTS, p = i % PARTS;
      bulk_load(smem_u32(fs) + i * run, fimg + (size_t)(g * 3 + p) * run, run, bar);
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it

  // x chunk `it` of this block: unit u = t + i * THREADS is column u % BN,
  // depths 8 * (u / BN) .. + 7 of the chunk.
  float v[UNITS][8];
  auto load = [&](int it) {
    const int tile = first + (it / kchunks) * per_rb;
    const int kc = it % kchunks;
    const int b = tile / col_tiles, c0 = (tile % col_tiles) * BN;
    const int kv = min(KA, n1 - kc * KA);
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = t + i * THREADS;
      const int n = u % BN, g = u / BN;
      if (g * 8 < kv) {
        const float* src = x + ((size_t)b * n1 + kc * KA + g * 8) * n2 + c0 + n;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = __ldg(src + (size_t)j * n2);
      }
    }
  };
  auto store = [&](int it, int stage) {
    const int kv = min(KA, n1 - (it % kchunks) * KA);
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = t + i * THREADS;
      const int n = u % BN, g = u / BN;
      if (g * 8 < kv) {
        uint32_t w[PARTS][4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          __nv_bfloat16 h[PARTS][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xv = v[i][j + e];
            h[0][e] = __float2bfloat16_rn(xv);
            if constexpr (PARTS == 3) {
              const float r1 = xv - __bfloat162float(h[0][e]);
              h[1][e] = __float2bfloat16_rn(r1);
              h[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(h[1][e]));
            }
          }
#pragma unroll
          for (int p = 0; p < PARTS; ++p) w[p][j / 2] = pack2(h[p][0], h[p][1]);
        }
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          unsigned char* dst = xs + ((stage * PARTS + p) * BN + n) * ROW + ((g ^ (n % 8)) * 16);
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
        }
      }
    }
  };

  float acc[G][32];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;

  if (iters > 0) {
    load(0);
    store(0, 0);
    if (iters > 1) load(1);
  }
  wait_phase0(bar);
  fence_async_smem();
  __syncthreads();

  const uint32_t fs_a = smem_u32(fs), xs_a = smem_u32(xs);
  for (int it = 0; it < iters; ++it) {
    const int stage = it & 1;
    const int kc = it % kchunks;
    const int ksteps = min(KA, n1 - kc * KA) / 16;
#pragma unroll
    for (int q = 0; q < G; ++q) pin(acc[q]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KA / 16; ++s) {
      if (s < ksteps) {
        uint64_t da[PARTS], db[PARTS];
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          da[p] = desc_sw128(fs_a + ((wg * PARTS + p) * kchunks + kc) * (KA * ROW) + s * 32);
          db[p] = desc_sw128(xs_a + ((stage * PARTS + p) * BN) * ROW + s * 32);
        }
        wgmma_m64n64k16(acc[0], da[0], db[0]);      // a1 b1
        if constexpr (PARTS == 3) {
          wgmma_m64n64k16(acc[1], da[0], db[1]);    // a1 b2
          wgmma_m64n64k16(acc[1], da[1], db[0]);    // a2 b1
          wgmma_m64n64k16(acc[2], da[0], db[2]);    // a1 b3
          wgmma_m64n64k16(acc[2], da[1], db[1]);    // a2 b2
          wgmma_m64n64k16(acc[2], da[2], db[0]);    // a3 b1
        }
      }
    }
    wgmma_commit();
    if (it + 1 < iters) store(it + 1, stage ^ 1);
    if (it + 2 < iters) load(it + 2);
    wgmma_wait_all();
#pragma unroll
    for (int q = 0; q < G; ++q) pin(acc[q]);

    if (kc == kchunks - 1) {
      // Fragment -> staging: value 4j + e sits at row 16 warp + lane / 4
      // (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + e % 2.
      const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = acc[0][4 * j + e];
          if constexpr (G == 3) o[e] = (o[e] + acc[1][4 * j + e]) + acc[2][4 * j + e];
        }
        const int c = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(stg + r0 * SLD + c) = make_float2(o[0], o[1]);
        *reinterpret_cast<float2*>(stg + (r0 + 8) * SLD + c) = make_float2(o[2], o[3]);
      }
      __syncthreads();
      const int tile = first + (it / kchunks) * per_rb;
      const int b = tile / col_tiles, c0 = (tile % col_tiles) * BN;
#pragma unroll
      for (int i = 0; i < RB * BN / 4 / THREADS; ++i) {
        const int q = t + i * THREADS;
        const int r = q / (BN / 4), c4 = (q % (BN / 4)) * 4;
        const int m = rb * RB + r;
        float* y = m < n1 ? yr : yi;
        const int row = m < n1 ? m : m - n1;
        *reinterpret_cast<float4*>(y + ((size_t)b * n1 + row) * n2 + c0 + c4) =
            *reinterpret_cast<const float4*>(stg + r * SLD + c4);
      }
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
    }
    fence_async_smem();
    __syncthreads();
  }
}

// The shared-memory attribute is set once per device and instantiation, so
// a launch captured into a CUDA graph makes no such call.
constexpr int MAX_DEVICES = 64;
static int g_smem_set[MAX_DEVICES][5];

template <int PARTS, int WGS>
int launch_wgmma(const float* x, const unsigned char* fimg, float* yr, float* yi, int batch, int n1,
                 int n2, int grid, cudaStream_t s, int slot) {
  constexpr int RB = 64 * WGS;
  const int row_blocks = 2 * n1 / RB;
  if ((2 * n1) % RB || grid < row_blocks || grid % row_blocks) return (int)cudaErrorInvalidValue;
  const int smem = dot_smem_bytes(PARTS, WGS, n1);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > g_smem_set[dev][slot]) {
    // Refuses more than the card's opt-in limit less the static barrier.
    e = cudaFuncSetAttribute(stage_a_dot_wgmma_kernel<PARTS, WGS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // leave no error behind for the next launch to report
      return (int)e;
    }
    g_smem_set[dev][slot] = smem;
  }
  stage_a_dot_wgmma_kernel<PARTS, WGS><<<grid, 128 * WGS, smem, s>>>(x, fimg, yr, yi, batch, n1, n2,
                                                                     grid / row_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// at: the (n1, 2 n1) stacked table [Fr; Fi] transposed.
extern "C" int gft_stage_a_dot_f32(const float* x, const float* at, float* yr, float* yi,
                                   int batch, int n1, int n2, void* stream) {
  return gft::launch_dense_f32(x, at, SplitRows{yr, yi, n1, n2}, batch, 2 * n1, n1, n2, stream);
}

// fimg: the swizzled image of the stacked bf16 parts (dot_tables "f_img");
// wgs consumer warpgroups a block (64 stacked rows each), grid persistent
// blocks (dot_geometry).
extern "C" int gft_stage_a_dot_bf16(const float* x, const void* fimg, float* yr, float* yi, int batch,
                                    int n1, int n2, int parts, int wgs, int grid, void* stream) {
  if (batch < 1 || n1 < 32 || n1 % 32 || n2 < BN || n2 % BN || grid < 1)
    return (int)cudaErrorInvalidValue;
  const auto* f = static_cast<const unsigned char*>(fimg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts == 1 && wgs == 1) return launch_wgmma<1, 1>(x, f, yr, yi, batch, n1, n2, grid, s, 0);
  if (parts == 1 && wgs == 2) return launch_wgmma<1, 2>(x, f, yr, yi, batch, n1, n2, grid, s, 1);
  if (parts == 1 && wgs == 4) return launch_wgmma<1, 4>(x, f, yr, yi, batch, n1, n2, grid, s, 2);
  if (parts == 3 && wgs == 1) return launch_wgmma<3, 1>(x, f, yr, yi, batch, n1, n2, grid, s, 3);
  if (parts == 3 && wgs == 2) return launch_wgmma<3, 2>(x, f, yr, yi, batch, n1, n2, grid, s, 4);
  return (int)cudaErrorInvalidValue;
}

// The matched filter's own passes (ops/matched.py: matched_filter_device),
// on either side of its batched complex inverse:
//
//   correlate_kernel  q[t, k] = conj(h[t, k]) s[k] / S[k] for kmin <= k < N/2,
//                     0 at every other k < N, split-complex (T, N); and the
//                     template norm's partial sums sum |h[t, k]|^2 / S[k],
//                     one a block, (T, blocks);
//   snr_kernel        rho[t, i] = y[t, start + i] * N 4 df / sqrt(sigma^2[t])
//                     over the window [start, stop), split-complex (T, L),
//                     sigma^2 = 4 df * the sum of the partials; and the largest
//                     |rho|^2 of each block with its first index;
//   peak_kernel       the row's largest |rho| and its first index (+ start),
//                     from the blocks' candidates.
//
// They replace no Pallas kernel: the JAX package has no matched filter.
// They replace the ~25 ATen passes of the torch version
// (kernels/matched.py: matched_correlate_plain, matched_snr_plain), whose
// arithmetic they repeat one rounding at a time (__fmul_rn, __fmaf_rn: the
// products and fused multiply-adds ATen's kernels give on the card); only the
// order of the norm's sum differs.
//
// What bounds them on an H100: the bytes.  At (T, N) = (64, 2^20) the
// correlation reads the templates' band once (263 MB) and writes the (T, N)
// buffer once, zeros included (537 MB); the SNR reads the inverse over the
// window and writes rho (369 + 369 MB): 1.54 GB, 0.46 ms at 3.35 TB/s,
// against a few FLOP a byte.  So each pass touches each byte once:
//
//   * a correlation block takes a tile of 1,024 bins and 16 templates, loads
//     s~ / S for its tile once and runs down its templates, so the data's
//     6 MB come from device memory once a 16-template chunk; the tile's
//     sigma^2 terms are summed in the warp and added, per warp, into shared
//     memory, and the block writes one partial a template: a fixed order, no
//     float atomics, the same sum on every run.  Tiles are dealt to the
//     blocks in turn, so that the zero-only tiles (below kmin, above N/2)
//     spread over all of them.  A template row may start at any 4-byte
//     boundary (in a (T + 2, 2, h) tensor with h odd every other row is 8
//     bytes off a 16-byte one), so each 4-bin load is as wide as its address
//     allows; every store is a 16-byte one.
//   * an SNR block sums its row's partials (a few hundred floats, from L2),
//     then streams a contiguous stretch of the row: 16-byte loads and stores
//     where the window and the rows are 16-byte aligned, 4-byte ones
//     elsewhere.  Each thread keeps the first of its largest |rho|^2 in index
//     order; the block reduces them (ties to the lower index, NaN above every
//     number, as torch.max) and writes one candidate.  peak_kernel reduces a
//     row's candidates in one warp.
//
// The wrapper (kernels/matched.py: matched_geometry) picks the blocks; each
// entry point checks its arguments and launches on the caller's stream.  A
// refused launch is returned as an error; nothing falls back.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace gft {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS * 4;             // bins a correlation block takes at a time, 4 a thread
constexpr int CHUNK = 16;                     // templates a correlation block runs down
constexpr int SEG = THREADS * 4;              // window elements an SNR block takes a pass

__device__ __forceinline__ float warp_sum(float v) {
  // A butterfly: every lane ends with the same sum, in the same order on every run.
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether (v, i) goes before (bv, bi) as torch.max orders them: the larger
// value, NaN above every number, ties to the lower index.
__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (wins(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// row[k0 .. k0 + 3], zero outside [lo, hi): one 16-byte load, two 8-byte or
// four 4-byte ones, as the address allows (uniform over a warp: k0 is a
// multiple of 4).
__device__ __forceinline__ float4 load_band(const float* __restrict__ row, int k0, int lo, int hi) {
  const float* p = row + k0;
  if (k0 >= lo && k0 + 4 <= hi) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
    if ((a & 7) == 0) {
      const float2 u = __ldg(reinterpret_cast<const float2*>(p));
      const float2 v = __ldg(reinterpret_cast<const float2*>(p + 2));
      return make_float4(u.x, u.y, v.x, v.y);
    }
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (k0 + j >= lo && k0 + j < hi) ? __ldg(p + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(float* __restrict__ row, int k0, int n, const float (&v)[4]) {
  if (k0 + 4 <= n) {
    *reinterpret_cast<float4*>(row + k0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + j < n) row[k0 + j] = v[j];
  }
}

// Block b: template chunk b / tile_blocks, tiles b % tile_blocks,
// + tile_blocks, ...  hr / hi: row t at hr + t * ldr (unit stride along k).
__global__ void __launch_bounds__(THREADS)
correlate_kernel(const float* __restrict__ hr, const float* __restrict__ hi, long long ldr, long long ldi,
                 const float* __restrict__ sr, const float* __restrict__ si, const float* __restrict__ psd,
                 float* __restrict__ qr, float* __restrict__ qi, float* __restrict__ parts, int t_count,
                 int n, int kmin, int tile_blocks) {
  __shared__ float acc[CHUNK][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = (int)(blockIdx.x % (unsigned)tile_blocks);
  const int t0 = (int)(blockIdx.x / (unsigned)tile_blocks) * CHUNK;
  const int tn = min(CHUNK, t_count - t0);
  const int half = n >> 1;
  if (lane == 0)
    for (int c = 0; c < CHUNK; ++c) acc[c][warp] = 0.f;  // each warp owns its column
  const int tiles = (n + TILE - 1) / TILE;
  for (int tile = bx; tile < tiles; tile += tile_blocks) {
    const int base = tile * TILE, k0 = base + tid * 4;
    if (base >= half || base + TILE <= kmin) {  // no bin of the band: zeros only
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 < n)
        for (int c = 0; c < tn; ++c) {
          const size_t row = (size_t)(t0 + c) * n;
          store4(qr + row, k0, n, z);
          store4(qi + row, k0, n, z);
        }
      continue;
    }
    // s~ / S of this thread's bins, once for the chunk's templates; 0 off the band.
    float ar[4], ai[4], w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      const bool in = k >= kmin && k < half;
      w[j] = in ? __fdiv_rn(1.f, __ldg(psd + k)) : 0.f;
      ar[j] = in ? __fmul_rn(__ldg(sr + k), w[j]) : 0.f;
      ai[j] = in ? __fmul_rn(__ldg(si + k), w[j]) : 0.f;
    }
    for (int c = 0; c < tn; ++c) {
      const size_t t = (size_t)(t0 + c);
      const float4 xr = load_band(hr + (long long)t * ldr, k0, kmin, half);
      const float4 xi = load_band(hi + (long long)t * ldi, k0, kmin, half);
      const float a[4] = {xr.x, xr.y, xr.z, xr.w};
      const float b[4] = {xi.x, xi.y, xi.z, xi.w};
      float vr[4], vi[4], s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vr[j] = __fmaf_rn(b[j], ai[j], __fmul_rn(a[j], ar[j]));   // Re conj(h) s / S
        vi[j] = __fmaf_rn(-b[j], ar[j], __fmul_rn(a[j], ai[j]));  // Im
        s += __fmul_rn(__fmaf_rn(b[j], b[j], __fmul_rn(a[j], a[j])), w[j]);
      }
      if (k0 < n) {
        store4(qr + t * n, k0, n, vr);
        store4(qi + t * n, k0, n, vi);
      }
      s = warp_sum(s);
      if (lane == 0) acc[c][warp] += s;
    }
  }
  __syncthreads();
  if (tid < tn) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) s += acc[tid][v];
    parts[(size_t)(t0 + tid) * tile_blocks + bx] = s;
  }
}

// Block b: row t = b / blocks, window elements [r seg, (r + 1) seg) of it,
// r = b % blocks.  VEC: 16-byte accesses (n, start, len and seg multiples
// of 4, y 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
snr_kernel(const float* __restrict__ yr, const float* __restrict__ yi, const float* __restrict__ parts,
           int nparts, float* __restrict__ outr, float* __restrict__ outi, float* __restrict__ best_v,
           int* __restrict__ best_i, int n, int start, int len, int seg, int blocks, float c_sigma,
           float c_norm) {
  __shared__ float s_norm;
  __shared__ float s_v[WARPS];
  __shared__ int s_i[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = (int)(blockIdx.x / (unsigned)blocks), r = (int)(blockIdx.x % (unsigned)blocks);
  if (warp == 0) {
    const float* p = parts + (size_t)t * nparts;
    float s = 0.f;
    for (int j = lane; j < nparts; j += 32) s += __ldg(p + j);
    s = warp_sum(s);
    // norm = N 4 df / sqrt(4 df sum), rounded as torch's float ops round it.
    if (lane == 0) s_norm = __fmul_rn(c_norm, __fdiv_rn(1.f, __fsqrt_rn(__fmul_rn(c_sigma, s))));
  }
  __syncthreads();
  const float norm = s_norm;
  const float* yrr = yr + (size_t)t * n + start;
  const float* yir = yi + (size_t)t * n + start;
  float* orr = outr + (size_t)t * len;
  float* oir = outi + (size_t)t * len;
  const int i0 = r * seg, i1 = min(i0 + seg, len);
  float bv = -1.f;  // below every |rho|^2
  int bi = INT_MAX;
  if (VEC) {
#pragma unroll 4
    for (int i = i0 + 4 * tid; i < i1; i += 4 * THREADS) {
      const float4 a = ldg4(yrr + i);
      const float4 b = ldg4(yir + i);
      const float4 u = make_float4(__fmul_rn(a.x, norm), __fmul_rn(a.y, norm), __fmul_rn(a.z, norm),
                                   __fmul_rn(a.w, norm));
      const float4 v = make_float4(__fmul_rn(b.x, norm), __fmul_rn(b.y, norm), __fmul_rn(b.z, norm),
                                   __fmul_rn(b.w, norm));
      *reinterpret_cast<float4*>(orr + i) = u;
      *reinterpret_cast<float4*>(oir + i) = v;
      const float m[4] = {__fmaf_rn(v.x, v.x, __fmul_rn(u.x, u.x)), __fmaf_rn(v.y, v.y, __fmul_rn(u.y, u.y)),
                          __fmaf_rn(v.z, v.z, __fmul_rn(u.z, u.z)), __fmaf_rn(v.w, v.w, __fmul_rn(u.w, u.w))};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (wins(m[j], i + j, bv, bi)) {
          bv = m[j];
          bi = i + j;
        }
    }
  } else {
#pragma unroll 4
    for (int i = i0 + tid; i < i1; i += THREADS) {
      const float u = __fmul_rn(__ldg(yrr + i), norm), v = __fmul_rn(__ldg(yir + i), norm);
      orr[i] = u;
      oir[i] = v;
      const float m = __fmaf_rn(v, v, __fmul_rn(u, u));
      if (wins(m, i, bv, bi)) {
        bv = m;
        bi = i;
      }
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    s_v[warp] = bv;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    bv = s_v[0];
    bi = s_i[0];
    for (int v = 1; v < WARPS; ++v)
      if (wins(s_v[v], s_i[v], bv, bi)) {
        bv = s_v[v];
        bi = s_i[v];
      }
    best_v[blockIdx.x] = bv;
    best_i[blockIdx.x] = bi;
  }
}

// Warp w of block b: row t = b * WARPS + w, over its `blocks` candidates.
__global__ void __launch_bounds__(THREADS)
peak_kernel(const float* __restrict__ best_v, const int* __restrict__ best_i, int blocks, int t_count,
            int start, float* __restrict__ peak, long long* __restrict__ index) {
  const int lane = threadIdx.x & 31;
  const int t = (int)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= t_count) return;
  float bv = -1.f;
  int bi = INT_MAX;
  for (int j = lane; j < blocks; j += 32) {
    const float v = best_v[(size_t)t * blocks + j];
    const int i = best_i[(size_t)t * blocks + j];
    if (wins(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    peak[t] = __fsqrt_rn(bv);
    index[t] = (long long)bi + start;
  }
}

constexpr bool pow2(long long v) { return v > 0 && !(v & (v - 1)); }

}  // namespace
}  // namespace gft

// hr / hi: (t_count, >= n/2 + 1) rows ldr / ldi floats apart, unit stride;
// sr / si / psd: (n/2 + 1,); qr / qi: (t_count, n); parts: (t_count,
// tile_blocks).  n a power of two >= 2, 0 <= kmin < n/2, 1 <= tile_blocks
// <= ceil(n / 1,024).  Returns the launch's error, then cudaGetLastError().
extern "C" int gft_matched_correlate(const float* hr, const float* hi, long long ldr, long long ldi,
                                     const float* sr, const float* si, const float* psd, float* qr,
                                     float* qi, float* parts, int t_count, int n, int kmin, int tile_blocks,
                                     void* stream) {
  using namespace gft;
  const long long tiles = ((long long)n + TILE - 1) / TILE;
  const long long grid = (long long)tile_blocks * (((long long)t_count + CHUNK - 1) / CHUNK);
  if (!hr || !hi || !sr || !si || !psd || !qr || !qi || !parts || t_count < 1 || !pow2(n) || n < 2 ||
      kmin < 0 || kmin >= n / 2 || tile_blocks < 1 || tile_blocks > tiles || ldr < 0 || ldi < 0 ||
      grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  correlate_kernel<<<(unsigned)grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      hr, hi, ldr, ldi, sr, si, psd, qr, qi, parts, t_count, n, kmin, tile_blocks);
  return (int)cudaGetLastError();
}

// yr / yi: (t_count, n) contiguous; parts: (t_count, nparts); outr / outi:
// (t_count, len), len = stop - start; best_v / best_i: (t_count, blocks),
// blocks = ceil(len / seg).  seg a multiple of 1,024; vec: 16-byte
// accesses, which need n, start and len multiples of 4 and yr, yi, outr,
// outi 16-byte aligned.  c_sigma = 4 df, c_norm = n 4 df.
extern "C" int gft_matched_snr(const float* yr, const float* yi, const float* parts, int nparts, float* outr,
                               float* outi, float* best_v, int* best_i, int t_count, int n, int start, int len,
                               int seg, int vec, float c_sigma, float c_norm, void* stream) {
  using namespace gft;
  const long long blocks = len > 0 && seg > 0 ? ((long long)len + seg - 1) / seg : 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; };
  if (!yr || !yi || !parts || !outr || !outi || !best_v || !best_i || t_count < 1 || nparts < 1 || n < 1 ||
      start < 0 || len < 1 || (long long)start + len > n || seg < SEG || seg % SEG ||
      blocks * t_count > 0x7fffffffLL ||
      (vec && (n % 4 || start % 4 || len % 4 || misaligned(yr) || misaligned(yi) || misaligned(outr) ||
               misaligned(outi))))
    return (int)cudaErrorInvalidValue;
  const auto kernel = vec ? snr_kernel<true> : snr_kernel<false>;
  kernel<<<(unsigned)(blocks * t_count), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      yr, yi, parts, nparts, outr, outi, best_v, best_i, n, start, len, seg, (int)blocks, c_sigma, c_norm);
  return (int)cudaGetLastError();
}

// best_v / best_i: (t_count, blocks) from gft_matched_snr; peak: (t_count,)
// the largest |rho| of each row, index: (t_count,) int64, its first index
// plus start.
extern "C" int gft_matched_peak(const float* best_v, const int* best_i, int blocks, int t_count, int start,
                                float* peak, long long* index, void* stream) {
  using namespace gft;
  if (!best_v || !best_i || !peak || !index || blocks < 1 || t_count < 1 || start < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((t_count + WARPS - 1) / WARPS);
  peak_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(best_v, best_i, blocks, t_count, start,
                                                                       peak, index);
  return (int)cudaGetLastError();
}

// Whole-transform kernel: one length-n FFT per row in ONE launch.
//
// Replaces the Pallas kernels gpu_fft_tpu/kernels/fused.py:whole_transform
// (K1: separate tables) and whole_transform_packed (K2: every table in one
// (4*n1 + 256, 128) buffer).  One templated kernel serves both; the Layout
// parameter only says where each table lives.
//
// Math (n = n1 * 128, x viewed as (n1, 128) = [a, c]):
//   P[k1, c] = sum_a F1[k1, a] x[a, c]          stage 1, column DFT
//   Z[k1, c] = P[k1, c] * TW[k1, c]             twiddle
//   Y[j, k1] = sum_c F2[j, c] Z[k1, c]          stage 2, row DFT (scale in F2)
// and Y flattened as j * n1 + k1 is the spectrum in natural order.
//
// What bounds it on an H100: the TPU kernel runs a row's whole four-step in
// one grid step with the (n1, 128) intermediate Z in VMEM.  Done the same way
// here (one block per row, Z in shared memory) a B = 1 transform used one SM
// of 132 and took 0.17 ms at n = 16384, 4.8x its cuBLAS-based plain version.
// Each k1 row of Z depends only on the F1 row k1 and all of x, and each output
// column k1 of Y only on Z row k1, so this kernel splits the k1 digit across
// blocks: a block owns RB rows k1, computes them through both stages, and
// needs nothing from any other block.  Z stays in (static) shared memory at
// any n1.  When the batch gives too few blocks to fill the card (B = 1, the
// band this kernel serves) the output rows j are split H = 4 ways as well,
// each such block recomputing its RB rows of stage 1 (RB * n1 * 128 MACs) to
// cut its share of stage 2 (128 * RB * 128 MACs) by H: a B = 1 transform then
// spreads over n1 SMs.  The redundant traffic is each block reading x and F2
// from L2.  x and the tables are read through the read-only cache with
// 16-byte loads; Z rows are padded to 132 floats so stage 2's float4 reads
// are bank-conflict free.  fp32 FMA on CUDA cores, schoolbook complex
// products, no TF32 and no tensor cores.
#include "common.cuh"

namespace {

constexpr int N2 = 128;       // row length of the (n1, 128) view
constexpr int ZLD = N2 + 4;   // padded shared-memory row stride of Z
constexpr int RB = 4;         // k1 rows per block
constexpr int THREADS = 128;  // stage 1: one column c per thread

// K1: separate (n1, n1) F1 and (128, 128) F2 tables.
struct SplitLayout {
  const float *f1r, *f1i, *twr, *twi, *f2r, *f2i;
  __device__ const float* F1r(int) const { return f1r; }
  __device__ const float* F1i(int) const { return f1i; }
  __device__ const float* TWr(int) const { return twr; }
  __device__ const float* TWi(int) const { return twi; }
  __device__ const float* F2r(int) const { return f2r; }
  __device__ const float* F2i(int) const { return f2i; }
  __device__ static int ld1(int n1) { return n1; }
};

// K2: one (4*n1 + 256, 128) buffer, rows [F1r; F1i; TWr; TWi; F2r; F2i]
// (gpu_fft_tpu/plan.py:get_whole_packed_plan).
struct PackedLayout {
  const float* t;
  __device__ const float* F1r(int) const { return t; }
  __device__ const float* F1i(int n1) const { return t + (size_t)n1 * N2; }
  __device__ const float* TWr(int n1) const { return t + (size_t)2 * n1 * N2; }
  __device__ const float* TWi(int n1) const { return t + (size_t)3 * n1 * N2; }
  __device__ const float* F2r(int n1) const { return t + (size_t)4 * n1 * N2; }
  __device__ const float* F2i(int n1) const { return t + (size_t)(4 * n1 + N2) * N2; }
  __device__ static int ld1(int) { return N2; }
};

// Block (h, g, b): rows k1 in [g*RB, (g+1)*RB) and output rows j in
// [h*128/H, (h+1)*128/H) of transform b.
template <class Layout, bool COMPLEX, int H>
__global__ void __launch_bounds__(THREADS)
whole_kernel(const float* __restrict__ xr, const float* __restrict__ xi, Layout tab,
             float* __restrict__ yr, float* __restrict__ yi, int n1) {
  constexpr int R = RB;                 // stage-1 rows per thread
  constexpr int R2 = RB * N2 / H / THREADS;  // stage-2 outputs per thread
  __shared__ __align__(16) float zr[RB * ZLD];
  __shared__ __align__(16) float zi[RB * ZLD];
  const int t = threadIdx.x;
  const int groups = n1 / RB;
  const int h = blockIdx.x % H;
  const int k1_0 = (blockIdx.x / H % groups) * RB;
  const size_t base = (size_t)(blockIdx.x / H / groups) * n1 * N2;

  // Stage 1 + twiddle: thread owns column c and the block's RB rows.
  {
    const int c = t;
    const float* f1r = tab.F1r(n1) + (size_t)k1_0 * Layout::ld1(n1);
    const float* f1i = tab.F1i(n1) + (size_t)k1_0 * Layout::ld1(n1);
    const int ld1 = Layout::ld1(n1);
    const float* xrb = xr + base + c;
    const float* xib = COMPLEX ? xi + base + c : nullptr;
    float pr[R], pi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pr[r] = pi[r] = 0.f;
    for (int a = 0; a < n1; a += 4) {
      float vr[4], vi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vr[q] = __ldg(xrb + (size_t)(a + q) * N2);
        vi[q] = COMPLEX ? __ldg(xib + (size_t)(a + q) * N2) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 fr = gft::ldg4(f1r + (size_t)r * ld1 + a);
        const float4 fi = gft::ldg4(f1i + (size_t)r * ld1 + a);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a_r = gft::f4(fr, q), a_i = gft::f4(fi, q);
          pr[r] = fmaf(a_r, vr[q], pr[r]);
          pi[r] = fmaf(a_i, vr[q], pi[r]);
          if constexpr (COMPLEX) {
            pr[r] = fmaf(-a_i, vi[q], pr[r]);
            pi[r] = fmaf(a_r, vi[q], pi[r]);
          }
        }
      }
    }
    const float* twr = tab.TWr(n1);
    const float* twi = tab.TWi(n1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float wr = __ldg(twr + (size_t)(k1_0 + r) * N2 + c);
      const float wi = __ldg(twi + (size_t)(k1_0 + r) * N2 + c);
      zr[r * ZLD + c] = pr[r] * wr - pi[r] * wi;
      zi[r * ZLD + c] = pr[r] * wi + pi[r] * wr;
    }
  }
  __syncthreads();

  // Stage 2: thread owns local row k and R2 consecutive output rows j.
  {
    const int k = t % RB;
    const int j0 = h * (N2 / H) + (t / RB) * R2;
    const float* f2r = tab.F2r(n1);
    const float* f2i = tab.F2i(n1);
    float sr[R2], si[R2];
#pragma unroll
    for (int r = 0; r < R2; ++r) sr[r] = si[r] = 0.f;
    for (int c = 0; c < N2; c += 4) {
      const float4 z_r = gft::lds4(zr + k * ZLD + c);
      const float4 z_i = gft::lds4(zi + k * ZLD + c);
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const float4 fr = gft::ldg4(f2r + (size_t)(j0 + r) * N2 + c);
        const float4 fi = gft::ldg4(f2i + (size_t)(j0 + r) * N2 + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a_r = gft::f4(fr, q), a_i = gft::f4(fi, q);
          const float b_r = gft::f4(z_r, q), b_i = gft::f4(z_i, q);
          sr[r] = fmaf(a_r, b_r, sr[r]);
          sr[r] = fmaf(-a_i, b_i, sr[r]);
          si[r] = fmaf(a_r, b_i, si[r]);
          si[r] = fmaf(a_i, b_r, si[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      const size_t o = base + (size_t)(j0 + r) * n1 + k1_0 + k;
      yr[o] = sr[r];
      yi[o] = si[r];
    }
  }
}

template <class Layout, int H>
int launch_h(const float* xr, const float* xi, const Layout& tab, float* yr, float* yi,
             long long blocks, int n1, cudaStream_t s) {
  blocks *= H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (xi)
    whole_kernel<Layout, true, H><<<(unsigned)blocks, THREADS, 0, s>>>(xr, xi, tab, yr, yi, n1);
  else
    whole_kernel<Layout, false, H><<<(unsigned)blocks, THREADS, 0, s>>>(xr, xi, tab, yr, yi, n1);
  return (int)cudaGetLastError();
}

template <class Layout>
int launch(const float* xr, const float* xi, const Layout& tab, float* yr, float* yi, int batch,
           int n1, void* stream) {
  if (batch < 1 || n1 < RB || n1 % RB || n1 % 4) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)(n1 / RB) * batch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Split stage 2 four ways only where the (k1, batch) blocks alone leave
  // most SMs idle; a full grid gains nothing from recomputing stage 1.
  if (blocks < 64) return launch_h<Layout, 4>(xr, xi, tab, yr, yi, blocks, n1, s);
  return launch_h<Layout, 1>(xr, xi, tab, yr, yi, blocks, n1, s);
}

}  // namespace

extern "C" int gft_whole_split(const float* xr, const float* xi, const float* f1r, const float* f1i,
                               const float* twr, const float* twi, const float* f2r,
                               const float* f2i, float* yr, float* yi, int batch, int n1,
                               void* stream) {
  SplitLayout tab{f1r, f1i, twr, twi, f2r, f2i};
  return launch(xr, xi, tab, yr, yi, batch, n1, stream);
}

extern "C" int gft_whole_packed(const float* xr, const float* xi, const float* packed, float* yr,
                                float* yi, int batch, int n1, void* stream) {
  PackedLayout tab{packed};
  return launch(xr, xi, tab, yr, yi, batch, n1, stream);
}

extern "C" const char* gft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

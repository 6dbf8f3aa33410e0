// Left-matmul fused four-step for real input (S1), one launch per batch.
//
// Replaces the Pallas kernel scripts/ablate_engines.py:fused_fft_pallas_lm
// (body `_lm_real_kernel`, tables `lm_tables`).  x (B, n) real with
// n = n1 * n2 from balanced_split (n1 <= n2), each row viewed (n1, n2) = [a, c]:
//   P[k1, c] = sum_a F1[k1, a] x[a, c]         stage 1, the left matmul
//   Z[k1, c] = P[k1, c] * TW[k1, c]            twiddle, (n1, n2) = [k1, c]
//   R[k1, j] = sum_c Z[k1, c] F2[c, j]         stage 2 in the Karatsuba form
//     s1 = (zr + zi) . f2r, s2 = zr . f2d, s3 = zi . f2s; re = s1 - s3, im = s1 + s2
// and R is stored transposed, Y[j, k1] = R[k1, j]: the spectrum in natural
// order (k = k1 + n1 * j).
//
// What bounds it on an H100: fp32 FMA on the CUDA cores.  B * (4 n n1 + 6 n
// + 6 n n2) FLOP: at (16, 65536) 2.69 GFLOP, 40 us at 67 TFLOP/s, against
// 12.6 MB (x, the tables, the output) that take 3.8 us at 3.35 TB/s.
//
// Design: the TPU kernel's batch tile was a VMEM budget and has no meaning
// here.  This is K1's decomposition (csrc/whole_transform.cu): each k1 row of
// Z needs only the F1 row k1 and all of x, and each output column k1 of Y
// only Z row k1, so a block owns RB = 16 rows k1 of one transform, runs both
// stages for them and needs no other block.  Both stages are register-tiled
// products: a thread keeps a 4-row tile (rows r0 .. r0 + 3) of P, then of
// the three Karatsuba products, so each value it loads of x or F2 feeds four
// FMAs instead of one.  The 64 threads of a row group take
// neighbouring columns, so x and F2 rows are read coalesced; F1 rows are read
// as float4 along a, the same address across a warp.  Z is kept in shared
// memory transposed, [c][k1], so stage 2 reads its four rows at one c as one
// float4, and the 4 k1 of a tile leave as one float4 of Y.  n2 (64, 128 or
// 256) is a template parameter.  Where the (k1, batch) blocks alone leave
// most SMs idle (B = 1) the output columns j are split H = n2 / 64 ways as
// well, each such block recomputing stage 1 for its rows, as K1 does.
#include "common.cuh"

namespace {

constexpr int RB = 16;                     // k1 rows per block
constexpr int TR = 4;                      // rows per thread tile
constexpr int THREADS = 256;
constexpr int COLS = THREADS / (RB / TR);  // threads per row group: 64
constexpr int ZLD = RB + 4;                // padded row of the transposed Z

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 f = gft::ldg4(p + q);
      v[q] = f.x; v[q + 1] = f.y; v[q + 2] = f.z; v[q + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x; v[1] = f.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = __ldg(p + q);
  }
}

// Block (h, g, b): rows k1 in [g*RB, (g+1)*RB) and output columns j in
// [h*N2/H, (h+1)*N2/H) of transform b.
template <int N2, int H>
__global__ void __launch_bounds__(THREADS)
fused_lm_kernel(const float* __restrict__ x, const float* __restrict__ f1r,
                const float* __restrict__ f1i, const float* __restrict__ twr,
                const float* __restrict__ twi, const float* __restrict__ f2r,
                const float* __restrict__ f2s, const float* __restrict__ f2d,
                float* __restrict__ yr, float* __restrict__ yi, int n1) {
  constexpr int NJ = N2 / H;     // output columns of this block
  constexpr int TC = N2 / COLS;  // stage-1 columns per thread: 1, 2, 4
  constexpr int TC2 = NJ / COLS; // stage-2 columns per thread
  static_assert(TC * COLS == N2 && TC2 * COLS == NJ && TC2 >= 1, "n2 / H must be a multiple of 64");
  __shared__ __align__(16) float zr[N2 * ZLD];  // Z transposed: [c][k1 - k1_0]
  __shared__ __align__(16) float zi[N2 * ZLD];

  const int t = threadIdx.x;
  const int r0 = (t / COLS) * TR;  // the thread's rows k1_0 + r0 .. + TR - 1
  const int cg = t % COLS;
  const int groups = n1 / RB;
  const int h = blockIdx.x % H;
  const int k1_0 = (blockIdx.x / H % groups) * RB;
  const size_t base = (size_t)(blockIdx.x / H / groups) * n1 * N2;

  // Stage 1 + twiddle: P[r0 .. r0 + TR, c0 .. c0 + TC).
  {
    const int c0 = cg * TC;
    const float* a_r = f1r + (size_t)(k1_0 + r0) * n1;
    const float* a_i = f1i + (size_t)(k1_0 + r0) * n1;
    const float* xb = x + base + c0;
    float pr[TR][TC], pi[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int q = 0; q < TC; ++q) pr[i][q] = pi[i][q] = 0.f;
    for (int a = 0; a < n1; a += 4) {
      float4 fr[TR], fi[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        fr[i] = gft::ldg4(a_r + (size_t)i * n1 + a);
        fi[i] = gft::ldg4(a_i + (size_t)i * n1 + a);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[TC];
        load_row<TC>(xb + (size_t)(a + u) * N2, v);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float wr = gft::f4(fr[i], u), wi = gft::f4(fi[i], u);
#pragma unroll
          for (int q = 0; q < TC; ++q) {
            pr[i][q] = fmaf(wr, v[q], pr[i][q]);
            pi[i][q] = fmaf(wi, v[q], pi[i][q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TC; ++q) {
      const int c = c0 + q;
      float o_r[TR], o_i[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const size_t w = (size_t)(k1_0 + r0 + i) * N2 + c;
        const float wr = __ldg(twr + w), wi = __ldg(twi + w);
        o_r[i] = pr[i][q] * wr - pi[i][q] * wi;
        o_i[i] = pr[i][q] * wi + pi[i][q] * wr;
      }
      *reinterpret_cast<float4*>(zr + c * ZLD + r0) = make_float4(o_r[0], o_r[1], o_r[2], o_r[3]);
      *reinterpret_cast<float4*>(zi + c * ZLD + r0) = make_float4(o_i[0], o_i[1], o_i[2], o_i[3]);
    }
  }
  __syncthreads();

  // Stage 2: the three products over [r0 .. r0 + TR) x [j0 .. j0 + TC2).
  const int j0 = h * NJ + cg * TC2;
  float s1[TR][TC2], s2[TR][TC2], s3[TR][TC2];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int q = 0; q < TC2; ++q) s1[i][q] = s2[i][q] = s3[i][q] = 0.f;
#pragma unroll 4
  for (int c = 0; c < N2; ++c) {
    const float4 z_r = gft::lds4(zr + c * ZLD + r0);
    const float4 z_i = gft::lds4(zi + c * ZLD + r0);
    float vr[TC2], vd[TC2], vs[TC2];
    const size_t row = (size_t)c * N2 + j0;
    load_row<TC2>(f2r + row, vr);
    load_row<TC2>(f2d + row, vd);
    load_row<TC2>(f2s + row, vs);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float ar = gft::f4(z_r, i), ai = gft::f4(z_i, i);
      const float as = ar + ai;
#pragma unroll
      for (int q = 0; q < TC2; ++q) {
        s1[i][q] = fmaf(as, vr[q], s1[i][q]);
        s2[i][q] = fmaf(ar, vd[q], s2[i][q]);
        s3[i][q] = fmaf(ai, vs[q], s3[i][q]);
      }
    }
  }

  // Y[j, k1_0 + r0 .. + TR): 4 consecutive k1, one float4 per column j.
#pragma unroll
  for (int q = 0; q < TC2; ++q) {
    const size_t o = base + (size_t)(j0 + q) * n1 + k1_0 + r0;
    *reinterpret_cast<float4*>(yr + o) = make_float4(s1[0][q] - s3[0][q], s1[1][q] - s3[1][q],
                                                     s1[2][q] - s3[2][q], s1[3][q] - s3[3][q]);
    *reinterpret_cast<float4*>(yi + o) = make_float4(s1[0][q] + s2[0][q], s1[1][q] + s2[1][q],
                                                     s1[2][q] + s2[2][q], s1[3][q] + s2[3][q]);
  }
}

struct Args {
  const float *x, *f1r, *f1i, *twr, *twi, *f2r, *f2s, *f2d;
  float *yr, *yi;
};

template <int N2, int H>
int launch_h(const Args& a, long long blocks, int n1, cudaStream_t s) {
  blocks *= H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_lm_kernel<N2, H><<<(unsigned)blocks, THREADS, 0, s>>>(
      a.x, a.f1r, a.f1i, a.twr, a.twi, a.f2r, a.f2s, a.f2d, a.yr, a.yi, n1);
  return (int)cudaGetLastError();
}

template <int N2>
int launch(const Args& a, int batch, int n1, cudaStream_t s) {
  const long long blocks = (long long)(n1 / RB) * batch;
  // Split the columns j (64 per block) only where the (k1, batch) blocks
  // alone leave most SMs idle; a full grid gains nothing from recomputing
  // stage 1.
  if (blocks < 64) return launch_h<N2, N2 / COLS>(a, blocks, n1, s);
  return launch_h<N2, 1>(a, blocks, n1, s);
}

}  // namespace

extern "C" int gft_fused_lm(const float* x, const float* f1r, const float* f1i, const float* twr,
                            const float* twi, const float* f2r, const float* f2s,
                            const float* f2d, float* yr, float* yi, int batch, int n1, int n2,
                            void* stream) {
  if (batch < 1 || n1 < RB || n1 % RB || n1 > n2) return (int)cudaErrorInvalidValue;
  const Args a{x, f1r, f1i, twr, twi, f2r, f2s, f2d, yr, yi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n2) {
    case 64: return launch<64>(a, batch, n1, s);
    case 128: return launch<128>(a, batch, n1, s);
    case 256: return launch<256>(a, batch, n1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Batched 1-D FFT along the last axis by the four-step (Bailey)
// factorization, for Hopper (sm_90a), in FP32 FFMA.
//
// Replaces the Pallas TPU kernel repro/kernels/fft_matmul.py:
// fft4step_planes (_fft4step_kernel).  For a row of N = n1 * n2 points,
// x[j1 * n2 + j2]:
//   stage 1   Y[j2, k1] = sum_j1 x[j1, j2] W1[j1, k1]     (n1-point DFTs)
//   stage 2   Y[j2, k1] *= T[j2, k1]                       (twiddles)
//   stage 3   Z[k2, k1] = sum_j2 W2[k2, j2] Y[j2, k1]      (n2-point DFTs)
//   output    out[k1 + n1 * k2] = Z[k2, k1]
// i.e. out viewed as (n2, n1) is W2 @ ((x^T W1) * T): two small complex
// products per row.  n2 == 1 (N <= 64) is the single product x @ W1.
//
// The TPU kernel splits complex data into real/imag planes because Pallas
// has no complex registers; here rows are read and written as interleaved
// complex64 (float2) directly, so no plane split/merge passes exist.
//
// Bound on an H100: one pass over 2^20 rows of 1024 points reads and
// writes 17.2 GB (5.1 ms at 3.35 TB/s), against 5.4e10 flop by the
// 5 N log2 N count (0.8 ms at 67 TFLOP/s FP32): memory-bound.  The dense
// DFT stages do ~10x the FFT count of real FMAs, so this FFMA kernel is
// compute-bound in practice (~8 ms at peak FP32); a tensor-core (3xTF32
// wgmma) version is the way to the memory bound.  TF32 alone would not
// hold the 3e-4 * max|ref| tolerance, so none is used.
//
// Design: a persistent grid of 256-thread blocks.  Each block loads W1,
// W2 and the twiddles into shared memory once, then walks over groups of
// G rows: the rows are staged in shared memory with coalesced loads, each
// thread computes a TM x TK register tile of the output with strided
// indices (so a warp's shared-memory reads are consecutive or broadcast),
// stage 1 writes the twiddled Y to shared memory, stage 3 writes the
// result straight to global memory in the transposed k1 + n1 * k2 order.
// Rows are padded by one complex in shared memory when several rows share
// a warp, to keep them on different banks.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <int N1, int N2>
struct Cfg {
  static constexpr int N = N1 * N2;
  static constexpr int M = N2;                      // output tile rows (k2)
  static constexpr int K = N1;                      // output tile cols (k1)
  static constexpr int TM = M < 4 ? M : 4;
  static constexpr int TK = K < 4 ? K : 4;
  static constexpr int SM = M / TM;                 // stride of a thread's m
  static constexpr int SK = K / TK;                 // stride of a thread's k
  static constexpr int TPR = SM * SK;               // threads per row
  static constexpr int G = kThreads / TPR;          // rows in flight
  static constexpr int RS = N + (G > 1 ? 1 : 0);    // smem row stride
  static constexpr int W1_SZ = N1 * N1;
  static constexpr int W2_SZ = N2 > 1 ? N2 * N2 : 0;
  static constexpr int TW_SZ = N2 > 1 ? N : 0;
  static constexpr int X_SZ = G * RS;
  static constexpr int Y_SZ = N2 > 1 ? G * RS : 0;
  static constexpr int SMEM =
      (W1_SZ + W2_SZ + TW_SZ + X_SZ + Y_SZ) * (int)sizeof(float2);
  static_assert(TPR <= kThreads, "tile too small for the row");
};

template <int N1, int N2>
__global__ void __launch_bounds__(kThreads)
fft4step_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                const float2* __restrict__ w1, const float2* __restrict__ w2,
                const float2* __restrict__ tw, long long rows) {
  using C = Cfg<N1, N2>;
  extern __shared__ float2 smem[];
  float2* sW1 = smem;
  float2* sW2 = sW1 + C::W1_SZ;
  float2* sTW = sW2 + C::W2_SZ;
  float2* sX = sTW + C::TW_SZ;
  float2* sY = sX + C::X_SZ;

  for (int i = threadIdx.x; i < C::W1_SZ; i += kThreads) sW1[i] = w1[i];
  for (int i = threadIdx.x; i < C::W2_SZ; i += kThreads) sW2[i] = w2[i];
  for (int i = threadIdx.x; i < C::TW_SZ; i += kThreads) sTW[i] = tw[i];
  // the first __syncthreads of the loop orders these stores

  const int g = threadIdx.x / C::TPR;   // row slot of this thread
  const int t = threadIdx.x % C::TPR;
  const int tm = t / C::SK;
  const int tk = t % C::SK;
  const float2* xr = sX + g * C::RS;
  float2* yr = sY + g * C::RS;

  const long long groups = (rows + C::G - 1) / C::G;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long row0 = grp * C::G;
    const int nrows = (int)min((long long)C::G, rows - row0);
    const float2* src = x + row0 * C::N;
    for (int i = threadIdx.x; i < nrows * C::N; i += kThreads)
      sX[(i / C::N) * C::RS + i % C::N] = src[i];
    __syncthreads();
    const bool active = g < nrows;
    float2* out = y + (row0 + g) * C::N;

    float2 acc[C::TM][C::TK];
#pragma unroll
    for (int s = 0; s < C::TM; ++s)
#pragma unroll
      for (int u = 0; u < C::TK; ++u) acc[s][u] = make_float2(0.f, 0.f);
    if (active) {
#pragma unroll 4
      for (int r = 0; r < N1; ++r) {
        float2 a[C::TM], b[C::TK];
#pragma unroll
        for (int s = 0; s < C::TM; ++s) a[s] = xr[r * C::M + tm + s * C::SM];
#pragma unroll
        for (int u = 0; u < C::TK; ++u) b[u] = sW1[r * N1 + tk + u * C::SK];
#pragma unroll
        for (int s = 0; s < C::TM; ++s)
#pragma unroll
          for (int u = 0; u < C::TK; ++u) cmac(acc[s][u], a[s], b[u]);
      }
    }

    if (N2 == 1) {
      if (active) {
#pragma unroll
        for (int u = 0; u < C::TK; ++u) out[tk + u * C::SK] = acc[0][u];
      }
      __syncthreads();  // sX is reloaded by the next group
      continue;
    }

    if (active) {
#pragma unroll
      for (int s = 0; s < C::TM; ++s)
#pragma unroll
        for (int u = 0; u < C::TK; ++u) {
          const int m = tm + s * C::SM, k = tk + u * C::SK;
          yr[m * N1 + k] = cmul(acc[s][u], sTW[m * N1 + k]);
        }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int s = 0; s < C::TM; ++s)
#pragma unroll
        for (int u = 0; u < C::TK; ++u) acc[s][u] = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int r = 0; r < N2; ++r) {
        float2 a[C::TM], b[C::TK];
        // W2 is symmetric: W2[k2, r] == W2[r, k2]
#pragma unroll
        for (int s = 0; s < C::TM; ++s) a[s] = sW2[r * N2 + tm + s * C::SM];
#pragma unroll
        for (int u = 0; u < C::TK; ++u) b[u] = yr[r * N1 + tk + u * C::SK];
#pragma unroll
        for (int s = 0; s < C::TM; ++s)
#pragma unroll
          for (int u = 0; u < C::TK; ++u) cmac(acc[s][u], a[s], b[u]);
      }
#pragma unroll
      for (int s = 0; s < C::TM; ++s)
#pragma unroll
        for (int u = 0; u < C::TK; ++u)
          out[(tm + s * C::SM) * N1 + tk + u * C::SK] = acc[s][u];
    }
    // no barrier needed here: the next group's sX load is ordered after
    // every thread's stage 1 by the barrier above, and its stage 1 writes
    // to sY only after the next loop-top barrier
  }
}

template <int N1, int N2>
int launch(const float2* x, float2* y, const float2* w1, const float2* w2,
           const float2* tw, long long rows, cudaStream_t stream) {
  using C = Cfg<N1, N2>;
  static int grid_cap = 0;  // resident blocks on the device, per size
  if (grid_cap == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        fft4step_kernel<N1, N2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fft4step_kernel<N1, N2>, kThreads, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long groups = (rows + C::G - 1) / C::G;
  const int grid = (int)(groups < grid_cap ? groups : grid_cap);
  fft4step_kernel<N1, N2><<<grid, kThreads, C::SMEM, stream>>>(
      x, y, w1, w2, tw, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fft4step_launch(const void* x, void* y, const void* w1,
                               const void* w2, const void* tw,
                               long long rows, int n1, int n2,
                               void* stream) {
  if (rows <= 0) return 0;
  const float2* xi = static_cast<const float2*>(x);
  float2* yo = static_cast<float2*>(y);
  const float2* a = static_cast<const float2*>(w1);
  const float2* b = static_cast<const float2*>(w2);
  const float2* c = static_cast<const float2*>(tw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FFT4_CASE(P, Q) \
  if (n1 == P && n2 == Q) return launch<P, Q>(xi, yo, a, b, c, rows, s);
  FFT4_CASE(1, 1) FFT4_CASE(2, 1) FFT4_CASE(4, 1) FFT4_CASE(8, 1)
  FFT4_CASE(16, 1) FFT4_CASE(32, 1) FFT4_CASE(64, 1)
  FFT4_CASE(16, 8) FFT4_CASE(16, 16) FFT4_CASE(32, 16) FFT4_CASE(32, 32)
  FFT4_CASE(64, 32) FFT4_CASE(64, 64)
#undef FFT4_CASE
  return (int)cudaErrorInvalidValue;
}

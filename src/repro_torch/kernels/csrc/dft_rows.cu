// The contiguous axis of the matmul local FFT in one pass over the field,
// for Hopper (sm_90a): both dense DFT products of the four-step split and
// the twiddle between them, in FP32 FFMA.
//
// Replaces no Pallas TPU kernel: the reference leaves these products to
// XLA (repro/core/local_fft.py: fft_matmul).  On the card the same three
// steps took three passes over the field (two cuBLAS cgemm, one twiddle
// multiply); this kernel reads each row once and writes it once.  For a
// row of N = n1 * n2 points, x[j1 * n2 + j2] (the plan's split, n1 <= 64,
// n2 <= n1):
//   stage 1   Y[k1, j2] = sum_j1 F1[k1, j1] X[j1, j2]     (dense product)
//             Y[k1, j2] *= T[k1, j2]                      (twiddle)
//   stage 2   Z[k2, k1] = sum_j2 F2[k2, j2] Y[k1, j2]     (dense product)
//   output    out[k1 + n1 * k2] = Z[k2, k1]
// with the plan's own tables: F1 = w1 (n1, n1), F2 = w2 (n2, n2) and the
// twiddles transposed, T = tw^T (n1, n2), all complex64 and carrying the
// transform's sign.  Every output is a sum of dense products in float32
// (no TF32, no radix-2 butterflies): the same terms as the cuBLAS path,
// summed in another order.
//
// Layout.  The input is (rows, N) with a row stride of at least N and
// unit stride along the row (a K-chunk's rows are read where they lie);
// the output is contiguous (rows, N).
//
// Bound on an H100: operations.  A product of radix r does r complex
// multiply-adds (8 flop) an output, so 2^20 rows of 1024 = 32 x 32 points
// take 2 * 2^30 * 32 * 8 = 5.5e11 flop, 8.2 ms at 67 TFLOP/s FP32,
// against 17.2 GB of bytes, 5.1 ms at 3.35 TB/s.  So the kernel is built
// to keep the FP32 pipe issuing FFMA.
//
// Design.  Each F entry a thread loads from shared memory has to feed as
// many FFMA as its registers allow: the loads, not the FFMA, held a first
// version (one row a thread, 16 FFMA per two 16-byte loads) to 63 % of
// the bound.  So a group of 2 n1 threads runs two rows at once, and
// thread (c, s) sums half s of every sum for both rows: each F entry it
// loads feeds both rows, with the registers of one row's column.  The
// two halves meet in one shuffle (partner lane ^ 16): the thread keeps
// its own row's half sum, adds the partner's half sum of the same row,
// and finishes row s.  A block holds 256 / (2 n1) groups, which walk the
// rows with a block-wide stride.  The tables live in shared memory,
// padded so that the 16-byte broadcast loads of the two halves fall in
// distinct banks.
//   stage 1: thread (c, s), column j2 = c % n2, holds X[j1][j2] of both
//            rows for j1 in half s (loaded straight from device memory,
//            neighbouring threads on neighbouring points), sums its n2
//            outputs k1 (half c / n2 of them when n1 = 2 n2) in blocks of
//            KB = 4, multiplies each by T[k1, j2] and writes Y[k1][j2] to
//            its row's shared tile;
//   stage 2: thread (k1 = c, s) reads Y[k1][j2] of both rows for j2 in
//            half s (16-byte loads), sums its n2 outputs k2 in blocks of
//            KB and writes out[k1 + n1 k2] of its row, neighbouring
//            threads on neighbouring points.
// A group synchronises twice a row pair: after stage 1's writes, and after
// stage 2's reads of Y, so the next rows may overwrite the tiles.  A group
// of one warp (n1 = 16) takes __syncwarp, a larger one a named barrier of
// its own.  Padding: a Y row holds n2 + 2 points, so the 16-byte loads of
// eight neighbouring threads fall in distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr int KB = 4;          // outputs a thread sums at once
constexpr int THREADS = 256;

template <int N1, int N2>
struct Cfg {
  static constexpr int N = N1 * N2;
  static constexpr int GT = 2 * N1;          // threads of a group: two rows
  static constexpr int G = THREADS / GT;     // groups a block
  static constexpr int ROWS = 2 * G;         // rows a block holds at once
  static constexpr int KP = N1 / N2;         // stage-1 threads a column
  static constexpr int H1 = N1 / 2;          // a thread's share of a sum
  static constexpr int H2 = N2 / 2;
  static constexpr int P = N2 + 2;           // padded Y row (complex)
  static constexpr int SY = N1 * P;          // a row's Y tile
  static constexpr int B = N2 + 2;           // padded block of F entries
  static constexpr int PF1 = 2 * KP * B;     // F1^T row: blocks (s, half)
  static constexpr int PF2 = 2 * B;          // F2^T row: blocks s
  static constexpr int SMEM =
      (ROWS * SY + H1 * PF1 + H2 * PF2) * (int)sizeof(float2);
  static_assert(KP == 1 || KP == 2, "the plan's split has n2 <= n1 <= 2 n2");
  static_assert(N2 % KB == 0 && N2 >= 8 && N1 <= 64,
                "a split of 8 to 64 points");
  static_assert(THREADS % GT == 0 && THREADS / GT <= 15,
                "whole groups, each with a named barrier");
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc += (fr + i fi) v, four FFMA
__device__ __forceinline__ void cmac(float2& acc, float fr, float fi,
                                     float2 v) {
  acc.x = fmaf(fr, v.x, acc.x);
  acc.x = fmaf(-fi, v.y, acc.x);
  acc.y = fmaf(fr, v.y, acc.y);
  acc.y = fmaf(fi, v.x, acc.y);
}

// KB consecutive F entries at a 16-byte-aligned shared address, two a
// load; the threads of a half-warp read alike (a broadcast)
struct FRow {
  float4 f[KB / 2];
  __device__ __forceinline__ explicit FRow(const float2* p) {
#pragma unroll
    for (int i = 0; i < KB / 2; ++i)
      f[i] = *reinterpret_cast<const float4*>(p + 2 * i);
  }
  // acc[q] += F[q] v
  __device__ __forceinline__ void mac(float2 (&acc)[KB], float2 v) const {
#pragma unroll
    for (int i = 0; i < KB / 2; ++i) {
      cmac(acc[2 * i], f[i].x, f[i].y, v);
      cmac(acc[2 * i + 1], f[i].z, f[i].w, v);
    }
  }
};

// The whole of this thread's output: its own row's half sum plus the
// partner's (lane ^ 16) half sum of the same row, which the partner holds
// as its other row's.
__device__ __forceinline__ float2 own_sum(float2 own, float2 other) {
  return make_float2(own.x + __shfl_xor_sync(0xffffffffu, other.x, 16),
                     own.y + __shfl_xor_sync(0xffffffffu, other.y, 16));
}

// A group is one warp (n1 = 16) or a named barrier of its own warps.
template <int GT>
__device__ __forceinline__ void group_sync(int g) {
  if constexpr (GT == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(GT) : "memory");
  }
}

template <int N1, int N2>
__global__ void __launch_bounds__(THREADS)
dft_rows_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                const float2* __restrict__ w1, const float2* __restrict__ w2,
                const float2* __restrict__ tw_t, long long rows,
                long long stride) {
  using C = Cfg<N1, N2>;
  constexpr int H1 = C::H1, H2 = C::H2;
  extern __shared__ float4 smem[];
  float2* sY = reinterpret_cast<float2*>(smem);
  float2* sF1 = sY + C::ROWS * C::SY;  // F1^T: [j1 % h1][s][half][k1 % n2]
  float2* sF2 = sF1 + H1 * C::PF1;     // F2^T: [j2 % h2][s][k2]

  for (int i = threadIdx.x; i < N1 * N1; i += THREADS) {
    const int k1 = i / N1, j1 = i % N1;
    sF1[(j1 % H1) * C::PF1 + ((j1 / H1) * C::KP + k1 / N2) * C::B +
        k1 % N2] = w1[i];
  }
  for (int i = threadIdx.x; i < N2 * N2; i += THREADS) {
    const int k2 = i / N2, j2 = i % N2;
    sF2[(j2 % H2) * C::PF2 + (j2 / H2) * C::B + k2] = w2[i];
  }
  __syncthreads();

  // A group of 2 n1 threads runs two rows; thread (c, s), s = lane bit 4,
  // sums half s of every sum for both rows and finishes row s with its
  // partner (c, 1 - s).
  const int g = threadIdx.x / C::GT;
  const int t = threadIdx.x % C::GT;
  const int s = (t >> 4) & 1;
  const int c = (t & 15) | ((t >> 5) << 4);   // 0 .. n1 - 1
  float2* own_y = sY + (2 * g + s) * C::SY;
  const float2* other_y = sY + (2 * g + 1 - s) * C::SY;
  // stage 1: column j2, outputs k1 in [k0, k0 + n2), j1 in half s
  const int j2 = c % N2, half = c / N2, k0 = half * N2;
  const float2* f1 = sF1 + (s * C::KP + half) * C::B;
  // stage 2: row k1 of Y, j2 in half s
  const int k1 = c;
  const float2* f2 = sF2 + s * C::B;

  const long long step = (long long)gridDim.x * C::ROWS;
  for (long long r0 = (long long)blockIdx.x * C::ROWS; r0 < rows;
       r0 += step) {
    const long long own = r0 + 2 * g + s, other = r0 + 2 * g + 1 - s;
    const bool own_live = own < rows, other_live = other < rows;

    float2 a[2][H1];  // X[s h1 + jj][j2] of the own and the other row
    {
      const float2* xo = x + (own_live ? own : 0LL) * stride + s * H1 * N2 + j2;
      const float2* xt =
          x + (other_live ? other : 0LL) * stride + s * H1 * N2 + j2;
#pragma unroll
      for (int jj = 0; jj < H1; ++jj) {
        a[0][jj] = own_live ? __ldg(xo + jj * N2) : make_float2(0.f, 0.f);
        a[1][jj] = other_live ? __ldg(xt + jj * N2) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll 1
    for (int kb = 0; kb < N2; kb += KB) {
      float2 acc[2][KB];
#pragma unroll
      for (int q = 0; q < KB; ++q)
        acc[0][q] = acc[1][q] = make_float2(0.f, 0.f);
#pragma unroll
      for (int jj = 0; jj < H1; ++jj) {
        const FRow f(f1 + jj * C::PF1 + kb);
        f.mac(acc[0], a[0][jj]);
        f.mac(acc[1], a[1][jj]);
      }
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        const int k = k0 + kb + q;
        own_y[k * C::P + j2] = cmul(own_sum(acc[0][q], acc[1][q]),
                                    __ldg(tw_t + k * N2 + j2));
      }
    }
    group_sync<C::GT>(g);

    float2 b[2][H2];  // Y[k1][s h2 + jj] of the own and the other row
#pragma unroll
    for (int jj = 0; jj < H2; jj += 2) {
      const float4 u =
          *reinterpret_cast<const float4*>(own_y + k1 * C::P + s * H2 + jj);
      const float4 v =
          *reinterpret_cast<const float4*>(other_y + k1 * C::P + s * H2 + jj);
      b[0][jj] = make_float2(u.x, u.y);
      b[0][jj + 1] = make_float2(u.z, u.w);
      b[1][jj] = make_float2(v.x, v.y);
      b[1][jj + 1] = make_float2(v.z, v.w);
    }
    group_sync<C::GT>(g);

    float2* o = out + (own_live ? own : 0LL) * C::N + k1;
#pragma unroll 1
    for (int kb = 0; kb < N2; kb += KB) {
      float2 acc[2][KB];
#pragma unroll
      for (int q = 0; q < KB; ++q)
        acc[0][q] = acc[1][q] = make_float2(0.f, 0.f);
#pragma unroll
      for (int jj = 0; jj < H2; ++jj) {
        const FRow f(f2 + jj * C::PF2 + kb);
        f.mac(acc[0], b[0][jj]);
        f.mac(acc[1], b[1][jj]);
      }
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        const float2 z = own_sum(acc[0][q], acc[1][q]);
        if (own_live) o[(kb + q) * N1] = z;
      }
    }
  }
}

template <int N1, int N2>
int launch(const float2* x, float2* out, const float2* w1, const float2* w2,
           const float2* tw_t, long long rows, long long stride,
           cudaStream_t stream) {
  using C = Cfg<N1, N2>;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        dft_rows_kernel<N1, N2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dft_rows_kernel<N1, N2>, THREADS, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // every block resident at once; each walks its rows with the grid's stride
  long long blocks = (rows + C::ROWS - 1) / C::ROWS;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  dft_rows_kernel<N1, N2><<<(unsigned)blocks, THREADS, C::SMEM, stream>>>(
      x, out, w1, w2, tw_t, rows, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, n1 * n2) complex64 rows, `stride` points apart (>= n1 * n2);
// out: contiguous (rows, n1 * n2); w1 (n1, n1), w2 (n2, n2) and tw_t
// (n1, n2) the plan's contiguous complex64 tables.  Returns the launch's
// cudaGetLastError(); an unsupported split is cudaErrorInvalidValue.
extern "C" int dft_rows_launch(const void* x, void* out, const void* w1,
                               const void* w2, const void* tw_t,
                               long long rows, long long stride, int n1,
                               int n2, void* stream) {
  if (rows <= 0) return 0;
  if (stride < (long long)n1 * n2) return (int)cudaErrorInvalidValue;
  const float2* xi = static_cast<const float2*>(x);
  float2* o = static_cast<float2*>(out);
  const float2* f1 = static_cast<const float2*>(w1);
  const float2* f2 = static_cast<const float2*>(w2);
  const float2* t = static_cast<const float2*>(tw_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DFT_ROWS_CASE(P, Q) \
  if (n1 == P && n2 == Q) return launch<P, Q>(xi, o, f1, f2, t, rows, stride, s);
  DFT_ROWS_CASE(16, 8) DFT_ROWS_CASE(16, 16) DFT_ROWS_CASE(32, 16)
  DFT_ROWS_CASE(32, 32) DFT_ROWS_CASE(64, 32) DFT_ROWS_CASE(64, 64)
#undef DFT_ROWS_CASE
  return (int)cudaErrorInvalidValue;
}

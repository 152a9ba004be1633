// Batched 1-D FFT along any axis by the four-step (Bailey) factorization,
// for Hopper (sm_90a): in-register radix-2 sub-FFTs, the transform axis
// read and written in place.
//
// Replaces the Pallas TPU kernel repro/kernels/fft_matmul.py:
// fft4step_planes (_fft4step_kernel).  For a transform of N = n1 * n2
// points, x[j1 * n2 + j2]:
//   stage 1   Y[j2, k1] = sum_j1 x[j1, j2] w_n1^(j1 k1)     (n1-point FFTs)
//   stage 2   Y[j2, k1] *= T[j2, k1] = w_N^(j2 k1)         (twiddles)
//   stage 3   Z[k2, k1] = sum_j2 w_n2^(j2 k2) Y[j2, k1]    (n2-point FFTs)
//   output    out[k1 + n1 * k2] = Z[k2, k1]
// with w_n = exp(sign 2 pi i / n), the plan's split (n1 <= 64, n2 <= n1)
// and its twiddle table T (plan.tw, complex64), passed transposed as
// (n1, n2) so that the threads of a warp, which differ in j2, read
// neighbouring entries.  n2 == 1 (N <= 64) is one
// n1-point FFT.  The TPU kernel does both sub-DFTs as dense products on
// the matrix unit and splits complex data into real/imag planes; here
// complex64 is read and written interleaved, as float2.
//
// Layout.  The input is a contiguous (outer, N, inner) view: the
// transform axis with everything before it collapsed into outer and
// everything after it into inner; the output has the same layout.  So
// any axis of a contiguous tensor is transformed where it lies, with no
// axis-moving copy before or after.  Transform m (of outer * inner)
// starts at (m / inner) * N * inner + m % inner and its points lie
// inner apart.
//
// Bound on an H100: memory.  One pass over 2^20 transforms of 1024
// points reads and writes 17.2 GB (5.1 ms at 3.35 TB/s), against 5.4e10
// flop by the 5 N log2 N count (0.8 ms at 67 TFLOP/s FP32).  Each sub-FFT
// is a radix-2 decimation-in-frequency FFT held in one thread's registers
// (a 32-point FFT is 64 floats), so the arithmetic is that count and the
// kernel has only the bytes to move.
//
// Design.  One block per tile of TI transforms: TI = threads / n1 (n1 >=
// n2), with 256 threads for rows (8 rows at N = 1024, 4 at 4096) and 512
// for strided transforms with n1 <= 32 (16 columns at N = 1024), and TI =
// threads when n2 == 1.
//   stage 1: thread (t, j2) loads x[t][j1 n2 + j2] for every j1 straight
//            from device memory into registers, runs the n1-point FFT,
//            multiplies by T[j2, k1] and writes Y[t][j2][k1] to shared
//            memory;
//   stage 3: thread (t, k1) reads Y[t][.][k1], runs the n2-point FFT and
//            writes out[t][k1 + n1 k2] straight to device memory.
// Coalescing: with inner == 1 (ROWS) neighbouring threads take
// neighbouring j2 (stage 1) or k1 (stage 3), so a warp reads and writes
// runs of consecutive points; with inner > 1 neighbouring threads take
// neighbouring transforms t, i.e. neighbouring inner columns: TI = 16
// complex64 are 128 contiguous bytes (four full 32-byte sectors) a point.
// The shared tile is padded (a j2 row of n1 + 1 complex in ROWS; TI
// complex between j2 rows otherwise) so that both stages' accesses are
// free of bank conflicts.

#include <cuda_runtime.h>

namespace {

// cos and sin of 2 pi k / 64, k = 0..31 (float64 values rounded to float)
__constant__ float kCos[32] = {
    1.f, 0.99518472f, 0.980785251f, 0.956940353f,
    0.923879504f, 0.881921291f, 0.831469595f, 0.773010433f,
    0.707106769f, 0.634393275f, 0.555570245f, 0.471396744f,
    0.382683426f, 0.290284663f, 0.195090324f, 0.0980171412f,
    0.f, -0.0980171412f, -0.195090324f, -0.290284663f,
    -0.382683426f, -0.471396744f, -0.555570245f, -0.634393275f,
    -0.707106769f, -0.773010433f, -0.831469595f, -0.881921291f,
    -0.923879504f, -0.956940353f, -0.980785251f, -0.99518472f,
};
__constant__ float kSin[32] = {
    0.f, 0.0980171412f, 0.195090324f, 0.290284663f,
    0.382683426f, 0.471396744f, 0.555570245f, 0.634393275f,
    0.707106769f, 0.773010433f, 0.831469595f, 0.881921291f,
    0.923879504f, 0.956940353f, 0.980785251f, 0.99518472f,
    1.f, 0.99518472f, 0.980785251f, 0.956940353f,
    0.923879504f, 0.881921291f, 0.831469595f, 0.773010433f,
    0.707106769f, 0.634393275f, 0.555570245f, 0.471396744f,
    0.382683426f, 0.290284663f, 0.195090324f, 0.0980171412f,
};

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-2 decimation-in-frequency stage of span LEN over a[0..N),
// then the stages below it.  w_LEN^j = w_64^(j 64 / LEN); the indices are
// compile-time constants once the loops are unrolled, so a[] stays in
// registers and the trivial twiddles (1 and sign*i) cost no multiply.
template <int N, int LEN>
struct Dif {
  static __device__ __forceinline__ void run(float2 (&a)[N], float sgn) {
    constexpr int H = LEN / 2;
#pragma unroll
    for (int s = 0; s < N; s += LEN) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float2 u = a[s + j], v = a[s + j + H];
        a[s + j] = make_float2(u.x + v.x, u.y + v.y);
        const float dx = u.x - v.x, dy = u.y - v.y;
        const int k = j * (64 / LEN);
        if (k == 0) {
          a[s + j + H] = make_float2(dx, dy);
        } else if (k == 16) {  // w = sign * i
          a[s + j + H] = make_float2(-sgn * dy, sgn * dx);
        } else {
          const float c = kCos[k], sn = sgn * kSin[k];
          a[s + j + H] = make_float2(dx * c - dy * sn, dx * sn + dy * c);
        }
      }
    }
    Dif<N, H>::run(a, sgn);
  }
};

template <int N>
struct Dif<N, 1> {
  static __device__ __forceinline__ void run(float2 (&)[N], float) {}
};

// In-place FFT of a[0..N) in registers: natural-order input, bit-reversed
// output (a[i] = X[brev(i)]).
template <int N>
__device__ __forceinline__ void fft_regs(float2 (&a)[N], float sgn) {
  Dif<N, N>::run(a, sgn);
}

template <int N1, int N2, bool ROWS>
struct Cfg {
  static constexpr int N = N1 * N2;
  // 512 threads give the strided (inner > 1) case 16 columns, 128 bytes
  // a point; 256 keep rows at two blocks an SM and 64-point FFTs unspilled
  static constexpr int THREADS = !ROWS && N1 <= 32 ? 512 : 256;
  static constexpr int TI = N2 == 1 ? THREADS : THREADS / N1;  // n1 >= n2
  static constexpr int RS = N1 + 1;  // padded j2 row (ROWS)
  static constexpr int SMEM = N2 == 1 ? 0 : TI * N2 * RS * (int)sizeof(float2);
  static_assert(N1 >= N2, "the plan's split has n1 >= n2");
};

// index of Y[t][j2][k1] in the shared tile
template <int N1, int N2, bool ROWS>
__device__ __forceinline__ int yidx(int t, int j2, int k1) {
  using C = Cfg<N1, N2, ROWS>;
  return ROWS ? (t * N2 + j2) * C::RS + k1 : (j2 * C::RS + k1) * C::TI + t;
}

template <int N1, int N2, bool ROWS>
__global__ void __launch_bounds__(Cfg<N1, N2, ROWS>::THREADS)
fft4step_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                const float2* __restrict__ tw, long long total,
                long long inner, float sgn) {
  using C = Cfg<N1, N2, ROWS>;
  constexpr int B1 = ilog2(N1), B2 = ilog2(N2);
  extern __shared__ float2 sY[];
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * C::TI;

  // stage 1 (and the whole transform when n2 == 1)
  if (tid < C::TI * N2) {
    const int t = ROWS ? tid / N2 : tid % C::TI;
    const int j2 = ROWS ? tid % N2 : tid / C::TI;
    const long long m = m0 + t;
    const bool live = m < total;
    long long base = 0;
    if (live) {
      const long long o = ROWS ? m : m / inner;
      base = o * C::N * inner + (ROWS ? 0 : m - o * inner);
    }
    float2 a[N1];
#pragma unroll
    for (int j1 = 0; j1 < N1; ++j1)
      a[j1] = live ? __ldg(x + base + (long long)(j1 * N2 + j2) * inner)
                   : make_float2(0.f, 0.f);
    fft_regs<N1>(a, sgn);
    if constexpr (N2 == 1) {
      if (live) {
#pragma unroll
        for (int i = 0; i < N1; ++i)
          y[base + (long long)brev(i, B1) * inner] = a[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < N1; ++i) {
        const int k1 = brev(i, B1);
        sY[yidx<N1, N2, ROWS>(t, j2, k1)] =
            cmul(a[i], __ldg(tw + k1 * N2 + j2));
      }
    }
  }
  if constexpr (N2 > 1) {
    __syncthreads();
    // stage 3
    if (tid < C::TI * N1) {
      const int t = ROWS ? tid / N1 : tid % C::TI;
      const int k1 = ROWS ? tid % N1 : tid / C::TI;
      const long long m = m0 + t;
      if (m < total) {
        const long long o = ROWS ? m : m / inner;
        const long long base = o * C::N * inner + (ROWS ? 0 : m - o * inner);
        float2 b[N2];
#pragma unroll
        for (int j2 = 0; j2 < N2; ++j2)
          b[j2] = sY[yidx<N1, N2, ROWS>(t, j2, k1)];
        fft_regs<N2>(b, sgn);
#pragma unroll
        for (int i = 0; i < N2; ++i)
          y[base + (long long)(k1 + N1 * brev(i, B2)) * inner] = b[i];
      }
    }
  }
}

template <int N1, int N2, bool ROWS>
int launch(const float2* x, float2* y, const float2* tw, long long total,
           long long inner, float sgn, cudaStream_t stream) {
  using C = Cfg<N1, N2, ROWS>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        fft4step_kernel<N1, N2, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const long long blocks = (total + C::TI - 1) / C::TI;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fft4step_kernel<N1, N2, ROWS><<<(unsigned)blocks, C::THREADS, C::SMEM,
                                  stream>>>(x, y, tw, total, inner, sgn);
  return (int)cudaGetLastError();
}

template <int N1, int N2>
int launch_any(const float2* x, float2* y, const float2* tw, long long total,
               long long inner, float sgn, cudaStream_t s) {
  return inner == 1 ? launch<N1, N2, true>(x, y, tw, total, 1, sgn, s)
                    : launch<N1, N2, false>(x, y, tw, total, inner, sgn, s);
}

}  // namespace

// x, y: contiguous (outer, n1 * n2, inner) complex64; tw: the plan's
// twiddle table transposed, (n1, n2) (unread when n2 == 1); sign -1 forward, +1
// inverse (unnormalized).
extern "C" int fft4step_launch(const void* x, void* y, const void* tw,
                               long long outer, long long inner, int n1,
                               int n2, int sign, void* stream) {
  if (outer <= 0 || inner <= 0) return 0;
  if (sign != 1 && sign != -1) return (int)cudaErrorInvalidValue;
  const float2* xi = static_cast<const float2*>(x);
  float2* yo = static_cast<float2*>(y);
  const float2* t = static_cast<const float2*>(tw);
  const long long total = outer * inner;
  const float sgn = (float)sign;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FFT4_CASE(P, Q) \
  if (n1 == P && n2 == Q) return launch_any<P, Q>(xi, yo, t, total, inner, sgn, s);
  FFT4_CASE(1, 1) FFT4_CASE(2, 1) FFT4_CASE(4, 1) FFT4_CASE(8, 1)
  FFT4_CASE(16, 1) FFT4_CASE(32, 1) FFT4_CASE(64, 1)
  FFT4_CASE(16, 8) FFT4_CASE(16, 16) FFT4_CASE(32, 16) FFT4_CASE(32, 32)
  FFT4_CASE(64, 32) FFT4_CASE(64, 64)
#undef FFT4_CASE
  return (int)cudaErrorInvalidValue;
}

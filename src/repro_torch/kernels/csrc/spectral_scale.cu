// Fused k-space multiply y = (alpha x) h on interleaved complex64, for
// Hopper (sm_90a): the spectral epilogue of the forward transform.
//
// Replaces both Pallas TPU kernels of repro/kernels/spectral_scale.py,
// which share one body (_scale_kernel):
//   spectral_scale_planes      h of shape (N,), broadcast over the rows
//   spectral_scale_planes_full h of the shape of x
// One kernel template serves both: x is viewed as (rows, n) and h has a
// row stride of 0 (broadcast) or n (full shape).
//
// Bound on an H100: bytes.  x is read once, y written once and h read
// once (full) or from L1/L2 (broadcast, 8 KB at n = 1024): 12.9 GB for
// the r2c spectrum of the 1024^3 grid, 3.85 ms at 3.35 TB/s, against ~8
// flop per element.  A streaming kernel reaches that bound only with enough bytes
// in flight and few instructions per byte, so:
//   - x, y and a full h move in 16-byte vectors, two complex values each;
//     every thread issues kUnroll loads of x (and of h) before its first
//     store;
//   - each block takes one contiguous span of kThreads x kUnroll vectors,
//     and the grid covers the array once: blocks retire in address order,
//     so the card sweeps memory front to back.  On the H100 this beat a
//     persistent grid-stride loop sized by occupancy, longer spans per
//     block, a ring of TMA bulk copies through shared memory, and
//     streaming cache hints (PERF.md);
//   - a broadcast h is read through L1/L2 (__ldg): staging it in shared
//     memory once per block measured no faster (PERF.md);
//   - the two values of a vector take their columns on their own: with
//     odd n (513, the r2c spectrum) a vector spans a row boundary.  The
//     columns advance by constant steps mod n, so the loop does no division;
//   - a base that is only 8-byte aligned starts with one scalar element
//     (head), and an odd remainder ends with one (tail).  The wrapper
//     allocates y with x's alignment; a full h of the other alignment is
//     read as two 8-byte halves.
//
// Order of operations: the TPU kernel scales x by alpha before the
// product, as here.  Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn: no fused multiply-add), as the plain version in
// kernels/spectral_scale.py computes it, so the two agree to the bit.
//
// poisson_kernel is the Poisson solve's multiply: h = -1/k^2 is computed
// in the pass from three wavenumber vectors kx (X), ky (Y), kz (Z) of an
// (X, Y, Z) block, k^2 = (kx[i]^2 + ky[j]^2) + kz[l]^2 and h = 0 where
// k^2 == 0, so no tensor of x's shape holds h.  Each product, sum and the
// division is rounded on its own, in the order of the plain version's
// full-shape expression, so the two agree to the bit.  It streams as
// scale_kernel does, with no h read: 8.61 GB for the 1024^3 r2c spectrum,
// 2.57 ms at 3.35 TB/s.
// A value's (i, j, l) advances by constant steps, so the loop does no
// division; the vectors, a few KB, are read through L1/L2.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;               // 16-byte vectors in flight a thread
constexpr long long kSpan = (long long)kThreads * kUnroll;

// where h comes from
enum HMode {
  kBroadcast = 0,         // (n,), read through L1/L2
  kFullVector = 1,        // (rows, n), 16-byte vectors
  kFullPairs = 2,         // (rows, n), two 8-byte halves a vector
};

__device__ __forceinline__ float2 scale1(float2 x, float2 h, float alpha) {
  const float xr = __fmul_rn(x.x, alpha);
  const float xi = __fmul_rn(x.y, alpha);
  return make_float2(__fsub_rn(__fmul_rn(xr, h.x), __fmul_rn(xi, h.y)),
                     __fadd_rn(__fmul_rn(xr, h.y), __fmul_rn(xi, h.x)));
}

__device__ __forceinline__ float4 scale2(float4 x, float2 h0, float2 h1,
                                         float alpha) {
  const float2 a = scale1(make_float2(x.x, x.y), h0, alpha);
  const float2 b = scale1(make_float2(x.z, x.w), h1, alpha);
  return make_float4(a.x, a.y, b.x, b.y);
}

// x, y, h point at element 0; the vectors cover elements [head, head +
// 2 nvec), the tail element (if any) is head + 2 nvec
template <int kMode>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const float2* __restrict__ x, const float2* __restrict__ h,
             float2* __restrict__ y, long long head, long long nvec,
             long long total, long long n, float alpha) {
  constexpr bool kFull = kMode == kFullVector || kMode == kFullPairs;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const float4* hv = reinterpret_cast<const float4*>(h + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
  const long long v0 = (long long)blockIdx.x * kSpan + threadIdx.x;
  float4 xs[kUnroll], hs[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long v = v0 + k * kThreads;
    if (v < nvec) {
      xs[k] = xv[v];
      if constexpr (kMode == kFullVector) hs[k] = hv[v];
      if constexpr (kMode == kFullPairs) {
        const float2 a = h[head + 2 * v];
        const float2 b = h[head + 2 * v + 1];
        hs[k] = make_float4(a.x, a.y, b.x, b.y);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (head) y[0] = scale1(x[0], h[0], alpha);
    const long long t = head + 2 * nvec;
    if (t < total) y[t] = scale1(x[t], h[kFull ? t : t % n], alpha);
  }
  // broadcast: the column of the thread's first value, and its advance
  // from one of its vectors to the next (kThreads vectors on)
  long long c = kFull ? 0 : (head + 2 * v0) % n;
  const long long c_step = kFull ? 0 : (2LL * kThreads) % n;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long v = v0 + k * kThreads;
    float2 h0, h1;
    if constexpr (kFull) {
      h0 = make_float2(hs[k].x, hs[k].y);
      h1 = make_float2(hs[k].z, hs[k].w);
    } else {
      h0 = __ldg(h + c);
      h1 = __ldg(h + (c + 1 == n ? 0 : c + 1));
      c += c_step;
      if (c >= n) c -= n;
    }
    if (v < nvec) yv[v] = scale2(xs[k], h0, h1, alpha);
  }
}

// an element's (i, j, l) in an (X, Y, Z) block, i counting Y x Z planes
struct Pos {
  long long i;
  int j, l;
};

// the position of element e
__host__ __device__ __forceinline__ Pos position(long long e, int ny,
                                                 int nz) {
  const long long r = e / nz;
  return {r / ny, (int)(r % ny), (int)(e % nz)};
}

// p moved on by d (a position read as an element count)
__device__ __forceinline__ Pos advance(Pos p, Pos d, int ny, int nz) {
  p.l += d.l;
  int carry = 0;
  if (p.l >= nz) {
    p.l -= nz;
    carry = 1;
  }
  p.j += d.j + carry;
  if (p.j >= ny) {
    p.j -= ny;
    ++p.i;
  }
  p.i += d.i;
  return p;
}

// kx[i]^2 + ky[j]^2, the first sum of k^2
__device__ __forceinline__ float row_k2(const float* __restrict__ kx,
                                        const float* __restrict__ ky, Pos p) {
  const float a = __ldg(kx + p.i), b = __ldg(ky + p.j);
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// the Poisson multiplier at column l of a row whose kx^2 + ky^2 is s, as
// the expression it replaces computed it: k^2 = s + kz^2, then -(1/k^2),
// and 0 where k^2 == 0
__device__ __forceinline__ float2 poisson_h(float s,
                                            const float* __restrict__ kz,
                                            int l) {
  const float c = __ldg(kz + l);
  const float k2 = __fadd_rn(s, __fmul_rn(c, c));
  return make_float2(k2 == 0.0f ? 0.0f : -__fdiv_rn(1.0f, k2), 0.0f);
}

// x, y point at element 0 of an (X, Y, Z) block; the vectors cover
// elements [head, head + 2 nvec), the tail element (if any) is head + 2 nvec.
// step and one are 2 kThreads and 1 as positions.
__global__ void __launch_bounds__(kThreads)
poisson_kernel(const float2* __restrict__ x, const float* __restrict__ kx,
               const float* __restrict__ ky, const float* __restrict__ kz,
               float2* __restrict__ y, long long head, long long nvec,
               long long total, int ny, int nz, Pos step, Pos one,
               float alpha) {
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
  const long long v0 = (long long)blockIdx.x * kSpan + threadIdx.x;
  float4 xs[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long v = v0 + k * kThreads;
    if (v < nvec) xs[k] = xv[v];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (head) y[0] = scale1(x[0], poisson_h(row_k2(kx, ky, Pos{0, 0, 0}),
                                            kz, 0), alpha);
    const long long t = head + 2 * nvec;
    if (t < total) {
      const Pos q = position(t, ny, nz);
      y[t] = scale1(x[t], poisson_h(row_k2(kx, ky, q), kz, q.l), alpha);
    }
  }
  // the position of the thread's first value; a vector's second value lies
  // in the first's row unless it starts the next one
  Pos p = position(head + 2 * v0, ny, nz);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long v = v0 + k * kThreads;
    if (v < nvec) {
      const Pos q = advance(p, one, ny, nz);
      const float s0 = row_k2(kx, ky, p);
      const float s1 = q.l == 0 ? row_k2(kx, ky, q) : s0;
      yv[v] = scale2(xs[k], poisson_h(s0, kz, p.l), poisson_h(s1, kz, q.l),
                     alpha);
    }
    p = advance(p, step, ny, nz);
  }
}

// blocks for nvec vectors, one span a block and at least one (block 0
// writes the head and tail); 0 when the grid would be too large
long long blocks_for(long long nvec) {
  long long blocks = (nvec + kSpan - 1) / kSpan;
  if (blocks < 1) blocks = 1;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

template <int kMode>
int launch(const float2* x, const float2* h, float2* y, long long head,
           long long total, long long n, float alpha, cudaStream_t stream) {
  const long long nvec = (total - head) / 2;
  const long long blocks = blocks_for(nvec);
  if (!blocks) return (int)cudaErrorInvalidConfiguration;
  scale_kernel<kMode><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, h, y, head, nvec, total, n, alpha);
  return (int)cudaGetLastError();
}

// the scalar head of x and y (1 where both lie 8 bytes past a 16-byte
// boundary, else 0), or -1 where their alignments differ or are below 8
int head_of(const void* x, const void* y) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) % 16;
  if (reinterpret_cast<uintptr_t>(y) % 16 != xa || xa % 8 != 0) return -1;
  return xa ? 1 : 0;
}

}  // namespace

// x, y: (rows, n) complex64 with the same alignment mod 16 bytes; h: (n,)
// when h_row_stride is 0, else (rows, n) with h_row_stride == n.
extern "C" int spectral_scale_launch(const void* x, const void* h, void* y,
                                     long long rows, long long n,
                                     long long h_row_stride, float alpha,
                                     void* stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  if (h_row_stride != 0 && h_row_stride != n)
    return (int)cudaErrorInvalidValue;
  const long long head = head_of(x, y);
  if (head < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float2* hp = static_cast<const float2*>(h);
  float2* yp = static_cast<float2*>(y);
  if (h_row_stride == n) {
    if (head_of(x, h) == head)
      return launch<kFullVector>(xp, hp, yp, head, total, n, alpha, s);
    return launch<kFullPairs>(xp, hp, yp, head, total, n, alpha, s);
  }
  return launch<kBroadcast>(xp, hp, yp, head, total, n, alpha, s);
}

// x, y: (rows, ny, nz) complex64 with the same alignment mod 16 bytes;
// kx (rows), ky (ny), kz (nz) float32: y = (alpha x) h with the Poisson
// multiplier h of each element computed from them.
extern "C" int spectral_scale_poisson_launch(const void* x, const void* kx,
                                             const void* ky, const void* kz,
                                             void* y, long long rows,
                                             long long ny, long long nz,
                                             float alpha, void* stream) {
  const long long total = rows * ny * nz;
  if (total <= 0) return 0;
  if (ny > 0x7fffffffLL || nz > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long head = head_of(x, y);
  if (head < 0) return (int)cudaErrorInvalidValue;
  const long long nvec = (total - head) / 2;
  const long long blocks = blocks_for(nvec);
  if (!blocks) return (int)cudaErrorInvalidConfiguration;
  const int y32 = (int)ny, z32 = (int)nz;
  const Pos step = position(2 * kThreads, y32, z32);
  const Pos one = position(1, y32, z32);
  const float2* xp = static_cast<const float2*>(x);
  const float* kxp = static_cast<const float*>(kx);
  const float* kyp = static_cast<const float*>(ky);
  const float* kzp = static_cast<const float*>(kz);
  float2* yp = static_cast<float2*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  poisson_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      xp, kxp, kyp, kzp, yp, head, nvec, total, y32, z32, step, one, alpha);
  return (int)cudaGetLastError();
}

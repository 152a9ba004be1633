// Two-for-one Hermitian split and its exact inverse on interleaved
// complex64, for Hopper (sm_90a): the hot steps of the packed real
// transforms.
//
// Replaces the Pallas TPU kernels of repro/kernels/hermitian.py:
//   unpack_two_for_one_planes (_unpack_kernel)   -> unpack_launch
//   hermitian_extend_planes   (_extend_kernel)   -> extend_launch
//
// Unpack.  C = FFT(a + i b) of two real pencils, rows of length n (even).
// The half spectra are A[k] = (C[k] + conj C[-k]) / 2 and
// B[k] = (C[k] - conj C[-k]) / 2i for k < n/2, with the real Nyquist bin
// folded into the imaginary slot of the real DC bin.  C is viewed as
// (outer, L, n): row r = o * L + j, where L counts the rows of one half
// of the pair axis (the pair axis and everything between it and the
// transform axis).  A and B are written straight into the two halves of
// the pair-axis-concatenated output, viewed as (outer, 2, L, n/2), so the
// concatenate of the reference's dispatch is never materialized.
//
// Extend.  The exact inverse: input (outer, 2, L, n/2) folded halves,
// output (outer, L, n) with C[k] = A[k] + i B[k] and
// C[n-k] = conj(A[k] - i B[k]), and C[0], C[n/2] from bin 0's pair.
//
// Bound on an H100: bytes.  Each pass reads every input byte once and
// writes every output byte once (4.3 GB each way for the 1024^3 packed
// spectrum, 2.56 ms at 3.35 TB/s); the arithmetic is a few adds per
// element.  One thread handles one bin k < n/2 of one row and touches
// bins k and n-k: a warp reads 32 consecutive elements ascending and 32
// descending, both whole lines, and writes consecutive elements.  Rows
// shorter than the block share a block, so small n keeps every thread
// busy.  The arithmetic repeats the TPU kernel's operation by operation
// (no contraction is possible in it), so the plain version in
// kernels/hermitian.py gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Tiling {
  int tk;        // threads along k per row
  int rpb;       // rows per block
  int kblocks;   // blocks along k
};

Tiling tiling(int nh) {
  Tiling t;
  t.tk = nh >= kThreads ? kThreads : nh;
  t.rpb = kThreads / t.tk;
  t.kblocks = (nh + t.tk - 1) / t.tk;
  return t;
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const float2* __restrict__ c, float2* __restrict__ out,
              long long rows, long long rows_per_half, int n, int tk,
              int rpb, int kblocks) {
  const int nh = n / 2;
  const int lr = threadIdx.x / tk;
  const int k = (blockIdx.x % kblocks) * tk + threadIdx.x % tk;
  if (lr >= rpb || k >= nh) return;
  const long long row_groups = (rows + rpb - 1) / rpb;
  const long long step = (long long)(gridDim.x / kblocks) * gridDim.y;
  for (long long g = (long long)(blockIdx.x / kblocks) * gridDim.y +
                     blockIdx.y;
       g < row_groups; g += step) {
    const long long r = g * rpb + lr;
    if (r >= rows) return;
    const long long o = r / rows_per_half;
    const long long j = r - o * rows_per_half;
    const float2* row = c + r * n;
    float2* a = out + (2 * o * rows_per_half + j) * nh;
    float2* b = a + rows_per_half * nh;
    const float2 ck = row[k];
    if (k == 0) {
      // C[(-0) mod n] is C[0] itself; the Nyquist bin is its own mirror
      const float2 cn = row[nh];
      a[0] = make_float2(0.5f * (ck.x + ck.x), 0.5f * (cn.x + cn.x));
      b[0] = make_float2(0.5f * (ck.y + ck.y), 0.5f * (cn.y + cn.y));
    } else {
      const float2 cm = row[n - k];
      a[k] = make_float2(0.5f * (ck.x + cm.x), 0.5f * (ck.y - cm.y));
      b[k] = make_float2(0.5f * (ck.y + cm.y), -0.5f * (ck.x - cm.x));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
extend_kernel(const float2* __restrict__ s, float2* __restrict__ c,
              long long rows, long long rows_per_half, int n, int tk,
              int rpb, int kblocks) {
  const int nh = n / 2;
  const int lr = threadIdx.x / tk;
  const int k = (blockIdx.x % kblocks) * tk + threadIdx.x % tk;
  if (lr >= rpb || k >= nh) return;
  const long long row_groups = (rows + rpb - 1) / rpb;
  const long long step = (long long)(gridDim.x / kblocks) * gridDim.y;
  for (long long g = (long long)(blockIdx.x / kblocks) * gridDim.y +
                     blockIdx.y;
       g < row_groups; g += step) {
    const long long r = g * rpb + lr;
    if (r >= rows) return;
    const long long o = r / rows_per_half;
    const long long j = r - o * rows_per_half;
    const float2 sa = s[(2 * o * rows_per_half + j) * nh + k];
    const float2 sb = s[((2 * o + 1) * rows_per_half + j) * nh + k];
    float2* row = c + r * n;
    if (k == 0) {
      // bin 0 carries (DC, Nyquist) of each spectrum in (real, imag)
      row[0] = make_float2(sa.x, sb.x);
      row[nh] = make_float2(sa.y, sb.y);
    } else {
      row[k] = make_float2(sa.x - sb.y, sa.y + sb.x);
      row[n - k] = make_float2(sa.x + sb.y, -(sa.y - sb.x));
    }
  }
}

// Blocks along k times row groups, the row groups spread over grid.y
// (at most 65535) and, past that, over grid.x as well.
int launch(bool unpack, const void* src, void* dst, long long rows,
           long long rows_per_half, int n, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (n < 2 || n % 2 || rows_per_half <= 0 || rows % rows_per_half)
    return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(n / 2);
  const long long row_groups = (rows + t.rpb - 1) / t.rpb;
  const long long gy = row_groups < 65535 ? row_groups : 65535;
  long long gx_groups = (row_groups + gy - 1) / gy;
  const long long max_gx_groups = 0x7fffffffLL / t.kblocks;
  if (gx_groups > max_gx_groups) gx_groups = max_gx_groups;
  const dim3 grid((unsigned)(gx_groups * t.kblocks), (unsigned)gy);
  if (unpack)
    unpack_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float2*>(src), static_cast<float2*>(dst), rows,
        rows_per_half, n, t.tk, t.rpb, t.kblocks);
  else
    extend_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float2*>(src), static_cast<float2*>(dst), rows,
        rows_per_half, n, t.tk, t.rpb, t.kblocks);
  return (int)cudaGetLastError();
}

}  // namespace

// c: (rows, n) complex64 with rows = outer * rows_per_half;
// out: (outer, 2, rows_per_half, n/2) complex64.
extern "C" int unpack_launch(const void* c, void* out, long long rows,
                             long long rows_per_half, int n, void* stream) {
  return launch(true, c, out, rows, rows_per_half, n,
                static_cast<cudaStream_t>(stream));
}

// s: (outer, 2, rows_per_half, n/2) complex64; c: (rows, n) complex64.
extern "C" int extend_launch(const void* s, void* c, long long rows,
                             long long rows_per_half, int n, void* stream) {
  return launch(false, s, c, rows, rows_per_half, n,
                static_cast<cudaStream_t>(stream));
}

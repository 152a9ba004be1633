// Fused k-space multiply y = (alpha x) h on interleaved complex64, for
// Hopper (sm_90a): the spectral epilogue of the forward transform.
//
// Replaces both Pallas TPU kernels of repro/kernels/spectral_scale.py,
// which share one body (_scale_kernel):
//   spectral_scale_planes      h of shape (N,), broadcast over the rows
//   spectral_scale_planes_full h of the shape of x
// One kernel serves both: x is viewed as (rows, n) and h has a row stride
// of 0 (broadcast) or n (full shape).
//
// Bound on an H100: bytes.  x is read once, y written once and h read
// once (full) or kept in L1/L2 (broadcast): 12.9 GB for the r2c spectrum
// of the 1024^3 grid, 3.85 ms at 3.35 TB/s, against ~8 flop per element.
// The kernel is one grid-stride pass over float2 elements, consecutive
// threads on consecutive elements; the broadcast column index advances by
// the grid stride modulo n, so the loop does no division.
//
// Order of operations: the TPU kernel scales x by alpha before the
// product, as here.  Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn: no fused multiply-add), as the plain version in
// kernels/spectral_scale.py computes it, so the two agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const float2* __restrict__ x, const float2* __restrict__ h,
             float2* __restrict__ y, long long total, long long n,
             float alpha) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long col = kFull ? 0 : t % n;
  const long long col_step = kFull ? 0 : stride % n;
  for (; t < total; t += stride) {
    const float2 xv = x[t];
    const float2 hv = h[kFull ? t : col];
    const float xr = __fmul_rn(xv.x, alpha);
    const float xi = __fmul_rn(xv.y, alpha);
    y[t] = make_float2(__fsub_rn(__fmul_rn(xr, hv.x), __fmul_rn(xi, hv.y)),
                       __fadd_rn(__fmul_rn(xr, hv.y), __fmul_rn(xi, hv.x)));
    if (!kFull) {
      col += col_step;
      if (col >= n) col -= n;
    }
  }
}

}  // namespace

// x, y: (rows, n) complex64; h: (n,) when h_row_stride is 0, else
// (rows, n) with h_row_stride == n.
extern "C" int spectral_scale_launch(const void* x, const void* h, void* y,
                                     long long rows, long long n,
                                     long long h_row_stride, float alpha,
                                     int sm_count, void* stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  if (h_row_stride != 0 && h_row_stride != n)
    return (int)cudaErrorInvalidValue;
  // enough blocks to fill every SM several times over; each thread then
  // walks the rest of the array in grid-sized strides
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)(sm_count > 0 ? sm_count : 132) * 16;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float2* hp = static_cast<const float2*>(h);
  float2* yp = static_cast<float2*>(y);
  if (h_row_stride == n)
    scale_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(xp, hp, yp,
                                                             total, n, alpha);
  else
    scale_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        xp, hp, yp, total, n, alpha);
  return (int)cudaGetLastError();
}

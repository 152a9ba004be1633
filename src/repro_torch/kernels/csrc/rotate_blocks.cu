// Cyclic rotation of P equal blocks of a complex64 tensor, for Hopper
// (sm_90a): the fused pack/unpack pass of the ring and pairwise global
// transposes.
//
// Replaces the Pallas TPU kernel repro/kernels/transpose_pack.py:
// rotate_block_rows_planes (_rotate_kernel).  The tensor is viewed as
// (outer, P, unit): `outer` is the product of the dims before the
// rotated axis, `unit` the complex elements of one block per outer index.
// Destination block (o, i) is source block (o, (i + shift) % P).  Either
// side may instead be laid out piece-major, (P, outer, unit): the pack
// writes its P send pieces that way, so each piece is one contiguous
// buffer a collective can send as it is, and the unpack reads the P
// received pieces from one such buffer, so the concatenate before the
// rotation is never materialized.
//
// Bound on an H100: bytes, a pure copy, every byte read once and written
// once; a 2 GiB rank block of croft-1024 moves 4 GiB, 1.28 ms at 3.35
// TB/s.  A copy needs many bytes in flight and nothing else, so:
//   - every thread has kUnroll independent loads of 16 bytes (8 for an
//     odd `unit` or a base that is only 8-byte aligned) in flight before
//     its first store;
//   - a thread block spans a fixed number of destination vectors across
//     runs, not one run, so short runs (1 KB in phase 1's axis-2 case)
//     leave no thread idle; each vector finds its source run on its own;
//   - x and y stream with evict-first hints (__ldcs/__stcs);
//   - offsets are 64-bit throughout: a 2 GiB block has byte offsets past
//     2^31.
// On the H100 this runs at 88-90 % of the bytes bound on 2 GiB blocks,
// within 4 % of one Tensor.copy_ of the same bytes.  A persistent grid
// moving the bytes by TMA bulk copies through a shared-memory ring ran
// 1-6 % behind it on every shape measured and was removed (PERF.md).
// kernels/transpose_pack.py (rotate_path) picks the vector width; the
// launcher refuses 16-byte vectors the bases cannot take.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Destination runs are numbered in destination memory order, r = o * P + i
// (natural) or i * outer + o (piece-major); `source(r)` is the run of the
// source that lands there, numbered the same way on its side.
struct Geometry {
  long long outer;
  int p;
  int shift;
  int src_piece_major;
  int dst_piece_major;

  __device__ __forceinline__ long long source(long long r) const {
    long long o;
    int i;
    if (dst_piece_major) {
      i = (int)(r / outer);
      o = r - (long long)i * outer;
    } else {
      o = r / p;
      i = (int)(r - o * p);
    }
    int j = i + shift;
    if (j >= p) j -= p;
    return src_piece_major ? (long long)j * outer + o : o * p + j;
  }
};

constexpr int kThreads = 256;
constexpr int kUnroll = 4;               // independent loads per thread

template <typename V>
__global__ void __launch_bounds__(kThreads)
rotate_vec_kernel(const V* __restrict__ src, V* __restrict__ dst, Geometry g,
                  long long unit, long long total) {
  const long long base =
      (long long)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  V v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long d = base + k * kThreads;
    if (d < total) {
      const long long r = d / unit;
      v[k] = __ldcs(src + g.source(r) * unit + (d - r * unit));
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long d = base + k * kThreads;
    if (d < total) __stcs(dst + d, v[k]);
  }
}

template <typename V>
int launch_vec(const void* src, void* dst, Geometry g, long long unit,
               cudaStream_t stream) {
  const long long total = g.outer * g.p * unit;
  const long long blocks =
      (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rotate_vec_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), g, unit, total);
  return (int)cudaGetLastError();
}

}  // namespace

// `inner` counts complex64 elements of one block per outer index;
// `vec_bytes` is transpose_pack.rotate_path's choice, 16 or 8.
extern "C" int rotate_blocks_launch(const void* src, void* dst,
                                    long long outer, int p, long long inner,
                                    int shift, int src_piece_major,
                                    int dst_piece_major, int vec_bytes,
                                    void* stream) {
  if (outer <= 0 || p <= 0 || inner <= 0) return 0;
  const Geometry g{outer, p, ((shift % p) + p) % p, src_piece_major,
                   dst_piece_major};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16:
      if (inner % 2 != 0 || reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(dst) % 16 != 0)
        return (int)cudaErrorInvalidValue;
      return launch_vec<float4>(src, dst, g, inner / 2, s);
    case 8:
      return launch_vec<float2>(src, dst, g, inner, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

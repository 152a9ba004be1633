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
// Bound on an H100: a pure copy, every byte read once and written once;
// a 32 MiB block moves 64 MiB, ~20 us at 3.35 TB/s.  The TPU kernel moved
// the axis to the front and split real/imag planes around the copy; here
// the copy reads and writes interleaved complex64 in place of that, in
// 16-byte vectors where the block size and alignment allow, each thread
// block copying one contiguous chunk of one block, so every warp reads
// and writes whole consecutive lines.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = kThreads * 8;  // vectors per thread block

template <typename V>
__global__ void __launch_bounds__(kThreads)
rotate_kernel(const V* __restrict__ src, V* __restrict__ dst,
              long long outer, int p, long long unit, int shift,
              int src_piece_major, int dst_piece_major, long long chunks) {
  const long long blk = blockIdx.x;
  const long long pair = blk / chunks;          // destination block o * p + i
  const long long chunk = blk - pair * chunks;
  const long long o = pair / p;
  const int i = (int)(pair - o * p);
  int j = i + shift;
  if (j >= p) j -= p;
  const long long s_off =
      (src_piece_major ? (long long)j * outer + o : o * p + j) * unit;
  const long long d_off =
      (dst_piece_major ? (long long)i * outer + o : o * p + i) * unit;
  const long long begin = chunk * kChunk;
  const long long end = begin + kChunk < unit ? begin + kChunk : unit;
  for (long long e = begin + threadIdx.x; e < end; e += kThreads)
    dst[d_off + e] = src[s_off + e];
}

template <typename V>
int launch(const void* src, void* dst, long long outer, int p,
           long long unit, int shift, int spm, int dpm, cudaStream_t stream) {
  const long long chunks = (unit + kChunk - 1) / kChunk;
  const long long blocks = outer * p * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rotate_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), outer, p, unit, shift,
      spm, dpm, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// `inner` counts complex64 elements of one block per outer index.
extern "C" int rotate_blocks_launch(const void* src, void* dst,
                                    long long outer, int p, long long inner,
                                    int shift, int src_piece_major,
                                    int dst_piece_major, void* stream) {
  if (outer <= 0 || p <= 0 || inner <= 0) return 0;
  shift = ((shift % p) + p) % p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = inner % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (vec16)
    return launch<float4>(src, dst, outer, p, inner / 2, shift,
                          src_piece_major, dst_piece_major, s);
  return launch<float2>(src, dst, outer, p, inner, shift, src_piece_major,
                        dst_piece_major, s);
}

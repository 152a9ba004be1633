// Fused causal/windowed GQA attention (forward, online softmax) for Hopper
// (sm_90a): the prefill and full-sequence attention of the LM path.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel).  Same function:
//   out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
// with g = H / KV, keys masked to j <= i (causal) and i - j < window,
// positions 0..S-1 on both sides, masked scores set to the finite
// NEG_INF = -2^30 (a fully masked row stays NaN-free), scores, the
// running (m, l) and the accumulator in float32, the output in q's type.
//
// Bound on an H100: operations.  At the h2o-danube-3-4b prefill (B 2,
// S 6144, 32 heads over 8 KV heads, head_dim 120, window 4096) the
// unmasked pairs need ~5.2e11 flop against ~0.24 GB of operands: 0.52 ms
// at the bf16 tensor-core rate.
//
// Two kernels; the wrapper (kernels/flash_attention.py) picks one by
// dtype and shape:
//
// tc::flash_kernel, bfloat16 on the tensor cores (the serving path).
//   One block per (128-query tile, head, batch): two consumer warpgroups
//   of 64 query rows each and one producer warp.  The producer loads the
//   q tile once and 64-key chunks of K and V into a ring of 3
//   shared-memory stages by TMA (4-D tensor maps over the (B, S, heads,
//   D) layouts, so the GQA KV head is read in place), each stage signalled
//   by a "full" mbarrier and released by an "empty" one.  head_dim is
//   padded to 128 by the maps' out-of-bounds zero fill, as two boxes of 64
//   elements (128 bytes, the 128-byte swizzle that wgmma reads).
//   S = Q K^T: wgmma m64n64k16 bf16 -> f32, Q and K from shared memory;
//   products of bf16 values are exact in f32, so s equals the f32 scores
//   up to summation order; scale multiplies s in f32.
//   Softmax in registers: each row's 64 scores lie in one quad of lanes,
//   so its max is two shuffles; the row sum stays a per-lane partial (all
//   four lanes rescale by the same alpha) summed at the end.  Within a
//   warpgroup the chunks are pipelined: chunk c + 1's S product is issued
//   before chunk c's P.V, and its softmax runs while that P.V is on the
//   tensor cores (the two warpgroups of a block overlap each other too).
//   O += P V with p split in two: p_hi = bf16(p), p_lo = bf16(p - p_hi),
//   both as register A operands of wgmma m64n128k16 (V from shared memory,
//   MN-major), accumulated in f32.  The Pallas kernel keeps p in f32; one
//   bf16 rounding of p misses the per-element bf16 check (2^-6 |want| +
//   5e-5) by up to 13.5x at the reference's bf16 case (1 x 128 x 128, 2
//   heads, d 64, against the Pallas kernel in interpret mode), while the
//   split holds it at 0.48 of the bound (tests/test_torch_flash_attention.py
//   pins both).  The split costs 6 D flop per pair against the bound's 4 D.
//   Needs head dims that are multiples of 8 (TMA row strides are multiples
//   of 16 bytes) and 16-byte aligned bases; the wrapper sends other shapes
//   to the FFMA kernel.
//
// ffma::flash_kernel, FP32 FFMA (float32, and bf16 shapes TMA cannot
// describe).  One block of 256 threads (8 warps) per (q tile of 128 rows,
// q head, batch).  The block stages its q tile, scaled and converted to
// float32, in shared memory once, then walks 64-key chunks of its GQA
// KV head: the chunk's K and V are staged (converted, zero-padded to a
// head_dim of 128) and every warp takes 16 query rows.
//   scores: lane l holds keys l and l + 32 of the chunk for its warp's 16
//           rows; q rows are read as broadcast float4s, K rows as float4s
//           at an odd 16-byte row stride (no bank conflicts);
//   softmax: the row max is a warp butterfly; the row sum stays a per-lane
//           partial (every lane rescales by the same alpha) and is summed
//           once at the end;
//   P.V:    p goes through a per-warp shared tile; lane l owns output
//           columns 4l..4l+3 of the warp's 16 rows (64 float32 registers).
//   Tensor cores would run float32 as TF32, which misses the 5e-5 check.
//
// Both kernels skip the chunks that the mask removes for every row of the
// tile.  That is exact: a row's first valid key lies at or before its own
// position, and once it arrives alpha = exp(NEG_INF - m) erases whatever
// a wholly masked chunk added.  A tile holding a row with no valid key
// at all (possible only when Sq > Skv + window - 1) walks every chunk,
// as the reference does.  Keys past Skv (the ragged last chunk) take no
// part at all: score -inf, p = 0, v = 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF

// the chunks a tile of rows [q0, q_last] needs (see the note at the top)
__device__ __forceinline__ void chunk_range(int q0, int q_last, int skv,
                                            int causal, int has_window,
                                            int window, int bk, int* begin,
                                            int* end) {
  const bool skip_ok =
      !has_window ||
      (window >= 1 && (long long)q_last <= (long long)skv + window - 2);
  *begin = 0;
  *end = (skv + bk - 1) / bk;
  if (skip_ok) {
    const int lo = has_window ? max(0, q0 - window + 1) : 0;
    const int hi = causal ? min(q_last, skv - 1) : skv - 1;
    *begin = lo / bk;
    *end = hi / bk + 1;
  }
}

namespace ffma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;        // 128 query rows per block
constexpr int kBK = 64;                    // keys per chunk, 2 per lane
constexpr int kDMax = 128;                 // head_dim limit (zero-padded)
constexpr int kQKStride = kDMax + 4;       // 33 float4s: odd, conflict-free
constexpr int kVStride = kDMax;
constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(kBQ * kQKStride + kBK * kQKStride +
                             kBK * kVStride + kWarps * kRows * kBK);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int n_heads, int n_kv, int d, int dv, int causal, int has_window,
             int window, float scale) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * kQKStride;
  float* sV = sK + kBK * kQKStride;
  float* sP = sV + kBK * kVStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (n_heads / n_kv);

  // the q tile, as the reference computes it: q.astype(f32) * scale
  for (int t = tid; t < kBQ * kDMax; t += kThreads) {
    const int r = t / kDMax, e = t % kDMax;
    const int i = q0 + r;
    float x = 0.f;
    if (i < sq && e < d)
      x = to_float(q[(((long long)batch * sq + i) * n_heads + head) * d + e]) *
          scale;
    sQ[r * kQKStride + e] = x;
  }

  int c_begin, c_end;
  chunk_range(q0, min(q0 + kBQ, sq) - 1, skv, causal, has_window, window,
              kBK, &c_begin, &c_end);

  const int r0 = warp * kRows;
  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }
  const int nd4 = (d + 3) / 4;
  float* pw = sP + warp * kRows * kBK;

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int k0 = chunk * kBK;
    __syncthreads();  // the previous chunk's K/V reads are done
    for (int t = tid; t < kBK * kDMax; t += kThreads) {
      const int j = t / kDMax, e = t % kDMax;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < skv) {
        const long long row = ((long long)batch * skv + key) * n_kv + kv_head;
        if (e < d) kx = to_float(k[row * d + e]);
        if (e < dv) vx = to_float(v[row * dv + e]);
      }
      sK[j * kQKStride + e] = kx;
      sV[j * kVStride + e] = vx;
    }
    __syncthreads();

    // scores of keys (lane, lane + 32) for the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka_row = sK + lane * kQKStride;
    const float* kb_row = sK + (lane + 32) * kQKStride;
#pragma unroll 2
    for (int e4 = 0; e4 < nd4; ++e4) {
      const float4 ka = *reinterpret_cast<const float4*>(ka_row + 4 * e4);
      const float4 kb = *reinterpret_cast<const float4*>(kb_row + 4 * e4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (r0 + r) * kQKStride + 4 * e4);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }

    // mask, online softmax, p into the warp's tile
    const int ja = k0 + lane, jb = k0 + lane + 32;
    const float minus_inf = __int_as_float(0xff800000);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + r0 + r;
      float sa = s[r][0], sb = s[r][1];
      if (ja >= skv) sa = minus_inf;
      else if ((causal && ja > i) || (has_window && i - ja >= window))
        sa = kNegInf;
      if (jb >= skv) sb = minus_inf;
      else if ((causal && jb > i) || (has_window && i - jb >= window))
        sb = kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float pa = expf(sa - m_new);
      const float pb = expf(sb - m_new);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * alpha + (pa + pb);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
      pw[r * kBK + lane] = pa;
      pw[r * kBK + lane + 32] = pb;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] v[j][4 lane + c]
    const float* vcol = sV + 4 * lane;
#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      const float4 v0 = *reinterpret_cast<const float4*>(vcol + (4 * j4 + 0) * kVStride);
      const float4 v1 = *reinterpret_cast<const float4*>(vcol + (4 * j4 + 1) * kVStride);
      const float4 v2 = *reinterpret_cast<const float4*>(vcol + (4 * j4 + 2) * kVStride);
      const float4 v3 = *reinterpret_cast<const float4*>(vcol + (4 * j4 + 3) * kVStride);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kBK + 4 * j4);
        acc[r][0] = fmaf(p.x, v0.x, acc[r][0]);
        acc[r][1] = fmaf(p.x, v0.y, acc[r][1]);
        acc[r][2] = fmaf(p.x, v0.z, acc[r][2]);
        acc[r][3] = fmaf(p.x, v0.w, acc[r][3]);
        acc[r][0] = fmaf(p.y, v1.x, acc[r][0]);
        acc[r][1] = fmaf(p.y, v1.y, acc[r][1]);
        acc[r][2] = fmaf(p.y, v1.z, acc[r][2]);
        acc[r][3] = fmaf(p.y, v1.w, acc[r][3]);
        acc[r][0] = fmaf(p.z, v2.x, acc[r][0]);
        acc[r][1] = fmaf(p.z, v2.y, acc[r][1]);
        acc[r][2] = fmaf(p.z, v2.z, acc[r][2]);
        acc[r][3] = fmaf(p.z, v2.w, acc[r][3]);
        acc[r][0] = fmaf(p.w, v3.x, acc[r][0]);
        acc[r][1] = fmaf(p.w, v3.y, acc[r][1]);
        acc[r][2] = fmaf(p.w, v3.z, acc[r][2]);
        acc[r][3] = fmaf(p.w, v3.w, acc[r][3]);
      }
    }
    __syncwarp();  // p reads done before the next chunk overwrites the tile
  }

  // out = acc / max(l, 1e-30), as the reference divides
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float den = fmaxf(warp_sum(l[r]), 1e-30f);
    const int i = q0 + r0 + r;
    if (i >= sq) continue;
    T* orow = out + (((long long)batch * sq + i) * n_heads + head) * dv;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * lane + c;
      if (col < dv) store(orow + col, acc[r][c] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int kvh, int d, int dv, int causal,
           int has_window, int window, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)h, (unsigned)b);
  flash_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, kvh, d, dv,
      causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace ffma

namespace tc {

constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kBQ = 64 * kConsumers;             // query rows per block
constexpr int kBK = 64;                          // keys per chunk
constexpr int kStages = 3;                       // K/V ring depth
constexpr int kRowBytes = 128;                   // 64 bf16: one swizzle row
constexpr int kQHalf = kBQ * kRowBytes;          // one 64-column half of q
constexpr int kKVHalf = kBK * kRowBytes;         // one half of a K or V chunk
constexpr int kStageBytes = 4 * kKVHalf;         // K and V, two halves each
constexpr int kBarBytes = 8 * (1 + 2 * kStages);
constexpr int kSmemBytes =
    1024 + 2 * kQHalf + kStages * kStageBytes + kBarBytes;  // 1024: alignment
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; addr 1024-aligned up to
// a k offset inside the swizzle row; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d = A B + (scale_d ? d : 0), m64n64k16; A and B K-major bf16 in shared
// memory (descriptors da, db)
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n128k16; A bf16 in registers (the m64k16 fragment), B
// MN-major bf16 in shared memory (descriptor db, imm-trans-b 1)
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// p as bf16 pairs: hi = bf16(p), lo = bf16(p - hi), the low half of each
// 32-bit register holding the lower column
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// which scores of a chunk the mask removes, for the rows r0 and r0 + 8
// of a thread whose warpgroup holds rows [wg_first, wg_last]
struct Mask {
  int r0, wg_first, wg_last, skv, causal, has_window, window;
  float scale;
};

// the online softmax of the thread's two rows (m, and l as a per-lane
// partial: the quad's lanes rescale by the same alpha)
struct Softmax {
  float m0, m1, l0, l1;

  // the scores s of the chunk at key k0 -> its p, and each row's alpha.
  // p is an array of its own: rewriting the S accumulator while the
  // previous chunk's P.V is in flight makes ptxas serialize the wgmmas
  __device__ __forceinline__ void step(const float (&s)[32], float (&p)[32],
                                       const Mask& mk, int k0, int t4,
                                       float& a0, float& a1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = s[i];
    if (mk.scale != 1.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] *= mk.scale;
    }
    if (k0 + kBK > mk.skv || (mk.causal && k0 + kBK - 1 > mk.wg_first) ||
        (mk.has_window && mk.wg_last - k0 >= mk.window)) {
      const float minus_inf = __int_as_float(0xff800000);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int row = mk.r0 + 8 * ((i >> 1) & 1);
        if (key >= mk.skv)
          p[i] = minus_inf;
        else if ((mk.causal && key > row) ||
                 (mk.has_window && row - key >= mk.window))
          p[i] = kNegInf;
      }
    }
    float mx0 = p[0], mx1 = p[2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(p[4 * j], p[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(p[4 * j + 2], p[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = exp2f((m0 - mn0) * kLog2e);
    a1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[4 * j] = exp2f((p[4 * j] - mn0) * kLog2e);
      p[4 * j + 1] = exp2f((p[4 * j + 1] - mn0) * kLog2e);
      p[4 * j + 2] = exp2f((p[4 * j + 2] - mn1) * kLog2e);
      p[4 * j + 3] = exp2f((p[4 * j + 3] - mn1) * kLog2e);
      ps0 += p[4 * j] + p[4 * j + 1];
      ps1 += p[4 * j + 2] + p[4 * j + 3];
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
  }
};

// p (the S accumulator layout) as the A fragments of P for keys
// 16 kk .. 16 kk + 15, split into bf16 hi and lo terms
__device__ __forceinline__ void split(const float (&p)[32],
                                      uint32_t (&ph)[4][4],
                                      uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], ph[kk][r],
                 pl[kk][r]);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ out, int sq, int skv, int n_heads,
             int n_kv, int dv, int causal, int has_window, int window,
             float scale, int kh, int vh) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + 2 * kQHalf;
  const uint32_t q_bar = sKV + kStages * kStageBytes;
  auto full = [&](int st) { return q_bar + 8u * (1 + st); };
  auto empty = [&](int st) { return q_bar + 8u * (1 + kStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (n_heads / n_kv);

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int c_begin, c_end;
  chunk_range(q0, min(q0 + kBQ, sq) - 1, skv, causal, has_window, window,
              kBK, &c_begin, &c_end);

  if (warp == 4 * kConsumers) {
    // producer: the q tile once, then K/V chunks into the ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, kh * kQHalf);
      for (int h = 0; h < kh; ++h)
        tma_load(sQ + h * kQHalf, &tq, q_bar, 64 * h, head, q0, batch);
      int it = 0;
      for (int c = c_begin; c < c_end; ++c, ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) + 1) & 1);
        mbar_expect_tx(full(st), (kh + vh) * kKVHalf);
        const uint32_t sK = sKV + st * kStageBytes, sV = sK + 2 * kKVHalf;
        for (int h = 0; h < kh; ++h)
          tma_load(sK + h * kKVHalf, &tk, full(st), 64 * h, kv_head, c * kBK,
                   batch);
        for (int h = 0; h < vh; ++h)
          tma_load(sV + h * kKVHalf, &tv, full(st), 64 * h, kv_head, c * kBK,
                   batch);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64);
  // this thread holds rows r0 and r0 + 8, columns 8 j + 2 t4 (+1)
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  const int r0 = wg_first + 16 * (warp & 3) + g;
  const uint32_t qA = sQ + 64 * kRowBytes * wg;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  Softmax sm{kNegInf, kNegInf, 0.f, 0.f};
  float s[32];                  // the scores of the chunk ahead
  float p[32];                  // and its p
  uint32_t ph[4][4], pl[4][4];  // p of the chunk in the P.V product
  const Mask mask{r0, wg_first, wg_last, skv, causal, has_window, window,
                  scale};
  auto scores = [&](int it) {   // issue S = Q K^T for ring slot it
    const uint32_t sK = sKV + (it % kStages) * kStageBytes;
    wgmma_fence();
    for (int h = 0; h < kh; ++h) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64_ss(s, desc(qA + h * kQHalf + 32 * kk, 16, 1024),
                        desc(sK + h * kKVHalf + 32 * kk, 16, 1024),
                        (h | kk) != 0);
    }
    wgmma_commit();
  };
  // issue O += P_hi V + P_lo V for ring slot it; V rows are keys: 16 keys
  // are 2048 bytes, the two 64-column halves kKVHalf apart (lbo), 8-key
  // groups 1024 (sbo)
  auto pv = [&](int it) {
    const uint32_t sV = sKV + (it % kStages) * kStageBytes + 2 * kKVHalf;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128_rs(o, ph[kk], desc(sV + 2048 * kk, kKVHalf, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128_rs(o, pl[kk], desc(sV + 2048 * kk, kKVHalf, 1024));
    wgmma_commit();
  };

  // chunk c's P.V runs on the tensor cores while chunk c + 1's softmax
  // runs beside it; o takes chunk c + 1's alpha once the P.V is done
  float a0, a1;
  mbar_wait(q_bar, 0);
  mbar_wait(full(0), 0);
  scores(0);
  wgmma_wait<0>();
  fence_regs(s);
  sm.step(s, p, mask, c_begin * kBK, t4, a0, a1);
  split(p, ph, pl);
  int it = 0;
  for (int c = c_begin; c + 1 < c_end; ++c, ++it) {
    mbar_wait(full((it + 1) % kStages), ((it + 1) / kStages) & 1);
    scores(it + 1);
    pv(it);
    wgmma_wait<1>();  // the scores; the P.V may still run
    fence_regs(s);
    sm.step(s, p, mask, (c + 1) * kBK, t4, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty(it % kStages));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    split(p, ph, pl);
  }
  pv(it);
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(empty(it % kStages));
  float l0 = sm.l0, l1 = sm.l1;

  // out = o / max(l, 1e-30), as the reference divides
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* row0 =
      out + (((long long)batch * sq + r0) * n_heads + head) * dv;
  __nv_bfloat16* row1 = row0 + 8LL * n_heads * dv;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t4;  // dv is even: col + 1 < dv too
    if (col < dv) {
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
            __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
      if (r0 + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (batch, seq, heads, dim) bf16, contiguous: boxes of 64 dims x 1 head x
// rows positions, 128-byte swizzle, zeros out of bounds
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
             int dim, int rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dim * 2,
                                 (cuuint64_t)heads * dim * 2,
                                 (cuuint64_t)seq * heads * dim * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int kvh, int d, int dv, int causal,
           int has_window, int window, float scale, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, b, sq, h, d, kBQ);
  if (err == 0) err = make_map(&tk, k, b, skv, kvh, d, kBK);
  if (err == 0) err = make_map(&tv, v, b, skv, kvh, dv, kBK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)h, (unsigned)b);
  flash_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), sq, skv, h, kvh, dv,
      causal, has_window, window, scale, d > 64 ? 2 : 1, dv > 64 ? 2 : 1);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (b, sq, h, d), k (b, skv, kvh, d), v (b, skv, kvh, dv), out (b, sq, h,
// dv), all contiguous, of one type: dtype 0 = float32, 1 = bfloat16.  The
// FFMA kernel.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int sq, int skv, int h, int kvh,
                                      int d, int dv, int causal,
                                      int has_window, int window, float scale,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 || dv <= 0 ||
      d > ffma::kDMax || dv > ffma::kDMax || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ffma::launch<float>(q, k, v, out, b, sq, skv, h, kvh, d, dv,
                               causal, has_window, window, scale, s);
  if (dtype == 1)
    return ffma::launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, kvh, d,
                                       dv, causal, has_window, window, scale,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// The same layouts in bfloat16 on the tensor cores: head dims d, dv <= 128
// and multiples of 8, every base 16-byte aligned.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int sq, int skv, int h, int kvh,
                                         int d, int dv, int causal,
                                         int has_window, int window,
                                         float scale, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 || dv <= 0 ||
      d > 128 || dv > 128 || d % 8 != 0 || dv % 8 != 0 || h > 65535 ||
      b > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15))
    return (int)cudaErrorInvalidValue;
  return tc::launch(q, k, v, out, b, sq, skv, h, kvh, d, dv, causal,
                    has_window, window, scale, static_cast<cudaStream_t>(stream));
}

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
// unmasked pairs need ~5.2e11 flop against ~0.24 GB of operands.
// This first kernel runs both products as FP32 FFMA (no tensor cores),
// so its practical floor is the FP32 rate, not the bf16 tensor-core one.
//
// Design.  One block of 256 threads (8 warps) per (q tile of 128 rows,
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
// Chunks that the mask removes for every row of the tile are skipped.
// That is exact: a row's first valid key lies at or before its own
// position, and once it arrives alpha = exp(NEG_INF - m) erases whatever
// a wholly masked chunk added.  A tile holding a row with no valid key
// at all (possible only when Sq > Skv + window - 1) walks every chunk,
// as the reference does.  Keys past Skv (the ragged last chunk) take no
// part at all: score -inf, p = 0, v = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;        // 128 query rows per block
constexpr int kBK = 64;                    // keys per chunk, 2 per lane
constexpr int kDMax = 128;                 // head_dim limit (zero-padded)
constexpr int kQKStride = kDMax + 4;       // 33 float4s: odd, conflict-free
constexpr int kVStride = kDMax;
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's NEG_INF
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

  // the chunks this tile needs (see the note at the top)
  const int q_last = min(q0 + kBQ, sq) - 1;
  const bool skip_ok =
      !has_window ||
      (window >= 1 && (long long)q_last <= (long long)skv + window - 2);
  int c_begin = 0;
  int c_end = (skv + kBK - 1) / kBK;
  if (skip_ok) {
    const int lo = has_window ? max(0, q0 - window + 1) : 0;
    const int hi = causal ? min(q_last, skv - 1) : skv - 1;
    c_begin = lo / kBK;
    c_end = hi / kBK + 1;
  }

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

}  // namespace

// q (b, sq, h, d), k (b, skv, kvh, d), v (b, skv, kvh, dv), out (b, sq, h,
// dv), all contiguous, of one type: dtype 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int sq, int skv, int h, int kvh,
                                      int d, int dv, int causal,
                                      int has_window, int window, float scale,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 || dv <= 0 ||
      d > kDMax || dv > kDMax || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, sq, skv, h, kvh, d, dv, causal,
                         has_window, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, kvh, d, dv,
                                 causal, has_window, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

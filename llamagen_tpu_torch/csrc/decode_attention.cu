// Single-token decode attention for one layer, with an in-place KV cache.
//
// Replaces the Pallas kernel llamagen_tpu/ops/attention.py::decode_attention
// (body `_decode_attn_kernel`, pallas_call at attention.py:569). Semantics:
//   - this step's k|v row is written into the cache at pos[b] (bf16/f32
//     caches), or into the exact 32-row tail at pos[b] % 32 (int8 caches);
//   - query head h attends, with an f32 online softmax, to positions
//     prefix_pad[b] <= s <= pos[b], reading kv head h / (H / H_kv) (GQA);
//   - int8 caches: rows s < bnd = 32 * (pos // 32) are int8 with per-row k
//     and v scales (bf16) folded into the scores and the probabilities; rows
//     [bnd, pos] come exact from the tail; when pos % 32 == 31 the 32 tail
//     rows are quantised (f32 math, scale max|half| / 127 + 1e-8, round half
//     to even, clip +-127) into cache rows [bnd, bnd + 32) and the scales are
//     stored as bf16 -- the JAX recent-window flush (attention.py:274-309).
// The cache layout is the JAX one: [B, S, 2 * F_kv], k in [0, F_kv), v in
// [F_kv, 2 * F_kv). Scales are [B, S, 2] (k, v) instead of the TPU's
// lane-broadcast [B, S, 128].
//
// Race hazard: blocks of one launch run in no order, and every head's block
// reads the row this step inserts. So the insert (and the int8 flush, which
// reads the whole tail) is its own launch, ahead of the attention launch on
// the same stream; one block per batch row does insert then flush, so the
// flush sees the new tail row after a __syncthreads. The attention launch
// only reads. Whether a row flushes is decided on the device from pos.
//
// What bounds it on the H100: reading the cache. One block per (batch row,
// query head) streams that head's k and v lanes for the rows <= pos; at
// GPT-L (B = 16, 16 heads, head_dim 64) an int8 cache averages ~9.4 MB per
// layer and step. Flops are ~2 per byte, far below the tensor-core line.
//
// What the design does about it: rows are read once per query head, lanes
// of a warp cover one row's head_dim contiguously (coalesced), and the
// eight warps of a block take interleaved rows with their own online
// softmax state, merged once at the end. Rows past pos are never read.
// Split-K over rows (flash-decoding) and wider per-lane loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTail = 32;   // exact int8 tail rows (JAX RECENT_INT8)
constexpr int kWarps = 8;
constexpr int kBatch = 4;   // rows a warp loads before it uses them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bf16/f32 cache: cache[b, pos[b]] = kv_new[b] (converted to the cache type)
template <typename T, typename C>
__global__ void insert_kernel(const T* __restrict__ kv_new,
                              C* __restrict__ cache,
                              const int* __restrict__ pos, int S, int row) {
  const int b = blockIdx.x;
  C* dst = cache + ((size_t)b * S + pos[b]) * row;
  for (int i = threadIdx.x; i < row; i += blockDim.x)
    dst[i] = from_f32<C>(to_f32(kv_new[(size_t)b * row + i]));
}

// int8 cache: tail[b, pos % 32] = kv_new[b]; at pos % 32 == 31 quantise the
// 32 tail rows into cache rows [bnd, bnd + 32) with bf16 scales.
template <typename T>
__global__ void insert_flush_int8_kernel(const T* __restrict__ kv_new,
                                         T* __restrict__ tail,
                                         int8_t* __restrict__ cache,
                                         __nv_bfloat16* __restrict__ scales,
                                         const int* __restrict__ pos, int S,
                                         int f_kv) {
  const int b = blockIdx.x;
  const int row = 2 * f_kv;
  const int j = pos[b] % kTail;
  const int bnd = pos[b] - j;
  T* trow = tail + ((size_t)b * kTail + j) * row;
  for (int i = threadIdx.x; i < row; i += blockDim.x)
    trow[i] = kv_new[(size_t)b * row + i];
  if (j != kTail - 1) return;  // the same for every thread of the block
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int task = warp; task < 2 * kTail; task += n_warps) {
    const int r = task / 2, half = task % 2;
    const T* src = tail + ((size_t)b * kTail + r) * row + half * f_kv;
    float amax = 0.f;
    for (int i = lane; i < f_kv; i += 32)
      amax = fmaxf(amax, fabsf(to_f32(src[i])));
    amax = warp_max(amax);
    const float sc = amax / 127.0f + 1e-8f;
    int8_t* dst = cache + ((size_t)b * S + bnd + r) * row + half * f_kv;
    for (int i = lane; i < f_kv; i += 32) {
      const float qv = rintf(to_f32(src[i]) / sc);
      dst[i] = static_cast<int8_t>(fminf(fmaxf(qv, -127.f), 127.f));
    }
    if (lane == 0)
      scales[((size_t)b * S + bnd + r) * 2 + half] = __float2bfloat16_rn(sc);
  }
}

// Online-softmax walk of one warp over rows lo + warp, lo + warp + 8, ...
// below hi of one batch row's buffer (`base`, `stride` elements per row).
// The warp loads kBatch rows' k and v (and scales) before it uses them, so
// it waits for memory about once per kBatch rows. kScaled: int8 rows with
// per-row (k, v) bf16 scales folded into the score and the probability.
template <typename R, bool kScaled, int EPL>
__device__ __forceinline__ void attend_rows(
    const R* __restrict__ base, int stride,
    const __nv_bfloat16* __restrict__ scales, int lo, int hi, int warp,
    int koff, int voff, const float (&qv)[EPL], float& m, float& l,
    float (&acc)[EPL]) {
  for (int s0 = lo + warp; s0 < hi; s0 += kWarps * kBatch) {
    float kf[kBatch][EPL], vf[kBatch][EPL], ks[kBatch], vs[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int s = min(s0 + r * kWarps, hi - 1);  // past hi: a dummy load
      const R* row = base + (size_t)s * stride;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kf[r][e] = to_f32(row[koff + e]);
        vf[r][e] = to_f32(row[voff + e]);
      }
      ks[r] = vs[r] = 1.f;
      if constexpr (kScaled) {
        ks[r] = __bfloat162float(scales[(size_t)s * 2]);
        vs[r] = __bfloat162float(scales[(size_t)s * 2 + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      if (s0 + r * kWarps >= hi) break;  // the same for the whole warp
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qv[e] * kf[r][e];
      dot = warp_sum(dot) * ks[r];
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float pr = expf(dot - m_new);
      l = l * alpha + pr;
      const float pv = pr * vs[r];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = acc[e] * alpha + pv * vf[r][e];
      m = m_new;
    }
  }
}

// One block per (query head, batch row); EPL = head_dim / 32 elements per
// lane. Reads only: rows [pad, bnd) from the cache, and for int8 caches rows
// [max(pad, bnd), pos] from the tail.
template <typename T, typename C, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const C* __restrict__ cache,
                   const __nv_bfloat16* __restrict__ scales,
                   const T* __restrict__ tail, const int* __restrict__ pos,
                   const int* __restrict__ pad, T* __restrict__ out, int S,
                   int H, int H_kv, float scale) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int D = 32 * EPL;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = H * D, f_kv = H_kv * D, row = 2 * f_kv;
  const int kvh = h / (H / H_kv);
  const int p = pos[b];
  const int pd = pad == nullptr ? 0 : pad[b];
  const int bnd = kInt8 ? p - p % kTail : p + 1;
  const int koff = kvh * D + lane * EPL;
  const int voff = f_kv + koff;

  float qv[EPL], acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qv[e] = to_f32(q[(size_t)b * f + h * D + lane * EPL + e]) * scale;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  attend_rows<C, kInt8, EPL>(cache + (size_t)b * S * row, row,
                             kInt8 ? scales + (size_t)b * S * 2 : nullptr,
                             pd, bnd, warp, koff, voff, qv, m, l, acc);
  if constexpr (kInt8)
    attend_rows<T, false, EPL>(tail + (size_t)b * kTail * row, row, nullptr,
                               max(pd, bnd) - bnd, p - bnd + 1, warp, koff,
                               voff, qv, m, l, acc);

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[e];
  __syncthreads();
  if (warp != 0) return;
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float l_all = 0.f, o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no row has m = -inf and contributes nothing
    const float c = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - m_all);
    l_all += sm_l[w] * c;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] += sm_acc[w][lane * EPL + e] * c;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    out[(size_t)b * f + h * D + lane * EPL + e] =
        from_f32<T>(l_all > 0.f ? o[e] / l_all : 0.f);
}

template <typename T, typename C, int EPL>
void launch_attn(const void* q, const void* cache, const void* scales,
                 const void* tail, const int* pos, const int* pad, void* out,
                 int B, int S, int H, int H_kv, float scale,
                 cudaStream_t st) {
  decode_attn_kernel<T, C, EPL><<<dim3(H, B), kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const C*>(cache),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const T*>(tail), pos, pad, static_cast<T*>(out), S, H,
      H_kv, scale);
}

template <typename T, typename C>
cudaError_t launch(const void* q, const void* kv_new, void* cache,
                   void* scales, void* tail, const void* pos_v,
                   const void* pad_v, void* out, int B, int S, int H,
                   int H_kv, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(pos_v);
  const int* pad = static_cast<const int*>(pad_v);
  if (D % 32 != 0 || D > 128 || H % H_kv != 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same<C, int8_t>::value) {
    insert_flush_int8_kernel<T><<<B, 256, 0, st>>>(
        static_cast<const T*>(kv_new), static_cast<T*>(tail),
        static_cast<int8_t*>(cache), static_cast<__nv_bfloat16*>(scales),
        pos, S, H_kv * D);
  } else {
    insert_kernel<T, C><<<B, 256, 0, st>>>(static_cast<const T*>(kv_new),
                                           static_cast<C*>(cache), pos, S,
                                           2 * H_kv * D);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (D / 32) {
    case 1: launch_attn<T, C, 1>(q, cache, scales, tail, pos, pad, out, B, S,
                                 H, H_kv, scale, st); break;
    case 2: launch_attn<T, C, 2>(q, cache, scales, tail, pos, pad, out, B, S,
                                 H, H_kv, scale, st); break;
    case 3: launch_attn<T, C, 3>(q, cache, scales, tail, pos, pad, out, B, S,
                                 H, H_kv, scale, st); break;
    default: launch_attn<T, C, 4>(q, cache, scales, tail, pos, pad, out, B,
                                  S, H, H_kv, scale, st); break;
  }
  return cudaGetLastError();
}

}  // namespace

// One C entry point per (compute dtype, cache dtype). Pointers: q, kv_new,
// cache, scales (int8 only, else null), tail (int8 only, else null), pos,
// prefix_pad (may be null), out.
#define DECODE_ATTENTION_ENTRY(NAME, T, C)                                    \
  extern "C" cudaError_t NAME(const void* q, const void* kv_new, void* cache, \
                              void* scales, void* tail, const void* pos,      \
                              const void* pad, void* out, int B, int S,       \
                              int H, int H_kv, int D, float scale,            \
                              void* stream) {                                 \
    return launch<T, C>(q, kv_new, cache, scales, tail, pos, pad, out, B, S,  \
                        H, H_kv, D, scale, stream);                           \
  }

DECODE_ATTENTION_ENTRY(decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
DECODE_ATTENTION_ENTRY(decode_attention_bf16_f32, __nv_bfloat16, float)
DECODE_ATTENTION_ENTRY(decode_attention_bf16_int8, __nv_bfloat16, int8_t)
DECODE_ATTENTION_ENTRY(decode_attention_f32_f32, float, float)
DECODE_ATTENTION_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DECODE_ATTENTION_ENTRY(decode_attention_f32_int8, float, int8_t)

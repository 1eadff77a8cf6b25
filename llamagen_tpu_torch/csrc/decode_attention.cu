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
// lane-broadcast [B, S, 128]. head_dim 64, 100 or 128.
//
// What bounds it on the H100: reading the cache. Each kv head's rows <= pos
// are read once per group of query heads that share it; at GPT-L (B = 16,
// 16 heads, head_dim 64, pos ~288) an int8 cache moves ~4.7 MB per layer and
// step (~1.4 us at 3.35 TB/s), a bf16 cache ~9.4 MB. Flops are ~2 per byte,
// far below the tensor-core line, so what is left is latency: the design
// keeps many 16-byte loads in flight and makes one launch per call.
//
// One launch per call in every entry; the insert (and the int8 flush) is
// folded in: the attention takes row pos from kv_new, not from the cache or
// the tail, so the block that writes it races no reader (attention_mma.cuh
// has the full argument, the flush included).
//   - bf16 q, int8 cache (the W8A16 + int8-KV operating point): the
//     tensor-core kernel of attention_mma.cuh (`attn_mma_kernel<.., true>`):
//     int8 tiles through a `cp.async` ring, turned into bf16 in shared
//     memory, S^T = K Q^T and O^T += V^T P^T on `mma.sync`, the k scale on
//     the score, the v scale folded into p before its bf16 rounding.
//   - bf16 q, bf16 cache: K5's entry `chunk_attention_bf16_bf16`
//     (csrc/chunk_attention.cu) at C = 1, called by the wrapper.
//   - the f32 and mixed-dtype entries (f32 q, or an f32 cache): the CUDA-core
//     kernel below, one block per (query head, batch row), lanes across
//     head_dim, eight warps on interleaved rows with their own online softmax
//     state, merged at the end; its first block of each kv head writes the
//     row, and at a flush each block quantises its share of the 64 (row,
//     half) tasks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>
#include <type_traits>

#include "attention_mma.cuh"

namespace {

using namespace kutil;
using attn_mma::flush_task;
using attn_mma::kTail;

constexpr int kWarps = 8;
constexpr int kBatch = 4;   // rows a warp loads before it uses them

// Online-softmax walk of one warp over rows lo + warp, lo + warp + 8, ...
// below hi of one buffer (`base`, `stride` elements per row). The warp loads
// kBatch rows' k and v (and scales) before it uses them, so it waits for
// memory about once per kBatch rows. Values are read as R and rounded
// through Q (the cache type a row is stored in before it is read: kv_new's
// row as the cache holds it). kScaled: int8 rows with per-row (k, v) bf16
// scales folded into the score and the probability. Lane elements e with
// lane * EPL + e >= D are idle (zero).
template <typename R, typename Q, bool kScaled, int D>
__device__ __forceinline__ void attend_rows(
    const R* __restrict__ base, int stride,
    const __nv_bfloat16* __restrict__ scales, int lo, int hi, int warp,
    int lane, int koff, int voff, const float (&qv)[(D + 31) / 32],
    float& m, float& l, float (&acc)[(D + 31) / 32]) {
  constexpr int EPL = (D + 31) / 32;
  for (int s0 = lo + warp; s0 < hi; s0 += kWarps * kBatch) {
    float kf[kBatch][EPL], vf[kBatch][EPL], ks[kBatch], vs[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int s = min(s0 + r * kWarps, hi - 1);  // past hi: a dummy load
      const R* row = base + (size_t)s * stride;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const bool live = lane * EPL + e < D;
        kf[r][e] = live ? to_f32(from_f32<Q>(to_f32(row[koff + e]))) : 0.f;
        vf[r][e] = live ? to_f32(from_f32<Q>(to_f32(row[voff + e]))) : 0.f;
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

// The f32 and mixed-dtype entries: one block per (query head, batch row).
// Reads rows [pad, bnd) from the cache, for int8 caches rows
// [max(pad, bnd), pos) from the tail, and row pos from kv_new (rounded to
// the cache dtype for bf16/f32 caches, as the cache would hold it).
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kv_new,
                   C* __restrict__ cache, __nv_bfloat16* __restrict__ scales,
                   T* __restrict__ tail, const int* __restrict__ pos,
                   const int* __restrict__ pad, T* __restrict__ out, int S,
                   int H, int H_kv, float scale) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int EPL = (D + 31) / 32;
  using Round = typename std::conditional<kInt8, T, C>::type;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * EPL];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = H * D, f_kv = H_kv * D, row = 2 * f_kv;
  const int rep = H / H_kv, kvh = h / rep;
  const int p = pos[b];
  const int pd = pad == nullptr ? 0 : pad[b];
  const int j = p % kTail;
  const int bnd = kInt8 ? p - j : p;
  const T* new_b = kv_new + (size_t)b * row;

  // the insert: row pos of this kv head, by the kv head's first block
  if (h % rep == 0) {
    for (int i = threadIdx.x; i < 2 * D; i += kWarps * 32) {
      const int off = (i / D) * f_kv + kvh * D + i % D;
      if constexpr (kInt8)
        tail[((size_t)b * kTail + j) * row + off] = new_b[off];
      else
        cache[((size_t)b * S + p) * row + off] =
            from_f32<C>(to_f32(new_b[off]));
    }
  }
  if constexpr (kInt8) {  // the flush: this block's share of the 64 tasks
    if (j == kTail - 1)
      for (int task = h + H * warp; task < 2 * kTail; task += H * kWarps)
        flush_task<T>(tail + (size_t)b * kTail * row, new_b,
                      cache + ((size_t)b * S + bnd) * row,
                      scales + ((size_t)b * S + bnd) * 2, task, f_kv, lane);
  }

  const int koff = kvh * D + lane * EPL;
  const int voff = f_kv + koff;
  float qv[EPL], acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qv[e] = lane * EPL + e < D
                ? to_f32(q[(size_t)b * f + h * D + lane * EPL + e]) * scale
                : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  attend_rows<C, float, kInt8, D>(
      cache + (size_t)b * S * row, row,
      kInt8 ? scales + (size_t)b * S * 2 : nullptr, pd, bnd, warp, lane,
      koff, voff, qv, m, l, acc);
  if constexpr (kInt8)
    attend_rows<T, T, false, D>(tail + (size_t)b * kTail * row, row,
                                nullptr, max(pd, bnd) - bnd, j, warp, lane,
                                koff, voff, qv, m, l, acc);
  if (p >= pd)
    attend_rows<T, Round, false, D>(new_b, row, nullptr, 0, 1, warp, lane,
                                    koff, voff, qv, m, l, acc);

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
    if (lane * EPL + e < D)
      out[(size_t)b * f + h * D + lane * EPL + e] =
          from_f32<T>(l_all > 0.f ? o[e] / l_all : 0.f);
}

template <typename T, typename C>
cudaError_t launch(const void* q, const void* kv_new, void* cache,
                   void* scales, void* tail, const void* pos, const void* pad,
                   void* out, int B, int S, int H, int H_kv, int D,
                   float scale, void* stream) {
  if (B < 1 || H_kv < 1 || H % H_kv != 0 ||
      (std::is_same<C, int8_t>::value && S % kTail != 0))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_ATTN(DD)                                                      \
  if (D == DD) {                                                             \
    decode_attn_kernel<T, C, DD><<<grid, kWarps * 32, 0, st>>>(              \
        static_cast<const T*>(q), static_cast<const T*>(kv_new),             \
        static_cast<C*>(cache), static_cast<__nv_bfloat16*>(scales),         \
        static_cast<T*>(tail), static_cast<const int*>(pos),                 \
        static_cast<const int*>(pad), static_cast<T*>(out), S, H, H_kv,      \
        scale);                                                              \
    return cudaGetLastError();                                               \
  }
  DECODE_ATTN(64)
  DECODE_ATTN(100)
  DECODE_ATTN(128)
#undef DECODE_ATTN
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 q, int8 cache: the tensor-core kernel. Pointers: q [B, F], kv_new
// [B, 2 F_kv], cache int8 [B, S, 2 F_kv], scales bf16 [B, S, 2], tail bf16
// [B, 32, 2 F_kv], pos [B] int32, prefix_pad [B] int32 (may be null), out
// [B, F]; nq query heads a block and nsplit blocks a cluster from
// ops/attention.py (chunk_geometry with int8=True). Returns
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" cudaError_t decode_attention_bf16_int8(
    const void* q, const void* kv_new, void* cache, void* scales, void* tail,
    const void* pos, const void* pad, void* out, int B, int S, int H,
    int H_kv, int D, int nq, int nsplit, float scale, void* stream) {
  attn_mma::MmaArgs a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv_new = static_cast<const __nv_bfloat16*>(kv_new);
  a.cache = cache;
  a.scales = static_cast<__nv_bfloat16*>(scales);
  a.tail = static_cast<__nv_bfloat16*>(tail);
  a.pos = static_cast<const int*>(pos);
  a.pad = static_cast<const int*>(pad);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.C = 1;
  a.S = S;
  a.H = H;
  a.H_kv = H_kv;
  a.scale_log2 = scale * 1.4426950408889634f;
  return attn_mma::launch_any<true>(a, B, D, nq, nsplit, stream);
}

// The CUDA-core entries, one per (compute dtype, cache dtype). Pointers: q,
// kv_new, cache, scales (int8 only, else null), tail (int8 only, else
// null), pos, prefix_pad (may be null), out.
#define DECODE_ATTENTION_ENTRY(NAME, T, C)                                    \
  extern "C" cudaError_t NAME(const void* q, const void* kv_new, void* cache, \
                              void* scales, void* tail, const void* pos,      \
                              const void* pad, void* out, int B, int S,       \
                              int H, int H_kv, int D, float scale,            \
                              void* stream) {                                 \
    return launch<T, C>(q, kv_new, cache, scales, tail, pos, pad, out, B, S,  \
                        H, H_kv, D, scale, stream);                           \
  }

DECODE_ATTENTION_ENTRY(decode_attention_bf16_f32, __nv_bfloat16, float)
DECODE_ATTENTION_ENTRY(decode_attention_f32_f32, float, float)
DECODE_ATTENTION_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DECODE_ATTENTION_ENTRY(decode_attention_f32_int8, float, int8_t)

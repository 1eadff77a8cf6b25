// Chunk decode attention for one layer: C query rows per batch row, with an
// in-place KV cache (speculative decoding's verify, C = k + 1, and its draft
// steps, C = 1).
//
// Replaces the Pallas kernel llamagen_tpu/ops/chunk_attention.py::
// chunk_decode_attention (body `_chunk_attn_kernel`, pallas_call at
// chunk_attention.py:315). Semantics:
//   - the chunk's k|v rows are written into the cache at pos[b] + i, i < C;
//   - query c of row b attends, with an f32 online softmax, to cache rows
//     prefix_pad[b] <= s <= pos[b] + c (causal inside the chunk), query head
//     h reading kv head h / (H / H_kv) (GQA);
//   - bf16 / f32 caches. The cache is the only state, so positions may move
//     backward between calls (a rejected proposal): rows >= pos are simply
//     overwritten. The TPU kernel's aligned epoch tiles exist because Mosaic
//     cannot write single rows; this kernel writes single rows.
// The cache layout is the JAX one: [B, S, 2 * F_kv], k in [0, F_kv), v in
// [F_kv, 2 * F_kv).
//
// What bounds it on the H100: reading the cache, rows [pad, pos + C) of
// each kv head once for all C queries; at GPT-L (B = 16, 16 heads,
// head_dim 64, bf16, pos ~288) ~19 MB per layer and verify, ~6 us at
// 3.35 TB/s. Flops are ~2 C per byte, far below the tensor-core line.
//
// bf16 q with a bf16 cache (the main path: the verify, C = 5, and the
// draft's steps, C = 1) runs the tensor-core kernel of attention_mma.cuh,
// one launch per call with the insert folded in (its notes there). Decode
// attention's bf16 entry (K1) runs the same kernel at C = 1.
// The f32 and mixed-dtype entries (the greedy f32 check) keep the CUDA-core
// kernel below (`chunk_attn_kernel`) after a separate insert launch: there
// every head's block reads the rows the chunk inserts, so the insert runs
// first, on the same stream. One block per (query head, batch row), lanes
// across head_dim (head_dim 64, 100 or 128: EPL = ceil(D / 32) lanes' worth
// a lane, the lanes past D idle), C online-softmax states per warp, the
// eight warps merged at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "attention_mma.cuh"

namespace {

using namespace kutil;
using attn_mma::kMaxChunk;

constexpr int kWarps = 8;
constexpr int kBatch = 4;     // rows a warp loads before it uses them

// cache[b, pos[b] + i] = kv_new[b, i] (converted to the cache type), i < C;
// rows past the cache's end are not written (the wrapper checks positions
// it knows on the host).
template <typename T, typename Cc>
__global__ void insert_kernel(const T* __restrict__ kv_new,
                              Cc* __restrict__ cache,
                              const int* __restrict__ pos, int C, int S,
                              int row) {
  const int b = blockIdx.x;
  for (int i = 0; i < C; ++i) {
    const int s = pos[b] + i;
    if (s < 0 || s >= S) continue;
    Cc* dst = cache + ((size_t)b * S + s) * row;
    const T* src = kv_new + ((size_t)b * C + i) * row;
    for (int e = threadIdx.x; e < row; e += blockDim.x)
      dst[e] = from_f32<Cc>(to_f32(src[e]));
  }
}

// One block per (query head, batch row); EPL = ceil(head_dim / 32)
// elements per lane (lane elements past head_dim are idle); kC >= C query
// rows held per warp (the rows past C are idle).
template <typename T, typename Cc, int D, int kC>
__global__ void __launch_bounds__(kWarps * 32)
chunk_attn_kernel(const T* __restrict__ q, const Cc* __restrict__ cache,
                  const int* __restrict__ pos, const int* __restrict__ pad,
                  T* __restrict__ out, int C, int S, int H, int H_kv,
                  float scale) {
  constexpr int EPL = (D + 31) / 32;
  __shared__ float sm_m[kWarps][kC], sm_l[kWarps][kC];
  __shared__ float sm_acc[kWarps][kC][32 * EPL];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = H * D, f_kv = H_kv * D, row = 2 * f_kv;
  const int kvh = h / (H / H_kv);
  const int p = pos[b];
  const int pd = pad == nullptr ? 0 : pad[b];
  const int hi = min(p + C, S);  // rows [pd, hi) are read
  const int koff = kvh * D + lane * EPL;
  const int voff = f_kv + koff;

  float qv[kC][EPL], acc[kC][EPL], m[kC], l[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qv[c][e] = c < C && lane * EPL + e < D
                     ? to_f32(q[((size_t)b * C + c) * f + h * D +
                                lane * EPL + e]) * scale
                     : 0.f;
      acc[c][e] = 0.f;
    }
    m[c] = -INFINITY;
    l[c] = 0.f;
  }

  const Cc* base = cache + (size_t)b * S * row;
  for (int s0 = pd + warp; s0 < hi; s0 += kWarps * kBatch) {
    float kf[kBatch][EPL], vf[kBatch][EPL];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int s = min(s0 + r * kWarps, hi - 1);  // past hi: a dummy load
      const Cc* rp = base + (size_t)s * row;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const bool live = lane * EPL + e < D;
        kf[r][e] = live ? to_f32(rp[koff + e]) : 0.f;
        vf[r][e] = live ? to_f32(rp[voff + e]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int s = s0 + r * kWarps;
      if (s >= hi) break;  // the same for the whole warp
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= C || s > p + c) continue;  // query c sees rows <= p + c
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qv[c][e] * kf[r][e];
        dot = warp_sum(dot);
        const float m_new = fmaxf(m[c], dot);
        const float alpha = expf(m[c] - m_new);
        const float pr = expf(dot - m_new);
        l[c] = l[c] * alpha + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[c][e] = acc[c][e] * alpha + pr * vf[r][e];
        m[c] = m_new;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (lane == 0) {
      sm_m[warp][c] = m[c];
      sm_l[warp][c] = l[c];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][c][lane * EPL + e] = acc[c][e];
  }
  __syncthreads();
  // warp c merges query row c's eight partial states (kC <= kWarps)
  if (warp >= C) return;
  const int c = warp;
  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w][c]);
  float l_all = 0.f, o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no row has m = -inf and contributes nothing
    const float sc = sm_m[w][c] == -INFINITY ? 0.f : expf(sm_m[w][c] - m_all);
    l_all += sm_l[w][c] * sc;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] += sm_acc[w][c][lane * EPL + e] * sc;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    if (lane * EPL + e < D)
      out[((size_t)b * C + c) * f + h * D + lane * EPL + e] =
          from_f32<T>(l_all > 0.f ? o[e] / l_all : 0.f);
}

template <typename T, typename Cc, int D>
void launch_attn(const void* q, const void* cache, const int* pos,
                 const int* pad, void* out, int B, int C, int S, int H,
                 int H_kv, float scale, cudaStream_t st) {
  const dim3 grid(H, B);
  const T* qt = static_cast<const T*>(q);
  const Cc* ct = static_cast<const Cc*>(cache);
  T* ot = static_cast<T*>(out);
  if (C == 1)
    chunk_attn_kernel<T, Cc, D, 1><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
  else if (C == 2)
    chunk_attn_kernel<T, Cc, D, 2><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
  else if (C <= 4)
    chunk_attn_kernel<T, Cc, D, 4><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
  else
    chunk_attn_kernel<T, Cc, D, 8><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
}

template <typename T, typename Cc>
cudaError_t launch(const void* q, const void* kv_new, void* cache,
                   const void* pos_v, const void* pad_v, void* out, int B,
                   int C, int S, int H, int H_kv, int D, float scale,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(pos_v);
  const int* pad = static_cast<const int*>(pad_v);
  if ((D != 64 && D != 100 && D != 128) || H % H_kv != 0 || C < 1 ||
      C > kMaxChunk)
    return cudaErrorInvalidValue;
  insert_kernel<T, Cc><<<B, 256, 0, st>>>(static_cast<const T*>(kv_new),
                                          static_cast<Cc*>(cache), pos, C, S,
                                          2 * H_kv * D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (D == 64)
    launch_attn<T, Cc, 64>(q, cache, pos, pad, out, B, C, S, H, H_kv, scale,
                           st);
  else if (D == 100)
    launch_attn<T, Cc, 100>(q, cache, pos, pad, out, B, C, S, H, H_kv,
                            scale, st);
  else
    launch_attn<T, Cc, 128>(q, cache, pos, pad, out, B, C, S, H, H_kv,
                            scale, st);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, bf16 cache: pointers as for the entries below; nq query heads a
// block and nsplit blocks a cluster, from ops/chunk_attention.py::
// chunk_geometry (attn_mma::launch_any lists what it takes). Returns
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" cudaError_t chunk_attention_bf16_bf16(
    const void* q, const void* kv_new, void* cache, const void* pos,
    const void* pad, void* out, int B, int C, int S, int H, int H_kv, int D,
    int nq, int nsplit, float scale, void* stream) {
  attn_mma::MmaArgs a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv_new = static_cast<const __nv_bfloat16*>(kv_new);
  a.cache = cache;
  a.pos = static_cast<const int*>(pos);
  a.pad = static_cast<const int*>(pad);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.C = C;
  a.S = S;
  a.H = H;
  a.H_kv = H_kv;
  a.scale_log2 = scale * 1.4426950408889634f;
  return attn_mma::launch_any<false>(a, B, D, nq, nsplit, stream);
}

// The other (compute dtype, cache dtype) entries. Pointers: q [B, C, F],
// kv_new [B, C, 2 F_kv] (in q's dtype), cache [B, S, 2 F_kv], pos [B] int32,
// prefix_pad [B] int32 (may be null), out [B, C, F].
#define CHUNK_ATTENTION_ENTRY(NAME, T, Cc)                                    \
  extern "C" cudaError_t NAME(const void* q, const void* kv_new, void* cache, \
                              const void* pos, const void* pad, void* out,    \
                              int B, int C, int S, int H, int H_kv, int D,    \
                              float scale, void* stream) {                    \
    return launch<T, Cc>(q, kv_new, cache, pos, pad, out, B, C, S, H, H_kv,   \
                         D, scale, stream);                                   \
  }

CHUNK_ATTENTION_ENTRY(chunk_attention_bf16_f32, __nv_bfloat16, float)
CHUNK_ATTENTION_ENTRY(chunk_attention_f32_f32, float, float)
CHUNK_ATTENTION_ENTRY(chunk_attention_f32_bf16, float, __nv_bfloat16)

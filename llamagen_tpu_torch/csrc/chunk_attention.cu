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
// draft's steps, C = 1) runs `chunk_mma_kernel`, one launch per call:
//   - Split over rows (flash-decoding): a cluster of `nsplit` blocks per
//     (batch row, group of NQ query heads of one kv head) cuts
//     [pad, pos + C) into equal pieces of a multiple of 16 rows, as many
//     pieces as it takes to give every SM a block (at GPT-L, B * H = 256
//     blocks already do: one piece); each block streams its piece in
//     64-row tiles of k and v through a three-stage `cp.async` ring
//     (16-byte copies, 128-byte XOR swizzle). A piece past pos + C sees no
//     row and merges as nothing.
//   - The insert is folded in: a block takes rows s >= pos from kv_new (in
//     the cache dtype, as the JAX kernel's kv_new.astype(cache dtype)), not
//     from the cache, and the first block of each (batch row, kv head)
//     writes those rows into the cache. No block of the launch reads a
//     cache row that the launch writes, so no second launch is needed.
//   - Scores on `mma.sync.m16n8k16`: S^T = K Q^T with 16 keys on M and the
//     C <= 8 queries of one head on N (one n-tile per head of the group);
//     the softmax scale multiplies the f32 accumulator. Each query column's
//     running max costs three shuffles per 16-key tile; the row sums stay
//     per lane until the end.
//   - Output on `mma.sync`: O^T += V^T P^T, V^T from `ldmatrix.trans`, P^T
//     from the score accumulator by `movmatrix.trans`. p is rounded to bf16
//     for this product (the JAX kernel keeps p in f32; the row sum uses the
//     f32 p): one rounding more than the reference, inside the card
//     tolerance of 4 bf16 ulps of the largest output.
//   - The (max, sum, accumulator) states of a block's warps are merged in
//     its shared memory; with more than one split, the blocks' states are
//     merged through distributed shared memory in the same launch.
// The f32 and mixed-dtype entries (the greedy f32 check) keep the CUDA-core
// kernel below (`chunk_attn_kernel`) after a separate insert launch: there
// every head's block reads the rows the chunk inserts, so the insert runs
// first, on the same stream. One block per (query head, batch row), lanes
// across head_dim, C online-softmax states per warp, the eight warps
// merged at the end.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kBatch = 4;     // rows a warp loads before it uses them
constexpr int kMaxChunk = 8;  // query rows per batch row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// One block per (query head, batch row); EPL = head_dim / 32 elements per
// lane; kC >= C query rows held per warp (the rows past C are idle).
template <typename T, typename Cc, int EPL, int kC>
__global__ void __launch_bounds__(kWarps * 32)
chunk_attn_kernel(const T* __restrict__ q, const Cc* __restrict__ cache,
                  const int* __restrict__ pos, const int* __restrict__ pad,
                  T* __restrict__ out, int C, int S, int H, int H_kv,
                  float scale) {
  constexpr int D = 32 * EPL;
  __shared__ float sm_m[kWarps][kC], sm_l[kWarps][kC];
  __shared__ float sm_acc[kWarps][kC][D];

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
      qv[c][e] = c < C ? to_f32(q[((size_t)b * C + c) * f + h * D +
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
        kf[r][e] = to_f32(rp[koff + e]);
        vf[r][e] = to_f32(rp[voff + e]);
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
    out[((size_t)b * C + c) * f + h * D + lane * EPL + e] =
        from_f32<T>(l_all > 0.f ? o[e] / l_all : 0.f);
}

template <typename T, typename Cc, int EPL>
void launch_attn(const void* q, const void* cache, const int* pos,
                 const int* pad, void* out, int B, int C, int S, int H,
                 int H_kv, float scale, cudaStream_t st) {
  const dim3 grid(H, B);
  const T* qt = static_cast<const T*>(q);
  const Cc* ct = static_cast<const Cc*>(cache);
  T* ot = static_cast<T*>(out);
  if (C == 1)
    chunk_attn_kernel<T, Cc, EPL, 1><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
  else if (C == 2)
    chunk_attn_kernel<T, Cc, EPL, 2><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
  else if (C <= 4)
    chunk_attn_kernel<T, Cc, EPL, 4><<<grid, kWarps * 32, 0, st>>>(
        qt, ct, pos, pad, ot, C, S, H, H_kv, scale);
  else
    chunk_attn_kernel<T, Cc, EPL, 8><<<grid, kWarps * 32, 0, st>>>(
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
  if ((D != 64 && D != 128) || H % H_kv != 0 || C < 1 || C > kMaxChunk)
    return cudaErrorInvalidValue;
  insert_kernel<T, Cc><<<B, 256, 0, st>>>(static_cast<const T*>(kv_new),
                                          static_cast<Cc*>(cache), pos, C, S,
                                          2 * H_kv * D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (D == 64)
    launch_attn<T, Cc, 2>(q, cache, pos, pad, out, B, C, S, H, H_kv, scale,
                          st);
  else
    launch_attn<T, Cc, 4>(q, cache, pos, pad, out, B, C, S, H, H_kv, scale,
                          st);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 q, bf16 cache: tensor cores, split over rows, the insert folded in.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;         // 16 keys of each 64-row tile a warp
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTile = 16 * kMmaWarps;
constexpr int kStages = 3;
constexpr int kMaxSplit = 8;         // blocks per cluster
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t v) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(v));
  return d;
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(
             __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// Shared memory of one block: the k and v ring, or (after the loop, in the
// same bytes) the (max, sum, accumulator) states of the warps and of the
// block. Mirrored by ops/chunk_attention.py::_smem_bytes.
__host__ __device__ constexpr int mma_smem_bytes(int D, int NQ) {
  return (2 * kStages * kTile * D * 2) >
                 ((kMmaWarps + 1) * NQ * 8 * (D + 2) * 4)
             ? 2 * kStages * kTile * D * 2
             : (kMmaWarps + 1) * NQ * 8 * (D + 2) * 4;
}

// Rows [lo, hi) of the split `split` of `nsplit`: [pad, min(pos + C, S)) in
// equal pieces of a multiple of 16 rows (ops/chunk_attention.py::
// chunk_split_rows).
__device__ __forceinline__ int2 split_rows(int pos, int pad, int C, int S,
                                           int split, int nsplit) {
  const int end = min(pos + C, S);
  const int total = max(0, end - pad);
  const int per = ((total + nsplit - 1) / nsplit + 15) & ~15;
  const int lo = pad + split * per;
  return make_int2(lo, min(end, lo + per));
}

// grid (nsplit, H / NQ, B), cluster (nsplit, 1, 1): block (split, group, b)
// holds query heads [NQ group, NQ group + NQ) (one kv head) of batch row b
// and rows split_rows(...) of that kv head.
template <int D, int NQ>
__global__ void __launch_bounds__(kMmaThreads)
chunk_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv_new,
                 __nv_bfloat16* __restrict__ cache,
                 const int* __restrict__ pos_p, const int* __restrict__ pad_p,
                 __nv_bfloat16* __restrict__ out, int C, int S, int H,
                 int H_kv, float scale_log2) {
  constexpr int KS = D / 16;     // k16 steps over head_dim; d-tiles of O^T
  constexpr int CH = D / 8;      // 16-byte chunks of one row's k (or v)
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h0 = blockIdx.y * NQ, b = blockIdx.z;
  const int rep = H / H_kv, kvh = h0 / rep;
  const int F = H * D, f_kv = H_kv * D, row = 2 * f_kv;
  const int p = pos_p[b], pd = pad_p == nullptr ? 0 : pad_p[b];
  const int2 rng = split_rows(p, pd, C, S, split, nsplit);
  const int lo = rng.x, hi = rng.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // The insert: rows pos .. pos + C - 1 of this kv head, written by the
  // first block of the kv head's first query group (no block reads them
  // from the cache).
  if (split == 0 && h0 % rep == 0) {
    for (int i = tid; i < C * 2 * CH; i += kMmaThreads) {
      const int c = i / (2 * CH), part = (i / CH) % 2, ch = i % CH;
      const int s = p + c;
      if (s < 0 || s >= S) continue;
      const int off = part * f_kv + kvh * D + ch * 8;
      *reinterpret_cast<uint4*>(cache + (static_cast<size_t>(b) * S + s) *
                                            row + off) =
          *reinterpret_cast<const uint4*>(
              kv_new + (static_cast<size_t>(b) * C + c) * row + off);
    }
  }

  __nv_bfloat16* ks_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs_s = ks_s + kStages * kTile * D;
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int own_end = min(p, hi);  // rows below come from the cache
  auto load_tile = [&](int i) {
    __nv_bfloat16* kd = ks_s + (i % kStages) * kTile * D;
    __nv_bfloat16* vd = vs_s + (i % kStages) * kTile * D;
    for (int e = tid; e < kTile * 2 * CH; e += kMmaThreads) {
      const int r = e / (2 * CH), part = (e / CH) % 2, ch = e % CH;
      const int s = lo + i * kTile + r;
      const int off = part * f_kv + kvh * D + ch * 8;
      const __nv_bfloat16* src = cache;
      int bytes = 16;
      if (s < own_end)
        src = cache + (static_cast<size_t>(b) * S + s) * row + off;
      else if (s < hi)
        src = kv_new + (static_cast<size_t>(b) * C + (s - p)) * row + off;
      else
        bytes = 0;  // past the piece: zeros, masked below
      cp_async16((part ? vd : kd) + r * D + ((ch ^ (r & 7)) * 8), src,
                 bytes);
    }
  };

  // B fragments of Q^T: query g of head h0 + j, head_dim 16 kk + 2t (+8).
  uint32_t qf[NQ][KS][2];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          q + (static_cast<size_t>(b) * C + g) * F + (h0 + j) * D + 16 * kk +
          2 * t);
      qf[j][kk][0] = g < C ? qp[0] : 0u;
      qf[j][kk][1] = g < C ? qp[4] : 0u;
    }

  // per lane: query columns 2t, 2t + 1 of each head; O^T rows (head_dim)
  // 16 dt + g (+8)
  float m[NQ][2], l[NQ][2], acc[NQ][KS][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    m[j][0] = m[j][1] = -INFINITY;
    l[j][0] = l[j][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt)
      acc[j][dt][0] = acc[j][dt][1] = acc[j][dt][2] = acc[j][dt][3] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int r0 = 16 * warp;              // the warp's keys in the tile
    const int key0 = lo + i * kTile + r0;  // its first key
    if (key0 < hi) {
      const __nv_bfloat16* kt = ks_s + (i % kStages) * kTile * D;
      const __nv_bfloat16* vt = vs_s + (i % kStages) * kTile * D;
      float sc[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      {  // S^T = K Q^T: A = 16 keys x 16 head_dim from ldmatrix
        const int rr = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int ch = 2 * kk + (lane >> 4);
          uint32_t a[4];
          ldmatrix_x4(a, kt + rr * D + ((ch ^ (rr & 7)) * 8));
#pragma unroll
          for (int j = 0; j < NQ; ++j) mma(sc[j], a, qf[j][kk][0], qf[j][kk][1]);
        }
      }
      uint32_t pb[NQ][2];  // P^T B fragments
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float pr[4];
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = 2 * t + qq;
          float s0 = sc[j][qq] * scale_log2, s1 = sc[j][qq + 2] * scale_log2;
          if (c >= C || key0 + g >= hi || key0 + g > p + c) s0 = -INFINITY;
          if (c >= C || key0 + g + 8 >= hi || key0 + g + 8 > p + c)
            s1 = -INFINITY;
          float mx = fmaxf(s0, s1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[j][qq], mx);
          const float m_ref = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m[j][qq] - m_ref);
          pr[qq] = exp2f(s0 - m_ref);
          pr[qq + 2] = exp2f(s1 - m_ref);
          l[j][qq] = l[j][qq] * alpha + pr[qq] + pr[qq + 2];
          m[j][qq] = m_new;
#pragma unroll
          for (int dt = 0; dt < KS; ++dt) {
            acc[j][dt][qq] *= alpha;
            acc[j][dt][qq + 2] *= alpha;
          }
        }
        pb[j][0] = movmatrix_trans(pack_bf16(pr[0], pr[1]));  // keys 2t, +1
        pb[j][1] = movmatrix_trans(pack_bf16(pr[2], pr[3]));  // keys 8 + 2t
      }
      {  // O^T += V^T P^T: A = 16 head_dim x 16 keys from ldmatrix.trans
        const int rr = r0 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          const int ch = 2 * dt + ((lane >> 3) & 1);
          uint32_t a[4];
          ldmatrix_x4_trans(a, vt + rr * D + ((ch ^ (rr & 7)) * 8));
#pragma unroll
          for (int j = 0; j < NQ; ++j) mma(acc[j][dt], a, pb[j][0], pb[j][1]);
        }
      }
    }
    __syncthreads();  // the stage is refilled in the next round
  }
  cp_async_wait<0>();
  __syncthreads();

  // Each warp's states into shared memory (over the ring): the row sums
  // summed over the lanes that share a query column first.
  constexpr int QC = NQ * 8;                       // query columns
  float* st_m = reinterpret_cast<float*>(smem);    // [warp][QC]
  float* st_l = st_m + kMmaWarps * QC;             // [warp][QC]
  float* st_a = st_l + kMmaWarps * QC;             // [warp][QC][D]
  float* bk_m = st_a + kMmaWarps * QC * D;         // the block's [QC]
  float* bk_l = bk_m + QC;                         // [QC]
  float* bk_a = bk_l + QC;                         // [QC][D]
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      float s = l[j][qq];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int col = 8 * j + 2 * t + qq;
      if (g == 0) {
        st_m[warp * QC + col] = m[j][qq];
        st_l[warp * QC + col] = s;
      }
#pragma unroll
      for (int dt = 0; dt < KS; ++dt) {
        float* a = st_a + (warp * QC + col) * D + 16 * dt + g;
        a[0] = acc[j][dt][qq];
        a[8] = acc[j][dt][qq + 2];
      }
    }
  __syncthreads();

  // The block's state per (query column, head_dim): the warps merged; a
  // warp that saw no row has max -inf and adds nothing. With one split it
  // is the output.
  for (int u = tid; u < QC * D; u += kMmaThreads) {
    const int d = u % D, col = u / D, c = col % 8;
    if (c >= C) continue;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) m_all = fmaxf(m_all, st_m[w * QC + col]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float mw = st_m[w * QC + col];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - m_all);
      l_all += st_l[w * QC + col] * f;
      o += st_a[(w * QC + col) * D + d] * f;
    }
    if (nsplit == 1) {
      out[(static_cast<size_t>(b) * C + c) * F + (h0 + col / 8) * D + d] =
          __float2bfloat16_rn(l_all > 0.f ? o / l_all : 0.f);
    } else {
      if (d == 0) {
        bk_m[col] = m_all;
        bk_l[col] = l_all;
      }
      bk_a[col * D + d] = o;
    }
  }
  if (nsplit == 1) return;
  cluster.sync();

  // Merge the cluster's nsplit block states through distributed shared
  // memory; a split that saw no row adds nothing.
  for (int u = split * kMmaThreads + tid; u < NQ * C * D;
       u += nsplit * kMmaThreads) {
    const int d = u % D, c = (u / D) % C, j = u / (D * C);
    const int col = 8 * j + c;
    float m_all = -INFINITY;
    for (int r = 0; r < nsplit; ++r)
      m_all = fmaxf(m_all, *cluster.map_shared_rank(bk_m + col, r));
    float l_all = 0.f, o = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float mr = *cluster.map_shared_rank(bk_m + col, r);
      const float f = mr == -INFINITY ? 0.f : exp2f(mr - m_all);
      l_all += *cluster.map_shared_rank(bk_l + col, r) * f;
      o += *cluster.map_shared_rank(bk_a + col * D + d, r) * f;
    }
    out[(static_cast<size_t>(b) * C + c) * F + (h0 + j) * D + d] =
        __float2bfloat16_rn(l_all > 0.f ? o / l_all : 0.f);
  }
  cluster.sync();  // no block leaves while its state is read
}

template <int D, int NQ>
cudaError_t launch_mma(const void* q, const void* kv_new, void* cache,
                       const int* pos, const int* pad, void* out, int B,
                       int C, int S, int H, int H_kv, float scale,
                       int nsplit, cudaStream_t st) {
  auto kernel = chunk_mma_kernel<D, NQ>;
  constexpr int smem = mma_smem_bytes(D, NQ);
  static_assert(smem <= kMaxSmem, "shared memory");
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, H / NQ, B);
  cfg.blockDim = dim3(kMmaThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv_new),
      static_cast<__nv_bfloat16*>(cache), pos, pad,
      static_cast<__nv_bfloat16*>(out), C, S, H, H_kv,
      scale * 1.4426950408889634f);
}

cudaError_t launch_bf16(const void* q, const void* kv_new, void* cache,
                        const void* pos_v, const void* pad_v, void* out,
                        int B, int C, int S, int H, int H_kv, int D,
                        float scale, int nq, int nsplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(pos_v);
  const int* pad = static_cast<const int*>(pad_v);
  const auto ptr_ok = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (H_kv < 1 || H % H_kv != 0 || C < 1 || C > kMaxChunk || nq < 1 ||
      (H / H_kv) % nq != 0 || nsplit < 1 || nsplit > kMaxSplit ||
      !ptr_ok(q) || !ptr_ok(kv_new) || !ptr_ok(cache) || !ptr_ok(out))
    return cudaErrorInvalidValue;
#define CHUNK_MMA(DD, NN)                                                    \
  if (D == DD && nq == NN)                                                   \
    return launch_mma<DD, NN>(q, kv_new, cache, pos, pad, out, B, C, S, H,   \
                              H_kv, scale, nsplit, st);
  CHUNK_MMA(64, 1)
  CHUNK_MMA(64, 2)
  CHUNK_MMA(64, 4)
  CHUNK_MMA(128, 1)
  CHUNK_MMA(128, 2)
#undef CHUNK_MMA
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 q, bf16 cache: pointers as for the entries below; nq query heads a
// block (1, 2 or 4 at head_dim 64, 1 or 2 at 128, dividing H / H_kv) and
// nsplit blocks a cluster, from ops/chunk_attention.py::chunk_geometry.
// Returns cudaErrorInvalidValue for what the kernel does not take.
extern "C" cudaError_t chunk_attention_bf16_bf16(
    const void* q, const void* kv_new, void* cache, const void* pos,
    const void* pad, void* out, int B, int C, int S, int H, int H_kv, int D,
    int nq, int nsplit, float scale, void* stream) {
  return launch_bf16(q, kv_new, cache, pos, pad, out, B, C, S, H, H_kv, D,
                     scale, nq, nsplit, stream);
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

// K6: multi-head latent attention (DeepSeek-V2's MLA) at decode, absorbed,
// with an in-place latent cache (ops/mla_attention.py::mla_decode_attention;
// the JAX package has no latent attention, so it replaces no TPU kernel).
//
// Semantics, per batch row b with p = pos[b]:
//   - row p of the cache [B, S, R + P] is written with kv_new[b] (`[c_kv ‖
//     k_pe]`, the latent and the roped shared key);
//   - each of the 16 query heads scores rows [0, p] with its whole R + P
//     wide query (the absorbed nope part, then the rope part): s = (q_h ·
//     row) * scale; an f32 online softmax (base 2);
//   - out[b, h] = Σ p_h,s row_s[0:R] / Σ p_h,s, in bf16: the weighted sum of
//     the latent lanes, which W_UV maps to v-space after this call.
//
// What bounds it on the H100: reading rows [0, p) once per batch row, R + P
// bf16 lanes each (1,152 bytes at R 512, P 64), shared by the 16 heads. The
// products are ~30 flops a byte, far under the tensor-core line, so the
// design keeps whole tiles of rows in flight and runs the products on
// `mma.sync` out of shared memory.
//
// Order of work: one block of 4 warps per batch row. The block streams rows
// [0, p] in 64-row tiles through a two-stage `cp.async` ring (rows below p
// from the cache, row p from kv_new, zeros past it), the 16 heads' queries
// staged once beside the ring. Per tile:
//   1. scores, the heads on M (m16 = 16 heads): warp w takes keys 16 w ..
//      16 w + 15, S = Q Kᵀ over (R + P) / 16 k16 steps, A = the queries by
//      `ldmatrix`, B = the key rows by `ldmatrix`;
//   2. the tile's max per head over the 4 warps through shared memory; every
//      warp holds the same running max, so one rescale factor serves all;
//      p = 2^(s - max) rounded to bf16 into a [16 heads x 64 keys] tile;
//   3. O += P V, warp w owning latent lanes [w R / 4, (w + 1) R / 4): A = the
//      probabilities by `ldmatrix`, B = the rows' latent lanes by
//      `ldmatrix.trans`.
// The row sums stay per lane (f32 p, before the rounding) and are summed over
// the lanes and the warps at the end. The block writes row p first and never
// reads it back (it takes kv_new), and no other block touches batch row b,
// so the write races no read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "kernel_util.cuh"

namespace {

using namespace kutil;

constexpr int kHeads = 16;            // the m16 of the score product
constexpr int kRank = 512;            // latent lanes (kv_lora_rank)
constexpr int kRope = 64;             // rope lanes (qk_rope_head_dim)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;    // cache rows a tile
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;      // 227 KB, the H100's per-block limit

// bf16 lanes of a shared row: L + 8, so that the 8 rows of an ldmatrix
// (rows 16 bytes apart modulo 128) land in distinct banks
constexpr int kRowStride = kRank + kRope + 8;
constexpr int kPStride = kTile + 8;
constexpr int kSmemBytes = (kStages * kTile + kHeads) * kRowStride * 2 +
                           kHeads * kPStride * 2 + 2 * kWarps * kHeads * 4;

struct MlaArgs {
  const __nv_bfloat16* q;       // [B, 16, L]
  const __nv_bfloat16* kv_new;  // [B, L]
  __nv_bfloat16* cache;         // [B, S, L]
  const int* pos;               // [B]
  __nv_bfloat16* out;           // [B, 16, R]
  int S;
  float scale_log2;             // scale * log2(e)
};

__global__ void __launch_bounds__(kThreads) mla_decode_kernel(const MlaArgs a) {
  constexpr int R = kRank, L = kRank + kRope, LS = kRowStride, KS = L / 16;
  constexpr int CH = L / 8;                // 16-byte chunks of a row
  constexpr int WD = R / kWarps;           // latent lanes a warp owns
  constexpr int NT = WD / 8;               // their n8 tiles
  static_assert(L % 16 == 0 && WD % 16 == 0, "widths");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ring + kStages * kTile * LS;   // [16][LS]
  __nv_bfloat16* ps = qs + kHeads * LS;              // [16][kPStride]
  float* red = reinterpret_cast<float*>(ps + kHeads * kPStride);  // [4][16]
  float* sums = red + kWarps * kHeads;                            // [4][16]

  const int b = blockIdx.x, S = a.S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int p = a.pos[b];
  const __nv_bfloat16* new_b = a.kv_new + static_cast<size_t>(b) * L;
  __nv_bfloat16* rows_b = a.cache + static_cast<size_t>(b) * S * L;

  if (p >= 0 && p < S)  // the insert: row p of this batch row
    for (int c = tid; c < CH; c += kThreads)
      reinterpret_cast<uint4*>(rows_b + static_cast<size_t>(p) * L)[c] =
          reinterpret_cast<const uint4*>(new_b)[c];
  const int end = min(p + 1, S);  // rows [0, end)
  const int n_tiles = end > 0 ? (end + kTile - 1) / kTile : 0;

  // the queries, in the first group of copies
  const __nv_bfloat16* q_b = a.q + static_cast<size_t>(b) * kHeads * L;
  for (int c = tid; c < kHeads * CH; c += kThreads)
    cp_async<16>(qs + (c / CH) * LS + (c % CH) * 8, q_b + c * 8, 16);
  // tile i into its stage: rows below p from the cache, row p from kv_new,
  // zeros past it
  auto load_tile = [&](int i) {
    __nv_bfloat16* dst = ring + (i % kStages) * kTile * LS;
    for (int c = tid; c < kTile * CH; c += kThreads) {
      const int r = c / CH, u = c % CH, s = i * kTile + r;
      const __nv_bfloat16* src =
          s < p ? rows_b + static_cast<size_t>(s) * L + u * 8 : new_b + u * 8;
      cp_async<16>(dst + r * LS + u * 8, src, s <= p && s < end ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};  // heads g, g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt = ring + (i % kStages) * kTile * LS;

    // 1. S = Q Kᵀ for the warp's 16 keys: two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const __nv_bfloat16* qa = qs + (lane & 15) * LS + (lane >> 4) * 8;
      const __nv_bfloat16* kb =
          kt + (16 * warp + (lane & 7) + ((lane >> 4) << 3)) * LS +
          ((lane >> 3) & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, qa + 16 * kk);
        ldmatrix_x4(bf, kb + 16 * kk);
        mma(sc[0], af, bf[0], bf[1]);
        mma(sc[1], af, bf[2], bf[3]);
      }
    }
    // 2. the tile's max per head, the rescale, the probabilities
    const int key0 = i * kTile + 16 * warp;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t + (e & 1);
        sc[j][e] = key < end ? sc[j][e] * a.scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if (t == 0) {
      red[warp * kHeads + g] = mx[0];
      red[warp * kHeads + g + 8] = mx[1];
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m_new = m[h];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        m_new = fmaxf(m_new, red[w * kHeads + g + 8 * h]);
      // key 0 <= p lies in tile 0, so m_new is finite from the first tile
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p00 = exp2f(sc[j][0] - m[0]), p01 = exp2f(sc[j][1] - m[0]);
      const float p10 = exp2f(sc[j][2] - m[1]), p11 = exp2f(sc[j][3] - m[1]);
      l[0] = (j == 0 ? l[0] * alpha[0] : l[0]) + p00 + p01;
      l[1] = (j == 0 ? l[1] * alpha[1] : l[1]) + p10 + p11;
      const int col = 16 * warp + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + g * kPStride + col) =
          pack_bf16(p00, p01);
      *reinterpret_cast<uint32_t*>(ps + (g + 8) * kPStride + col) =
          pack_bf16(p10, p11);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    __syncthreads();

    // 3. O += P V over the tile's 64 keys, the warp's latent lanes
    {
      const __nv_bfloat16* pa = ps + (lane & 15) * kPStride + (lane >> 4) * 8;
      const __nv_bfloat16* vb = kt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LS +
                                warp * WD + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, pa + 16 * ks);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vb + 16 * ks * LS + 8 * n);
          mma(acc[n], af, bf[0], bf[1]);
          mma(acc[n + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the stage, the max and the probabilities are reused
  }
  cp_async_wait<0>();

  // the row sums over the lanes of a head, then over the warps
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (t == 0) {
    sums[warp * kHeads + g] = l[0];
    sums[warp * kHeads + g + 8] = l[1];
  }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sums[w * kHeads + g + 8 * h];
    inv[h] = s > 0.f ? 1.f / s : 0.f;
  }
  __nv_bfloat16* o_b = a.out + static_cast<size_t>(b) * kHeads * R;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int d = warp * WD + 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(o_b + g * R + d) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o_b + (g + 8) * R + d) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

static_assert(kSmemBytes <= kMaxSmem, "shared memory");

}  // namespace

// bf16 q [B, 16, R + P], kv_new [B, R + P], cache [B, S, R + P] (contiguous,
// row pos[b] written), pos int32 [B], out [B, 16, R]; (R, P) DeepSeek-V2's
// (512, 64).
extern "C" cudaError_t mla_decode_attention_bf16(
    const void* q, const void* kv_new, void* cache, const void* pos,
    void* out, int B, int S, int H, int R, int P, float scale, void* stream) {
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (B < 1 || S < 1 || H != kHeads || R != kRank || P != kRope ||
      !aligned(q) || !aligned(kv_new) || !aligned(cache) || !aligned(out))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  MlaArgs a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv_new = static_cast<const __nv_bfloat16*>(kv_new);
  a.cache = static_cast<__nv_bfloat16*>(cache);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.S = S;
  a.scale_log2 = scale * 1.4426950408889634f;
  mla_decode_kernel<<<B, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

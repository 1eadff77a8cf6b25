// The tensor-core attention kernel shared by decode attention (K1,
// csrc/decode_attention.cu) and chunk attention (K5, csrc/chunk_attention.cu):
// C <= 8 queries per batch row over an in-place KV cache, one launch.
//
//   - bf16 cache (K5's kernel; K1's bf16 q + bf16 cache entry runs it at
//     C = 1): rows [pad, pos) come from the cache, rows pos .. pos + C - 1
//     from kv_new, and the first block of each (batch row, kv head) writes
//     those rows into the cache. No block reads a cache row that the launch
//     writes.
//   - int8 cache (K1, C = 1): rows s < bnd = pos - pos % 32 are int8 with
//     per-row bf16 (k, v) scales, rows [bnd, pos) come exact from the 32-row
//     tail, row pos from kv_new. The first block of each (batch row, kv head)
//     writes its lanes of kv_new into tail row pos % 32. At pos % 32 == 31
//     the 32 rows are quantised into cache rows [bnd, bnd + 32): a (row,
//     half) pair is one task (its scale is taken over every kv head of that
//     half), the 64 tasks are spread over the blocks of the batch row, and a
//     task reads tail rows [bnd, pos) and row pos from kv_new. No block of
//     the launch reads tail row pos % 32, cache rows [bnd, bnd + 32) or
//     their scales, so none of these writes races a read.
//   - head_dim 64, 100 or 128. The cache layout [B, S, 2 F_kv] stays
//     unpadded: at head_dim 100 a head starts 200 bytes (bf16) or 100 bytes
//     (int8) into a row, so rows come in 8-byte (bf16) or 4-byte (int8)
//     copies into shared-memory rows of 120 bf16 lanes whose lanes
//     100..119 are zero, and the products run over 112 lanes (7 k16 steps).
//
// Order of work: a cluster of `nsplit` blocks per (batch row, group of NQ
// query heads of one kv head) splits [pad, pos + C) into pieces of a multiple
// of 16 rows (one piece unless B * H / NQ blocks leave SMs idle); a block
// streams its piece in 64-row tiles through a three-stage `cp.async` ring
// (int8: a deeper ring of int8 rows; each warp turns its 16 rows of a tile
// into bf16 in shared memory, every level +-127 exact in bf16, and reads
// the tile's exact rows from the tail and kv_new in the same pass); 4 warps take 16 keys of each tile; S^T = K Q^T on
// `mma.sync.m16n8k16` (keys on M, the C queries of each head on N), times the
// row's k scale (int8) and the softmax scale; an f32 online softmax in base 2
// per query column; O^T += V^T P^T with P^T from the score accumulator by
// `movmatrix.trans` and rounded to bf16 (int8: times the row's v scale
// first; the row sums keep the f32 p). The warps' and then the splits'
// (max, sum, accumulator) states are merged in shared memory and through
// distributed shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "kernel_util.cuh"

// A named namespace of inline functions and templates (each translation
// unit instantiates its own kernels: chunk_attention.cu the bf16 ones,
// decode_attention.cu the int8 ones).
namespace attn_mma {

namespace cg = cooperative_groups;
using namespace kutil;

constexpr int kTail = 32;            // exact int8 tail rows (JAX RECENT_INT8)
constexpr int kMmaWarps = 4;         // 16 keys of each 64-row tile a warp
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTile = 16 * kMmaWarps;
constexpr int kStages = 3;
constexpr int kMaxSplit = 8;         // blocks per cluster
constexpr int kMaxChunk = 8;         // queries per batch row
constexpr int kMaxSmem = 232448;     // 227 KB, the H100's per-block limit

// head_dim rounded up to whole k16 steps; bf16 lanes of a shared ring row
// (64 and 128: XOR-swizzled rows of head_dim lanes; 100: 120 lanes, so the
// 16-byte rows of an ldmatrix land in distinct banks)
__host__ __device__ constexpr int padded_dim(int D) {
  return (D + 15) / 16 * 16;
}
__host__ __device__ constexpr int ring_row(int D) {
  return D % 64 == 0 ? D : padded_dim(D) + 8;
}

// Stages of the int8 ring (a stage is a quarter of a bf16 one's bytes or
// less, so it runs deeper; 3 at head_dim 100 keeps 3 blocks an SM).
__host__ __device__ constexpr int int8_stages(int D) {
  return D % 64 == 0 ? 4 : 3;
}

// Shared memory of one block: the bf16 k and v ring (int8 caches: one bf16
// tile, and the int8 ring with one word of (k, v) scales a row), or, after
// the loop and in the same bytes, the (max, sum, accumulator) states of the
// warps and of the block. Mirrored by ops/chunk_attention.py::_smem_bytes.
__host__ __device__ constexpr int ring_bytes(int D, bool int8) {
  return int8 ? 2 * kTile * ring_row(D) * 2 +
                    int8_stages(D) * kTile * (2 * padded_dim(D) + 4)
              : 2 * kStages * kTile * ring_row(D) * 2;
}
__host__ __device__ constexpr int mma_smem_bytes(int D, int NQ, bool int8) {
  return ring_bytes(D, int8) >
                 (kMmaWarps + 1) * NQ * 8 * (padded_dim(D) + 2) * 4
             ? ring_bytes(D, int8)
             : (kMmaWarps + 1) * NQ * 8 * (padded_dim(D) + 2) * 4;
}

// One int8 flush task of batch row b: half `task % 2` of tail row
// r = task / 2 (row 31 taken from kv_new) quantised into cache row bnd + r
// (f32 math, scale max|half| / 127 + 1e-8 by IEEE division, x / scale
// rounded half to even, clipped to +-127; the scale stored as bf16): the
// JAX recent-window flush, bit for bit. One warp; tail_b, new_b: the batch
// row's tail and kv_new row; rows, scales: cache row bnd and its scales.
template <typename T>
__device__ void flush_task(const T* __restrict__ tail_b,
                           const T* __restrict__ new_b,
                           int8_t* __restrict__ rows,
                           __nv_bfloat16* __restrict__ scales, int task,
                           int f_kv, int lane) {
  const int r = task / 2, half = task % 2;
  const T* src =
      (r == kTail - 1 ? new_b : tail_b + static_cast<size_t>(r) * 2 * f_kv) +
      half * f_kv;
  float amax = 0.f;
  for (int i = lane; i < f_kv; i += 32)
    amax = fmaxf(amax, fabsf(to_f32(src[i])));
  amax = warp_max(amax);
  const float sc = amax / 127.0f + 1e-8f;
  int8_t* dst = rows + static_cast<size_t>(r) * 2 * f_kv + half * f_kv;
  for (int i = lane; i < f_kv; i += 32) {
    const float qv = rintf(to_f32(src[i]) / sc);
    dst[i] = static_cast<int8_t>(fminf(fmaxf(qv, -127.f), 127.f));
  }
  if (lane == 0) scales[r * 2 + half] = __float2bfloat16_rn(sc);
}

// Element offset of the 8-lane chunk `ch` of ring row r.
template <int D>
__device__ __forceinline__ int soff(int r, int ch) {
  if constexpr (D % 64 == 0)
    return r * D + ((ch ^ (r & 7)) * 8);
  else
    return r * ring_row(D) + ch * 8;
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

struct MmaArgs {
  const __nv_bfloat16* q;       // [B, C, F]
  const __nv_bfloat16* kv_new;  // [B, C, 2 F_kv]
  void* cache;                  // [B, S, 2 F_kv] bf16, or int8
  __nv_bfloat16* scales;        // int8: [B, S, 2] (k, v) row scales
  __nv_bfloat16* tail;          // int8: [B, 32, 2 F_kv] exact rows
  const int* pos;               // [B]
  const int* pad;               // [B] or null
  __nv_bfloat16* out;           // [B, C, F]
  int C, S, H, H_kv;
  float scale_log2;             // head_dim^-0.5 * log2(e)
};

// grid (nsplit, H / NQ, B), cluster (nsplit, 1, 1): block (split, group, b)
// holds query heads [NQ group, NQ group + NQ) (one kv head) of batch row b
// and rows split_rows(...) of that kv head.
template <int D, int NQ, bool kInt8>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const MmaArgs a) {
  constexpr int DP = padded_dim(D), KS = DP / 16, RR = ring_row(D);
  constexpr int VU = D % 8 == 0 ? 8 : 4;    // bf16 lanes a copy (16 or 8 B)
  constexpr int NU = D / VU;                // copies of one row's k (or v)
  constexpr int IU = D % 16 == 0 ? 16 : 4;  // int8 lanes a copy
  constexpr int NIU = D / IU;
  // int8: one bf16 tile, filled by the conversion pass from an int8 ring
  // of NS stages; bf16: a bf16 ring of NS stages filled by cp.async
  constexpr int NS = kInt8 ? int8_stages(D) : kStages;
  constexpr int BS = kInt8 ? 1 : kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int h0 = blockIdx.y * NQ, b = blockIdx.z;
  const int C = a.C, S = a.S, H = a.H;
  const int rep = H / a.H_kv, kvh = h0 / rep;
  const int F = H * D, f_kv = a.H_kv * D, row = 2 * f_kv;
  const int p = a.pos[b], pd = a.pad == nullptr ? 0 : a.pad[b];
  const int bnd = kInt8 ? p - p % kTail : p;  // rows below: the cache
  const int2 rng = split_rows(p, pd, C, S, split, nsplit);
  const int lo = rng.x, hi = rng.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* kv_new = a.kv_new;

  // The insert: rows pos .. pos + C - 1 of this kv head into the cache
  // (int8: row pos into tail row pos % 32), by the first block of the kv
  // head's first query group.
  if (split == 0 && h0 % rep == 0) {
    for (int i = tid; i < C * 2 * NU; i += kMmaThreads) {
      const int c = i / (2 * NU), part = (i / NU) % 2, u = i % NU;
      const int s = p + c;
      if (s < 0 || s >= S) continue;
      const int off = part * f_kv + kvh * D + u * VU;
      __nv_bfloat16* dst =
          kInt8 ? a.tail + (static_cast<size_t>(b) * kTail + s % kTail) *
                               row + off
                : static_cast<__nv_bfloat16*>(a.cache) +
                      (static_cast<size_t>(b) * S + s) * row + off;
      const __nv_bfloat16* src =
          kv_new + (static_cast<size_t>(b) * C + c) * row + off;
      if constexpr (VU == 8)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    }
  }

  __nv_bfloat16* ks_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs_s = ks_s + BS * kTile * RR;
  int8_t* k8 = reinterpret_cast<int8_t*>(vs_s + BS * kTile * RR);
  int8_t* v8 = k8 + NS * kTile * DP;
  uint32_t* sw = reinterpret_cast<uint32_t*>(v8 + NS * kTile * DP);
  if constexpr (D % 64 != 0) {  // lanes D .. RR - 1 of every ring row: zero
    constexpr int PU = (RR - D) / 4;
    for (int i = tid; i < 2 * BS * kTile * PU; i += kMmaThreads)
      *reinterpret_cast<uint2*>(ks_s + (i / PU) * RR + D + 4 * (i % PU)) =
          make_uint2(0u, 0u);
  }

  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int own_end = min(bnd, hi);  // rows below come from the cache
  // bf16 rows [own_end, hi): the tail (int8, rows < pos) or kv_new
  auto exact_row = [&](int s, int off) {
    return kInt8 && s < p
               ? a.tail + (static_cast<size_t>(b) * kTail + (s - bnd)) * row +
                     off
               : kv_new + (static_cast<size_t>(b) * C + (s - p)) * row + off;
  };
  auto load_tile = [&](int i) {
    const int st = i % NS;
    if constexpr (kInt8) {  // the tile's int8 rows and their scale words
      for (int e = tid; e < kTile * 2 * NIU; e += kMmaThreads) {
        const int r = e / (2 * NIU), part = (e / NIU) % 2, u = e % NIU;
        const int s = lo + i * kTile + r;
        if (s < own_end)
          cp_async<IU>((part ? v8 : k8) + (st * kTile + r) * DP + u * IU,
                       static_cast<const int8_t*>(a.cache) +
                           (static_cast<size_t>(b) * S + s) * row +
                           part * f_kv + kvh * D + u * IU,
                       IU);
      }
      const int s = lo + i * kTile + tid;
      if (tid < kTile && s < own_end)
        cp_async<4>(sw + st * kTile + tid,
                    a.scales + (static_cast<size_t>(b) * S + s) * 2, 4);
    } else {  // every row of the tile, zeros past the piece
      __nv_bfloat16* kd = ks_s + st * kTile * RR;
      __nv_bfloat16* vd = vs_s + st * kTile * RR;
      for (int e = tid; e < kTile * 2 * NU; e += kMmaThreads) {
        const int r = e / (2 * NU), part = (e / NU) % 2, u = e % NU;
        const int s = lo + i * kTile + r;
        const int off = part * f_kv + kvh * D + u * VU;
        __nv_bfloat16* dst =
            (part ? vd : kd) + soff<D>(r, (u * VU) >> 3) + ((u * VU) & 7);
        if (s < own_end)
          cp_async<2 * VU>(dst,
                           static_cast<const __nv_bfloat16*>(a.cache) +
                               (static_cast<size_t>(b) * S + s) * row + off,
                           2 * VU);
        else
          cp_async<2 * VU>(dst, s < hi ? exact_row(s, off) : kv_new,
                           s < hi ? 2 * VU : 0);
      }
    }
  };
  // int8: a warp's 16 rows r0.. of tile i into the bf16 tile, in units of
  // UE lanes: int8 rows converted from the ring (exact), exact rows read
  // from the tail and kv_new (at most 33 rows of a call), zeros past the
  // piece; the scale word of the exact rows is (1, 1). Only this warp reads
  // these rows of the tile.
  auto convert_rows = [&](int i, int r0) {
    constexpr int UE = D % 16 == 0 ? 16 : 4;
    constexpr int NUE = D / UE;
    const int st = i % NS;
    for (int e = lane; e < 16 * 2 * NUE; e += 32) {
      const int r = r0 + e / (2 * NUE), part = (e / NUE) % 2, u = e % NUE;
      const int s = lo + i * kTile + r;
      const int8_t* q8 = (part ? v8 : k8) + (st * kTile + r) * DP + u * UE;
      __nv_bfloat16* dst = part ? vs_s : ks_s;
      if constexpr (UE == 16) {
        uint4 o0 = make_uint4(0u, 0u, 0u, 0u), o1 = o0;
        if (s < own_end) {
          const uint4 v = *reinterpret_cast<const uint4*>(q8);
          o0 = make_uint4(i8x2_bf16x2(prmt(v.x, 0u, 0x0100u)),
                          i8x2_bf16x2(prmt(v.x, 0u, 0x0302u)),
                          i8x2_bf16x2(prmt(v.y, 0u, 0x0100u)),
                          i8x2_bf16x2(prmt(v.y, 0u, 0x0302u)));
          o1 = make_uint4(i8x2_bf16x2(prmt(v.z, 0u, 0x0100u)),
                          i8x2_bf16x2(prmt(v.z, 0u, 0x0302u)),
                          i8x2_bf16x2(prmt(v.w, 0u, 0x0100u)),
                          i8x2_bf16x2(prmt(v.w, 0u, 0x0302u)));
        } else if (s < hi) {
          const uint4* src = reinterpret_cast<const uint4*>(
              exact_row(s, part * f_kv + kvh * D + u * UE));
          o0 = src[0];
          o1 = src[1];
        }
        *reinterpret_cast<uint4*>(dst + soff<D>(r, 2 * u)) = o0;
        *reinterpret_cast<uint4*>(dst + soff<D>(r, 2 * u + 1)) = o1;
      } else {
        uint2 o = make_uint2(0u, 0u);
        if (s < own_end) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(q8);
          o = make_uint2(i8x2_bf16x2(prmt(v, 0u, 0x0100u)),
                         i8x2_bf16x2(prmt(v, 0u, 0x0302u)));
        } else if (s < hi) {
          o = *reinterpret_cast<const uint2*>(
              exact_row(s, part * f_kv + kvh * D + u * UE));
        }
        *reinterpret_cast<uint2*>(dst + soff<D>(r, u >> 1) + 4 * (u & 1)) =
            o;
      }
    }
    if (lane < 16 && lo + i * kTile + r0 + lane >= own_end)
      sw[st * kTile + r0 + lane] = 0x3F803F80u;
  };

  // B fragments of Q^T: query g of head h0 + j, head_dim 16 kk + 2t (+8);
  // zero past C queries and past head_dim
  uint32_t qf[NQ][KS][2];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int e0 = 16 * kk + 2 * t;
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(
          a.q + (static_cast<size_t>(b) * C + g) * F + (h0 + j) * D + e0);
      qf[j][kk][0] = g < C && e0 < D ? qp[0] : 0u;
      qf[j][kk][1] = g < C && e0 + 8 < D ? qp[4] : 0u;
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
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  if constexpr (kInt8) {
    // the flush, while the first tiles load: the batch row's 64 (row,
    // half) tasks spread over its blocks, one warp a task
    if (p % kTail == kTail - 1) {
      const int nb = gridDim.y * nsplit, bi = blockIdx.y * nsplit + split;
      for (int task = bi + nb * warp; task < 2 * kTail;
           task += nb * kMmaWarps)
        flush_task<__nv_bfloat16>(
            a.tail + static_cast<size_t>(b) * kTail * row,
            kv_new + static_cast<size_t>(b) * row,
            static_cast<int8_t*>(a.cache) +
                (static_cast<size_t>(b) * S + bnd) * row,
            a.scales + (static_cast<size_t>(b) * S + bnd) * 2, task, f_kv,
            lane);
    }
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + NS - 1 < n_tiles) load_tile(i + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const int st = i % NS;      // the ring stage (int8: of the scales)
    const int sb = i % BS;      // the bf16 tile
    const int r0 = 16 * warp;              // the warp's keys in the tile
    const int key0 = lo + i * kTile + r0;  // its first key
    if (key0 < hi) {
      if constexpr (kInt8) {
        convert_rows(i, r0);
        __syncwarp();
      }
      const __nv_bfloat16* kt = ks_s + sb * kTile * RR;
      const __nv_bfloat16* vt = vs_s + sb * kTile * RR;
      float sc[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      {  // S^T = K Q^T: A = 16 keys x 16 head_dim from ldmatrix
        const int rr = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, kt + soff<D>(rr, 2 * kk + (lane >> 4)));
#pragma unroll
          for (int j = 0; j < NQ; ++j) mma(sc[j], af, qf[j][kk][0], qf[j][kk][1]);
        }
      }
      // row scales of keys g and g + 8 (1 for bf16 and exact rows)
      float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
      if constexpr (kInt8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t w = sw[st * kTile + r0 + g + 8 * e];
          ksc[e] = __uint_as_float(w << 16);
          vsc[e] = __uint_as_float(w & 0xFFFF0000u);
        }
      }
      uint32_t pb[NQ][2];  // P^T B fragments
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float pr[4];
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = 2 * t + qq;
          float s0 = sc[j][qq] * ksc[0] * a.scale_log2;
          float s1 = sc[j][qq + 2] * ksc[1] * a.scale_log2;
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
        // keys 2t, 2t + 1 and 8 + 2t, 9 + 2t after the transpose
        pb[j][0] = movmatrix_trans(pack_bf16(pr[0] * vsc[0], pr[1] * vsc[0]));
        pb[j][1] = movmatrix_trans(pack_bf16(pr[2] * vsc[1], pr[3] * vsc[1]));
      }
      {  // O^T += V^T P^T: A = 16 head_dim x 16 keys from ldmatrix.trans
        const int rr = r0 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, vt + soff<D>(rr, 2 * dt + ((lane >> 3) & 1)));
#pragma unroll
          for (int j = 0; j < NQ; ++j) mma(acc[j][dt], af, pb[j][0], pb[j][1]);
        }
      }
    }
    __syncthreads();  // the stage (int8: the tile) is refilled next round
  }
  cp_async_wait<0>();
  __syncthreads();

  // Each warp's states into shared memory (over the ring): the row sums
  // summed over the lanes that share a query column first.
  constexpr int QC = NQ * 8;                       // query columns
  float* st_m = reinterpret_cast<float*>(smem);    // [warp][QC]
  float* st_l = st_m + kMmaWarps * QC;             // [warp][QC]
  float* st_a = st_l + kMmaWarps * QC;             // [warp][QC][DP]
  float* bk_m = st_a + kMmaWarps * QC * DP;        // the block's [QC]
  float* bk_l = bk_m + QC;                         // [QC]
  float* bk_a = bk_l + QC;                         // [QC][DP]
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
        float* ap = st_a + (warp * QC + col) * DP + 16 * dt + g;
        ap[0] = acc[j][dt][qq];
        ap[8] = acc[j][dt][qq + 2];
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
      o += st_a[(w * QC + col) * DP + d] * f;
    }
    if (nsplit == 1) {
      a.out[(static_cast<size_t>(b) * C + c) * F + (h0 + col / 8) * D + d] =
          __float2bfloat16_rn(l_all > 0.f ? o / l_all : 0.f);
    } else {
      if (d == 0) {
        bk_m[col] = m_all;
        bk_l[col] = l_all;
      }
      bk_a[col * DP + d] = o;
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
      o += *cluster.map_shared_rank(bk_a + col * DP + d, r) * f;
    }
    a.out[(static_cast<size_t>(b) * C + c) * F + (h0 + j) * D + d] =
        __float2bfloat16_rn(l_all > 0.f ? o / l_all : 0.f);
  }
  cluster.sync();  // no block leaves while its state is read
}

template <int D, int NQ, bool kInt8>
cudaError_t launch_mma(const MmaArgs& a, int B, int nsplit, cudaStream_t st) {
  auto kernel = attn_mma_kernel<D, NQ, kInt8>;
  constexpr int smem = mma_smem_bytes(D, NQ, kInt8);
  static_assert(smem <= kMaxSmem, "shared memory");
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, a.H / NQ, B);
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
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// Checks what the kernel takes (cudaErrorInvalidValue otherwise) and picks
// the instance: head_dim 64 (nq 1, 2, 4), 100 or 128 (nq 1, 2); nq query
// heads a block dividing H / H_kv, nsplit blocks a cluster
// (ops/chunk_attention.py::chunk_geometry); int8 caches at C = 1 only.
template <bool kInt8>
cudaError_t launch_any(const MmaArgs& a, int B, int D, int nq, int nsplit,
                       void* stream) {
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (B < 1 || a.H_kv < 1 || a.H % a.H_kv != 0 || a.C < 1 ||
      a.C > (kInt8 ? 1 : kMaxChunk) || nq < 1 || (a.H / a.H_kv) % nq != 0 ||
      nsplit < 1 || nsplit > kMaxSplit || !aligned(a.q) ||
      !aligned(a.kv_new) || !aligned(a.cache) || !aligned(a.out) ||
      (kInt8 && (a.S % kTail != 0 || !aligned(a.scales) ||
                 !aligned(a.tail))))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_MMA(DD, NN) \
  if (D == DD && nq == NN) return launch_mma<DD, NN, kInt8>(a, B, nsplit, st);
  ATTN_MMA(64, 1)
  ATTN_MMA(64, 2)
  ATTN_MMA(64, 4)
  ATTN_MMA(100, 1)
  ATTN_MMA(100, 2)
  ATTN_MMA(128, 1)
  ATTN_MMA(128, 2)
#undef ATTN_MMA
  return cudaErrorInvalidValue;
}

}  // namespace attn_mma

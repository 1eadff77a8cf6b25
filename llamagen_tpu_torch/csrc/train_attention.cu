// Causal training attention on the native [B, S, H, D] layout: forward and
// backward (K4).
//
// Replaces the Pallas kernels of llamagen_tpu/ops/train_attention.py: the
// forward `_fwd_kernel` (pallas_call at train_attention.py:195) and the
// backward `_bwd_kernel` (pallas_call at :213). What they compute, per batch
// row and head:
//   p  = softmax_f32(mask_causal(q . k^T * scale, -1e30))
//   o  = (p cast to T) . v                 (f32 sums, cast to T)
//   dv = (p cast to T)^T . do
//   dp = do . v^T                          (f32)
//   ds = p * (dp - delta)  cast to T,  delta = rowsum(dp * p)
//   dq = ds . k * scale,  dk = ds^T . q * scale
// Here delta is computed as rowsum(do * o) in f32 from the stored output, the
// same quantity up to o's rounding to T (exact at f32, ~1 bf16 ulp of o at
// bf16).
//
// The TPU kernel holds one head's whole [S, S] f32 score tile in VMEM
// (1.3 MB at S = 576); a Hopper block has 227 KB of shared memory. So query
// rows are tiled, key tiles are walked up to the diagonal only, and the
// per-row log-sum-exp [B, H, S] f32 is the residual the backward reads. The
// backward is two kernels and needs no atomics: `dq` (one block per query
// tile; it also writes delta), then `dkdv` (one block per key tile, walking
// the query tiles at or below the diagonal).
//
// Layout: q, k, v are read in place with a batch and a row stride each (v is
// a view into the wqkv output, row stride 3F), the head at lane offset h * D.
// o, do, dq, dk, dv are dense [B, S, H, D]. No transposes.
//
// What bounds it on the H100: at GPT-L (B 32, S 576, H 16, D 64) the
// forward is ~21.8 GFLOP of products, ~85 M exponentials and ~151 MB of q,
// k, v, o and lse: at the data sheet's rates 0.022 ms on the tensor cores,
// ~0.023 ms on the special-function units and 0.045 ms of memory traffic,
// all within a factor of two, so the design keeps the three busy at once
// (asynchronous loads, two warpgroups -- and at D 64 two blocks -- per SM,
// one's exponentials beside another's products). The backward is ~76 GFLOP
// over its two kernels, each moving ~229 MB. bf16 inputs run on the tensor
// cores; f32 inputs, which the tensor cores would round, on the CUDA cores
// in f32 (each thread a register micro-tile of 8 or 4 rows by 4 columns
// of f32 shared-memory tiles, two passes over the keys in the forward).
//
// bf16 forward: one pass over the keys with an online softmax, on wgmma,
// fed by TMA. A block holds 128 query rows in two consumer warpgroups of 64
// and one producer warp that issues TMA loads (q once, then k and v tiles
// of 64 keys into a two-stage ring of full/empty mbarriers). The tensor maps
// (built per call with cuTensorMapEncodeTiled, which the C entry point
// fetches through cudaGetDriverEntryPoint, so the library needs no -lcuda)
// describe each operand as [B, S, H * D] with its own strides, so v is read
// in place; rows past S arrive as zeros. Tiles land in the 128-byte-swizzle
// layout that wgmma reads: s = q.k^T is m64n64k16 with both operands
// K-major in shared memory (D 128: two 64-column atoms), the causal mask
// applies on the diagonal tile only, o is rescaled by exp2(m_old - m_new)
// in f32, p = exp2(s - m) is rounded to bf16 as it is packed into the
// A registers of o += p.v (the accumulator layout is the A-register
// layout), with v MN-major in shared memory. At the end o / l and
// lse = m + log l. So p carries one bf16 rounding before the division by l
// (the TPU kernel rounds the normalised p: both one rounding, 2^-9).
//
// bf16 backward: mma.sync m16n8k16 with every fragment from ldmatrix.x4
// (operands read along their rows -- k in ds.k, q and do in p^T.do and
// ds^T.q -- through ldmatrix.x4.trans on the row-major tile), tiles staged
// once each with 16-byte cp.async copies into rows padded by 16 bytes, in a
// two-stage ring so that tile j + 1 loads while tile j computes. p is
// recomputed exactly normalised from lse, as the TPU kernel forms it.
//
// Registers per thread and spills (ptxas -v in .build/<lib>.log, sm_90a,
// CUDA 12.8): forward 95 (D 64, two blocks per SM) and 161 (D 128), no
// spills; dq 158 and 197, no spills; dkdv 168 (D 64, three blocks per SM,
// 60 bytes of spill stores) and 237 (D 128, no spills).

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>
#include <type_traits>

namespace train_attention {
namespace {

using bf16 = __nv_bfloat16;
extern __shared__ __align__(16) unsigned char dyn_smem[];

constexpr int kThreads = 128;  // 8 row groups (ty) x 16 column lanes (tx)
constexpr int kQ = 64;         // query rows per tile
constexpr int kK = 64;         // key rows per tile (forward, dq; bf16 dkdv)
constexpr int kKB = 32;        // key rows per dkdv block
constexpr int kPL = kQ + 1;    // padded row of a probability tile
constexpr float kNeg = -1e30f; // the TPU kernel's mask value

// The CUDA-core path takes f32 (bf16 runs on the tensor cores below); the
// conversions keep its body generic in T.
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// v rounded to T and back: the TPU kernel's cast before a product
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// sum / max over the 16 lanes (tx) that share a row group
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [row0, row0 + n) of one head (`src` already at the batch row and the
// head's lane offset, `rs` elements per sequence row) into dst[n][ld] as f32;
// rows at or past S read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rs, int row0, int n, int S) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[r * ld + d] = s < S ? to_f32(src[(size_t)s * rs + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[ty + 8i][d] * Bm[tx + 16j][d]; A and Bm are [.][D + 1]
// (the pad puts the 16 rows a warp reads in 16 banks).
template <int D, int NI>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int ty, int tx, float (&s)[NI][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[NI], bv[4];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[(ty + 8 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[ty + 8i][c] * M[c][tx + 16j], c < NC; P is [.][kPL],
// M is [NC][ldm].
template <int D, int NI, int NC>
__device__ __forceinline__ void acc_tile(const float* P, const float* M,
                                         int ldm, int ty, int tx,
                                         float (&acc)[NI][D / 16]) {
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    float p[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) p[i] = P[(ty + 8 * i) * kPL + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float m = M[c * ldm + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i][j] = fmaf(p[i], m, acc[i][j]);
    }
  }
}

template <int D> constexpr int fwd_simt_floats() {
  return 2 * kQ * (D + 1) + kK * D + kQ * kPL;
}
template <int D> constexpr int dq_simt_floats() {
  return 2 * kQ * (D + 1) + 2 * kK * (D + 1) + kQ * kPL;
}
template <int D> constexpr int dkdv_simt_floats() {
  return 2 * kKB * (D + 1) + 2 * kQ * (D + 1) + 2 * kKB * kPL + 2 * kQ;
}

// CUDA cores (f32 inputs). One block per (query tile, head, batch row); the
// longest tiles start first.
template <typename T, int D>
__device__ __forceinline__ void fwd_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int qsb,
    int qss, int ksb, int kss, int vsb, int vss, float scale) {
  float* smem = reinterpret_cast<float*>(dyn_smem);
  constexpr int LD = D + 1;
  float* Qs = smem;              // [kQ][LD]
  float* Ks = Qs + kQ * LD;      // [kK][LD]
  float* Vs = Ks + kK * LD;      // [kK][D]
  float* Ps = Vs + kK * D;       // [kQ][kPL]
  const int nqt = (S + kQ - 1) / kQ;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kQ;
  const T* kb = k + (size_t)b * ksb + h * D;
  const T* vb = v + (size_t)b * vsb + h * D;
  load_tile<T, D>(Qs, LD, q + (size_t)b * qsb + h * D, qss, q0, kQ, S);

  // pass 1: each row's max and sum of exp
  float m[8], l[8], s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, LD, kb, kss, kt * kK, kK, S);
    __syncthreads();
    dot_tile<D, 8>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 8 * i;
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * kK + tx + 16 * j;
        s[i][j] = (key <= row && key < S) ? s[i][j] * scale : kNeg;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum16(sum);
      m[i] = m_new;
    }
  }
  float row_lse[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row_lse[i] = m[i] + logf(l[i]);
    const int row = q0 + ty + 8 * i;
    if (tx == 0 && row < S) lse[((size_t)b * H + h) * S + row] = row_lse[i];
  }

  // pass 2: o = (p rounded to T) . v with p normalised exactly
  float acc[8][D / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, LD, kb, kss, kt * kK, kK, S);
    load_tile<T, D>(Vs, D, vb, vss, kt * kK, kK, S);
    __syncthreads();
    dot_tile<D, 8>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * kK + tx + 16 * j;
        const float p = (key <= row && key < S)
                            ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        Ps[(ty + 8 * i) * kPL + tx + 16 * j] = round_to<T>(p);
      }
    }
    __syncthreads();
    acc_tile<D, 8, kK>(Ps, Vs, D, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= S) continue;
    T* dst = o + ((size_t)b * S + row) * H * D + h * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dst[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// One block per (query tile, head, batch row): delta for its rows, then dq
// over the key tiles up to the diagonal.
template <typename T, int D>
__device__ __forceinline__ void dq_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int S, int H, int qsb, int qss, int ksb, int kss,
    int vsb, int vss, float scale) {
  float* smem = reinterpret_cast<float*>(dyn_smem);
  constexpr int LD = D + 1;
  float* Qs = smem;              // [kQ][LD]
  float* dOs = Qs + kQ * LD;     // [kQ][LD]
  float* Ks = dOs + kQ * LD;     // [kK][LD]
  float* Vs = Ks + kK * LD;      // [kK][LD]
  float* dSs = Vs + kK * LD;     // [kQ][kPL]
  const int nqt = (S + kQ - 1) / kQ;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kQ;
  const int rs = H * D;  // row stride of the dense tensors
  const T* kb = k + (size_t)b * ksb + h * D;
  const T* vb = v + (size_t)b * vsb + h * D;
  load_tile<T, D>(Qs, LD, q + (size_t)b * qsb + h * D, qss, q0, kQ, S);
  load_tile<T, D>(dOs, LD, dout + (size_t)b * S * rs + h * D, rs, q0, kQ, S);
  __syncthreads();

  float row_lse[8], row_delta[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    float part = 0.f;
    if (row < S) {
      const T* orow = o + ((size_t)b * S + row) * rs + h * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        part += dOs[(ty + 8 * i) * LD + tx + 16 * j] * to_f32(orow[tx + 16 * j]);
    }
    row_delta[i] = sum16(part);
    const size_t at = ((size_t)b * H + h) * S + row;
    row_lse[i] = row < S ? lse[at] : 0.f;
    if (tx == 0 && row < S) delta[at] = row_delta[i];
  }

  float acc[8][D / 16], s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, LD, kb, kss, kt * kK, kK, S);
    load_tile<T, D>(Vs, LD, vb, vss, kt * kK, kK, S);
    __syncthreads();
    dot_tile<D, 8>(Qs, Ks, ty, tx, s);
    dot_tile<D, 8>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * kK + tx + 16 * j;
        float ds = 0.f;
        if (key <= row && key < S && row < S) {
          const float p = expf(s[i][j] * scale - row_lse[i]);
          ds = p * (dp[i][j] - row_delta[i]);
        }
        dSs[(ty + 8 * i) * kPL + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    acc_tile<D, 8, kK>(dSs, Ks, LD, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= S) continue;
    T* dst = dq + ((size_t)b * S + row) * rs + h * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dst[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// One block per (32-key tile, head, batch row): dk and dv over the query
// tiles at or below the diagonal. Scores are formed transposed (keys as
// rows), so p^T and ds^T feed the products straight from shared memory.
template <typename T, int D>
__device__ __forceinline__ void dkdv_simt(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int qsb, int qss, int ksb, int kss, int vsb, int vss,
    float scale) {
  float* smem = reinterpret_cast<float*>(dyn_smem);
  constexpr int LD = D + 1;
  float* Ks = smem;              // [kKB][LD]
  float* Vs = Ks + kKB * LD;     // [kKB][LD]
  float* Qs = Vs + kKB * LD;     // [kQ][LD]
  float* dOs = Qs + kQ * LD;     // [kQ][LD]
  float* Ps = dOs + kQ * LD;     // [kKB][kPL]  p^T rounded to T
  float* dSs = Ps + kKB * kPL;   // [kKB][kPL]  ds^T rounded to T
  float* lse_s = dSs + kKB * kPL;  // [kQ]
  float* dl_s = lse_s + kQ;        // [kQ]
  const int kt = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * kKB;
  const int rs = H * D;
  const int nqt = (S + kQ - 1) / kQ;
  const T* qb = q + (size_t)b * qsb + h * D;
  const T* db = dout + (size_t)b * S * rs + h * D;
  const float* lse_b = lse + ((size_t)b * H + h) * S;
  const float* dl_b = delta + ((size_t)b * H + h) * S;
  load_tile<T, D>(Ks, LD, k + (size_t)b * ksb + h * D, kss, k0, kKB, S);
  load_tile<T, D>(Vs, LD, v + (size_t)b * vsb + h * D, vss, k0, kKB, S);

  float acc_k[4][D / 16], acc_v[4][D / 16], st[4][4], dpt[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  for (int qt = k0 / kQ; qt < nqt; ++qt) {
    const int q0 = qt * kQ;
    __syncthreads();
    load_tile<T, D>(Qs, LD, qb, qss, q0, kQ, S);
    load_tile<T, D>(dOs, LD, db, rs, q0, kQ, S);
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
      lse_s[i] = q0 + i < S ? lse_b[q0 + i] : 0.f;
      dl_s[i] = q0 + i < S ? dl_b[q0 + i] : 0.f;
    }
    __syncthreads();
    dot_tile<D, 4>(Ks, Qs, ty, tx, st);
    dot_tile<D, 4>(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        float p = 0.f, ds = 0.f;
        if (key <= row && row < S && key < S) {
          p = expf(st[i][j] * scale - lse_s[c]);
          ds = p * (dpt[i][j] - dl_s[c]);
        }
        Ps[(ty + 8 * i) * kPL + c] = round_to<T>(p);
        dSs[(ty + 8 * i) * kPL + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
    acc_tile<D, 4, kQ>(Ps, dOs, LD, ty, tx, acc_v);
    acc_tile<D, 4, kQ>(dSs, Qs, LD, ty, tx, acc_k);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 8 * i;
    if (key >= S) continue;
    const size_t at = ((size_t)b * S + key) * rs + h * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[at + tx + 16 * j] = from_f32<T>(acc_k[i][j] * scale);
      dv[at + tx + 16 * j] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the forward on wgmma fed by TMA, the backward on mma.sync fed by a
// cp.async ring, fragments from ldmatrix.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
// max / sum over the 4 lanes of a quad (they hold the same two rows)
__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --- mbarrier and TMA (forward) -------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// waits until the barrier's phase of parity `parity` has completed; a wait
// of seconds (a ring out of step) traps, so a fault fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// one box of `map` at (lane c0, row c1, batch row c2) into shared memory;
// completion (all the box's bytes, rows past S zero-filled) lands on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma (forward) -------------------------------------------------------

// Descriptor of a bf16 operand in the 128-byte-swizzle layout that TMA
// writes: rows of 64 elements (128 bytes), 8-row groups 1024 bytes apart.
// Both byte offsets are 1024: a K-major operand reads only the group
// stride, an MN-major one of width 64 (one atom) reads only the stride
// between 8-row groups along K, whichever field the hardware takes it from.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define TA_ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define TA_REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
// d's layout: warp w of the warpgroup holds rows 16w + g and 16w + g + 8
// (g = lane / 4) in d[4j + 0, 1] and d[4j + 2, 3], columns 8j + 2t + {0, 1}
// (t = lane % 4).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TA_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the mma.sync
// m16n8k16 A layout per warp), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TA_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kFwdRows = 128;    // query rows per block: 2 warpgroups x 64
constexpr int kFwdKeys = 64;     // keys per tile
constexpr int kFwdThreads = 288; // 2 consumer warpgroups + 1 producer warp
constexpr int kAtomBytes = 128;  // one swizzled row: 64 bf16
constexpr int kQAtom = kFwdRows * kAtomBytes;   // 64 columns of a Q tile
constexpr int kKVAtom = kFwdKeys * kAtomBytes;  // 64 columns of a K/V tile

template <int D> struct FwdSmem {
  static constexpr int kQBytes = D / 64 * kQAtom;
  static constexpr int kTileBytes = D / 64 * kKVAtom;  // one K or V tile
  static constexpr int kKOff = kQBytes;                  // K stages 0, 1
  static constexpr int kVOff = kKOff + 2 * kTileBytes;   // V stages 0, 1
  static constexpr int kBarOff = kVOff + 2 * kTileBytes; // q, full[2], empty[2]
  static constexpr int kBytes = kBarOff + 64 + 1024;  // + 1024-byte alignment
};

// One block per (128 query rows, head, batch row), the longest (last) tiles
// first. Warp 8 issues the TMA loads: Q once, then K and V tiles into a
// two-stage ring (full barriers: the bytes arrived; empty barriers: each
// consumer warp is done with the stage). Warpgroup w owns rows 64w..64w+63
// and walks the key tiles up to its diagonal with an online softmax. At
// D = 64 two blocks share an SM (registers capped at 112), so one block's
// softmax overlaps the other's products; D = 128 runs one block per SM.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, D == 64 ? 2 : 1)
fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
               float scale_log2) {
  using L = FwdSmem<D>;
  constexpr int A = D / 64;  // 64-column atoms of a row
  const uint32_t base = (smem_u32(dyn_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kKOff, sV = base + L::kVOff;
  const uint32_t bar_q = base + L::kBarOff, bar_full = bar_q + 8,
                 bar_empty = bar_q + 24;
  const int nqt = (S + kFwdRows - 1) / kFwdRows;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kFwdRows;
  const int n_kt = min(2 * qt + 2, (S + kFwdKeys - 1) / kFwdKeys);
  const int n_wg = q0 + 64 < S ? 2 : 1;  // warpgroups with a row below S
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 4 * n_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int a = 0; a < A; ++a)
        tma_load(sQ + a * kQAtom, &tq, bar_q, h * D + 64 * a, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt & 1;
        const uint32_t full = bar_full + 8 * st;
        if (kt >= 2) mbar_wait(bar_empty + 8 * st, ((kt >> 1) - 1) & 1);
        mbar_expect_tx(full, 2 * L::kTileBytes);
        for (int a = 0; a < A; ++a) {
          const uint32_t at = st * L::kTileBytes + a * kKVAtom;
          tma_load(sK + at, &tk, full, h * D + 64 * a, kt * kFwdKeys, b);
          tma_load(sV + at, &tv, full, h * D + 64 * a, kt * kFwdKeys, b);
        }
      }
    }
    return;
  }
  const int wg = warp / 4;
  if (wg >= n_wg) return;  // every row of this warpgroup is past S
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + g;  // and row0 + 8
  const int kt_diag = 2 * qt + wg;
  const int kt_end = min(kt_diag, n_kt - 1);
  const uint32_t qa = sQ + wg * 64 * kAtomBytes;

  float acc[A][32];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int st = kt & 1;
    const uint32_t ks = sK + st * L::kTileBytes, vs = sV + st * L::kTileBytes;
    mbar_wait(bar_full + 8 * st, (kt >> 1) & 1);
    // s = q . k^T over D in 16-column (32-byte) steps, 4 steps per atom
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, sw128_desc(qa + (kk / 4) * kQAtom + (kk % 4) * 32),
               sw128_desc(ks + (kk / 4) * kKVAtom + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait();
    reg_fence(s);

    // scores in log2 units, the causal mask on the diagonal tile only
    float mx[2] = {m[0], m[1]};
    const bool diag = kt == kt_diag;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (diag && kt * kFwdKeys + 8 * (i / 4) + 2 * t + (i % 2) >
                      row0 + 8 * ((i / 2) % 2))
        x = -INFINITY;
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = max4(mx[r]);  // finite: each row has an unmasked key here
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i / 2) % 2];
    // p = exp2(s - m) in f32, summed unrounded, rounded to bf16 as packed:
    // the accumulator layout is the A-register layout of the next product
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i % 2;
      const float p0 = exp2f(s[2 * i] - m[r]), p1 = exp2f(s[2 * i + 1] - m[r]);
      l[r] += p0 + p1;
      p[i] = pack_bf16(p0, p1);
    }
    // o += p . v, 16 keys per step, one product per 64-column atom of v
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < A; ++a) reg_fence(acc[a]);
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk)
#pragma unroll
      for (int a = 0; a < A; ++a)
        wgmma_rs(acc[a], p + 4 * kk,
                 sw128_desc(vs + a * kKVAtom + kk * 16 * kAtomBytes));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int a = 0; a < A; ++a) reg_fence(acc[a]);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

  // o = acc / l, lse = (m + log2 l) ln 2
  const int rs = H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float lsum = sum4(l[r]);
    if (row >= S) continue;
    const float inv = 1.f / lsum;
    if (t == 0)
      lse[((size_t)b * H + h) * S + row] = (m[r] + log2f(lsum)) * kLn2;
    bf16* dst = o + ((size_t)b * S + row) * rs + h * D + 2 * t;
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 64 * a + 8 * j) =
            pack_bf16(acc[a][4 * j + 2 * r] * inv,
                      acc[a][4 * j + 2 * r + 1] * inv);
  }
}

// --- cp.async and ldmatrix (backward) --------------------------------------

constexpr int kPad = 8;  // bf16 row padding: 8 rows of a fragment hit 8
                         // distinct 16-byte bank groups
// dkdv walks 32 query rows at a time at D = 128 (64 at D = 64), so that its
// dk and dv accumulators fit in registers
template <int D> constexpr int kDkdvQ = D == 128 ? 32 : 64;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + n) of one head (`src` at the batch row and the head's
// lane offset, `rs` elements per sequence row) into dst[n][D + kPad] with
// 16-byte asynchronous copies; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int rs,
                                          int row0, int n, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CH; i += kThreads) {
    const int r = i / CH, c = 8 * (i % CH);
    const bool ok = row0 + r < S;
    cp_async16(smem_u32(dst + r * (D + kPad) + c),
               src + (size_t)(ok ? row0 + r : 0) * rs + c, ok);
  }
}
// n f32 values from src[row0..] (zero past S) with 4-byte copies
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int row0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = row0 + i < S;
    cp_async4(smem_u32(dst + i), src + (ok ? row0 + i : 0), ok);
  }
}

// acc[j] (16 x 8 tile j) = A[16][KD] . Bm[8j .. 8j + 7][KD]^T; A and Bm
// row-major in shared memory (row stride ld), every fragment one
// ldmatrix.x4. Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
// A rows g and g + 8, k pairs 2t and 2t + 8; B column g, k pairs 2t and
// 2t + 8; acc[j][e] at row g + 8 (e / 2), column 8j + 2t + e % 2.
template <int KD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* A,
                                        const bf16* Bm, int ld) {
  const int lane = threadIdx.x % 32;
  // lane -> the row its ldmatrix address names: matrices 0-3 are A's
  // (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (8-15, 8-15)
  // and two n tiles of B: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ...)
  const uint32_t a0 = smem_u32(A + (lane % 8 + 8 * (lane / 8 % 2)) * ld +
                               8 * (lane / 16));
  const uint32_t b0 = smem_u32(Bm + (lane % 8 + 8 * (lane / 16)) * ld +
                               8 * (lane / 8 % 2));
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a0 + kk * 32);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bb[4];
      ldsm_x4(bb, b0 + (jj * 16 * ld + kk * 16) * 2);
      mma_bf16(acc[2 * jj], a, bb[0], bb[1]);
      mma_bf16(acc[2 * jj + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[n] += P[16][KN] . Bm[KN][8n .. 8n + 7]: P an accumulator-layout
// register tile (KN / 8 tiles of 16 x 8), rounded to bf16 as it is packed
// into A fragments (tiles 2m and 2m + 1 form k block m); Bm row-major
// [k][n] in shared memory, its fragments from ldmatrix.x4.trans.
template <int KN, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[NT][4],
                                       const float (&p)[KN / 8][4],
                                       const bf16* Bm, int ld) {
  const int lane = threadIdx.x % 32;
  // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (8-15, 8-15)
  const uint32_t b0 = smem_u32(Bm + (lane % 8 + 8 * (lane / 8 % 2)) * ld +
                               8 * (lane / 16));
#pragma unroll
  for (int m = 0; m < KN / 16; ++m) {
    const uint32_t a[4] = {pack_bf16(p[2 * m][0], p[2 * m][1]),
                           pack_bf16(p[2 * m][2], p[2 * m][3]),
                           pack_bf16(p[2 * m + 1][0], p[2 * m + 1][1]),
                           pack_bf16(p[2 * m + 1][2], p[2 * m + 1][3])};
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bb[4];
      ldsm_x4_t(bb, b0 + (m * 16 * ld + jj * 16) * 2);
      mma_bf16(acc[2 * jj], a, bb[0], bb[1]);
      mma_bf16(acc[2 * jj + 1], a, bb[2], bb[3]);
    }
  }
}

// Stores a 16 x D accumulator tile (rows row_g and row_g + 8 of this lane)
// times `mul` as bf16 into dst rows (row stride rs); rows at or past S skip.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int rs, int row_g,
                                           int S, const float (&acc)[D / 8][4],
                                           float mul) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * rs + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

template <int D> constexpr int dq_ring_bytes() {
  return 2 * 6 * kQ * (D + kPad) + kQ * 4;
}
template <int D> constexpr int dkdv_ring_bytes() {
  return 2 * (2 * kK + 4 * kDkdvQ<D>) * (D + kPad) + 4 * kDkdvQ<D> * 4;
}

// One block per (64 query rows, head, batch row), the longest tiles first:
// q and do staged once, delta = rowsum(do * o) for its rows, then the key
// tiles up to the diagonal through a two-stage cp.async ring (tile kt + 1
// loads while tile kt computes): s = q.k^T, dp = do.v^T, ds, dq += ds.k.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_ring_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, bf16* __restrict__ dq, int S, int H,
               int qsb, int qss, int ksb, int kss, int vsb, int vss,
               float scale) {
  constexpr int LD = D + kPad, T = kQ * LD;
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem);  // [kQ][LD]
  bf16* dOs = Qs + T;                             // [kQ][LD]
  bf16* Ks = dOs + T;                             // [2][kK][LD]
  bf16* Vs = Ks + 2 * T;                          // [2][kK][LD]
  float* dl_s = reinterpret_cast<float*>(Vs + 2 * T);  // [kQ]
  const int nqt = (S + kQ - 1) / kQ;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kQ;
  const int rs = H * D;
  const int row_g = q0 + 16 * warp + g;  // this lane's rows: row_g, row_g + 8
  const float scale_log2 = scale * kLog2e;
  const bf16* kb = k + (size_t)b * ksb + h * D;
  const bf16* vb = v + (size_t)b * vsb + h * D;
  copy_rows<D>(Qs, q + (size_t)b * qsb + h * D, qss, q0, kQ, S);
  copy_rows<D>(dOs, dout + (size_t)b * S * rs + h * D, rs, q0, kQ, S);
  copy_rows<D>(Ks, kb, kss, 0, kK, S);
  copy_rows<D>(Vs, vb, vss, 0, kK, S);
  cp_async_commit();
  float row_lse2[2], row_dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    row_lse2[r] = row < S ? lse[((size_t)b * H + h) * S + row] * kLog2e : 0.f;
  }

  float acc[D / 8][4], s[kK / 8][4], dp[kK / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    if (kt < qt) {
      const int st = (kt + 1) & 1;
      copy_rows<D>(Ks + st * T, kb, kss, (kt + 1) * kK, kK, S);
      copy_rows<D>(Vs + st * T, vb, vss, (kt + 1) * kK, kK, S);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (kt == 0) {
      // delta = rowsum(do * o) in f32: two lanes per row, half a row each,
      // o read with 16-byte loads
      const int r = threadIdx.x / 2, half = threadIdx.x % 2;
      const int row = q0 + r;
      float part = 0.f;
      if (row < S) {
        const bf16* orow =
            o + ((size_t)b * S + row) * rs + h * D + half * D / 2;
        const bf16* drow = dOs + r * LD + half * D / 2;
#pragma unroll
        for (int c = 0; c < D / 2; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 df = __bfloat1622float2(d2[e]);
            part += df.x * of.x + df.y * of.y;
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) {
        dl_s[r] = part;
        if (row < S) delta[((size_t)b * H + h) * S + row] = part;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) row_dl[i] = dl_s[16 * warp + g + 8 * i];
    }
    const bf16* Kt = Ks + (kt & 1) * T;
    mma_abt<D, kK / 8>(s, Qs + 16 * warp * LD, Kt, LD);
    mma_abt<D, kK / 8>(dp, dOs + 16 * warp * LD, Vs + (kt & 1) * T, LD);
#pragma unroll
    for (int j = 0; j < kK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + 8 * (e / 2);
        const int key = kt * kK + 8 * j + 2 * t + e % 2;
        float ds = 0.f;
        if (key <= row && key < S && row < S)
          ds = exp2f(s[j][e] * scale_log2 - row_lse2[e / 2]) *
               (dp[j][e] - row_dl[e / 2]);
        s[j][e] = ds;
      }
    mma_pb<kK, D / 8>(acc, s, Kt, LD);
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  store_rows<D>(dq + (size_t)b * S * rs + h * D, rs, row_g, S, acc, scale);
}

// One block per (64 keys, head, batch row): k and v staged once, then the
// query tiles at or below the diagonal through a two-stage cp.async ring
// (q, do, lse and delta of tile i + 1 load while tile i computes). Scores
// are formed transposed (this warp's 16 keys as rows), so p^T and ds^T feed
// dv += p^T.do and dk += ds^T.q from registers. At D = 64 three blocks
// share an SM (registers capped at 168, a few bytes spilled): faster on
// the H100 than two blocks without the spill.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
dkdv_ring_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int H, int qsb, int qss,
                 int ksb, int kss, int vsb, int vss, float scale) {
  constexpr int QN = kDkdvQ<D>;
  constexpr int LD = D + kPad, TQ = QN * LD;
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem);  // [kK][LD]
  bf16* Vs = Ks + kK * LD;                     // [kK][LD]
  bf16* Qs = Vs + kK * LD;                     // [2][QN][LD]
  bf16* dOs = Qs + 2 * TQ;                        // [2][QN][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TQ);  // [2][QN]
  float* dl_s = lse_s + 2 * QN;                            // [2][QN]
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kK;
  const int rs = H * D;
  const int key_g = k0 + 16 * warp + g;  // this lane's keys: key_g, key_g + 8
  const float scale_log2 = scale * kLog2e;
  const bf16* qb = q + (size_t)b * qsb + h * D;
  const bf16* db = dout + (size_t)b * S * rs + h * D;
  const float* lse_b = lse + ((size_t)b * H + h) * S;
  const float* dl_b = delta + ((size_t)b * H + h) * S;
  const int qstart = k0 - k0 % QN;
  const int n_it = (S - qstart + QN - 1) / QN;
  auto load_q_tile = [&](int i) {
    const int st = i & 1, row0 = qstart + i * QN;
    copy_rows<D>(Qs + st * TQ, qb, qss, row0, QN, S);
    copy_rows<D>(dOs + st * TQ, db, rs, row0, QN, S);
    copy_floats(lse_s + st * QN, lse_b, row0, QN, S);
    copy_floats(dl_s + st * QN, dl_b, row0, QN, S);
  };
  copy_rows<D>(Ks, k + (size_t)b * ksb + h * D, kss, k0, kK, S);
  copy_rows<D>(Vs, v + (size_t)b * vsb + h * D, vss, k0, kK, S);
  load_q_tile(0);
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4], st[QN / 8][4], dpt[QN / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  for (int i = 0; i < n_it; ++i) {
    if (i + 1 < n_it) load_q_tile(i + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int q0 = qstart + i * QN;
    const bf16* Qt = Qs + (i & 1) * TQ;
    const bf16* dOt = dOs + (i & 1) * TQ;
    const float* ls = lse_s + (i & 1) * QN;
    const float* dls = dl_s + (i & 1) * QN;
    mma_abt<D, QN / 8>(st, Ks + 16 * warp * LD, Qt, LD);
    mma_abt<D, QN / 8>(dpt, Vs + 16 * warp * LD, dOt, LD);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_g + 8 * (e / 2);
        const int c = 8 * j + 2 * t + e % 2;
        const int row = q0 + c;
        float p = 0.f, ds = 0.f;
        if (key <= row && row < S && key < S) {
          p = exp2f(st[j][e] * scale_log2 - ls[c] * kLog2e);
          ds = p * (dpt[j][e] - dls[c]);
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    mma_pb<QN, D / 8>(acc_v, st, dOt, LD);
    mma_pb<QN, D / 8>(acc_k, dpt, Qt, LD);
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  store_rows<D>(dk + (size_t)b * S * rs + h * D, rs, key_g, S, acc_k, scale);
  store_rows<D>(dv + (size_t)b * S * rs + h * D, rs, key_g, S, acc_v, 1.f);
}

// ---------------------------------------------------------------------------
// f32 kernels (CUDA cores) and the launches
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int S, int H, int qsb, int qss, int ksb,
           int kss, int vsb, int vss, float scale) {
  fwd_simt<float, D>(q, k, v, o, lse, S, H, qsb, qss, ksb, kss, vsb, vss,
                     scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, int S, int H,
          int qsb, int qss, int ksb, int kss, int vsb, int vss, float scale) {
  dq_simt<float, D>(q, k, v, o, dout, lse, delta, dq, S, H, qsb, qss, ksb,
                    kss, vsb, vss, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int H,
            int qsb, int qss, int ksb, int kss, int vsb, int vss,
            float scale) {
  dkdv_simt<float, D>(q, k, v, dout, lse, delta, dk, dv, S, H, qsb, qss, ksb,
                      kss, vsb, vss, scale);
}

// Launch `kernel` with `bytes` of dynamic shared memory (above the 48 KB
// default, so the limit is raised first).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, int bytes, dim3 grid,
                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, st>>>(args...);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, fetched at run time so that the
// library links against the runtime only
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of one bf16 [B, S, H * D] operand (batch stride sb, row stride ss
// elements, both multiples of 8): boxes of 64 lanes x `rows` rows of one
// batch row, 128-byte swizzle; rows past S read as 0.
cudaError_t head_map(CUtensorMap* map, const void* x, int B, int S, int H,
                     int D, int sb, int ss, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <typename T> constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, int qsb, int qss, int ksb,
                int kss, int vsb, int vss, float scale, cudaStream_t st) {
  if constexpr (kIsBf16<T>) {
    CUtensorMap tq, tk, tv;
    cudaError_t err;
    if ((err = head_map(&tq, q, B, S, H, D, qsb, qss, kFwdRows)) ||
        (err = head_map(&tk, k, B, S, H, D, ksb, kss, kFwdKeys)) ||
        (err = head_map(&tv, v, B, S, H, D, vsb, vss, kFwdKeys)))
      return err;
    return launch(fwd_tma_kernel<D>, kFwdThreads, FwdSmem<D>::kBytes,
                  dim3((S + kFwdRows - 1) / kFwdRows, H, B), st, tq, tk, tv,
                  static_cast<bf16*>(o), static_cast<float*>(lse), S, H,
                  scale * kLog2e);
  } else {
    return launch(fwd_kernel<D>, kThreads, 4 * fwd_simt_floats<D>(),
                  dim3((S + kQ - 1) / kQ, H, B), st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<float*>(lse), S, H, qsb, qss, ksb, kss, vsb,
                  vss, scale);
  }
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, int B, int S, int H, int qsb,
                   int qss, int ksb, int kss, int vsb, int vss, float scale,
                   cudaStream_t st) {
  auto run = [&](auto kernel, int bytes) {
    return launch(kernel, kThreads, bytes, dim3((S + kQ - 1) / kQ, H, B), st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(o),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<float*>(delta), static_cast<T*>(dq), S, H, qsb,
                  qss, ksb, kss, vsb, vss, scale);
  };
  if constexpr (kIsBf16<T>)
    return run(dq_ring_kernel<D>, dq_ring_bytes<D>());
  else
    return run(dq_kernel<D>, 4 * dq_simt_floats<D>());
}

template <typename T, int D>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int H, int qsb,
                     int qss, int ksb, int kss, int vsb, int vss,
                     float scale, cudaStream_t st) {
  auto run = [&](auto kernel, int bytes, int keys) {
    return launch(kernel, kThreads, bytes, dim3((S + keys - 1) / keys, H, B),
                  st, static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), S, H, qsb, qss, ksb, kss, vsb, vss,
                  scale);
  };
  if constexpr (kIsBf16<T>)
    return run(dkdv_ring_kernel<D>, dkdv_ring_bytes<D>(), kK);
  else
    return run(dkdv_kernel<D>, 4 * dkdv_simt_floats<D>(), kKB);
}

}  // namespace
}  // namespace train_attention

using train_attention::bwd_dkdv;
using train_attention::bwd_dq;
using train_attention::fwd;


// C entry points, one set per input dtype; D must be 64 or 128. Strides are
// in elements: (qsb, qss) the batch and row strides of q, likewise k and v.
#define TRAIN_ATTENTION_ENTRIES(SUFFIX, T)                                     \
  extern "C" cudaError_t train_attention_fwd_##SUFFIX(                         \
      const void* q, const void* k, const void* v, void* o, void* lse, int B,  \
      int S, int H, int D, int qsb, int qss, int ksb, int kss, int vsb,        \
      int vss, float scale, void* stream) {                                    \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (D == 64)                                                               \
      return fwd<T, 64>(q, k, v, o, lse, B, S, H, qsb, qss, ksb, kss, vsb,     \
                        vss, scale, st);                                       \
    if (D == 128)                                                              \
      return fwd<T, 128>(q, k, v, o, lse, B, S, H, qsb, qss, ksb, kss, vsb,    \
                         vss, scale, st);                                      \
    return cudaErrorInvalidValue;                                              \
  }                                                                            \
  extern "C" cudaError_t train_attention_dq_##SUFFIX(                          \
      const void* q, const void* k, const void* v, const void* o,              \
      const void* dout, const void* lse, void* delta, void* dq, int B, int S,  \
      int H, int D, int qsb, int qss, int ksb, int kss, int vsb, int vss,      \
      float scale, void* stream) {                                             \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (D == 64)                                                               \
      return bwd_dq<T, 64>(q, k, v, o, dout, lse, delta, dq, B, S, H, qsb,     \
                           qss, ksb, kss, vsb, vss, scale, st);                \
    if (D == 128)                                                              \
      return bwd_dq<T, 128>(q, k, v, o, dout, lse, delta, dq, B, S, H, qsb,    \
                            qss, ksb, kss, vsb, vss, scale, st);               \
    return cudaErrorInvalidValue;                                              \
  }                                                                            \
  extern "C" cudaError_t train_attention_dkdv_##SUFFIX(                        \
      const void* q, const void* k, const void* v, const void* dout,           \
      const void* lse, const void* delta, void* dk, void* dv, int B, int S,    \
      int H, int D, int qsb, int qss, int ksb, int kss, int vsb, int vss,      \
      float scale, void* stream) {                                             \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                 \
    if (D == 64)                                                               \
      return bwd_dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, qsb,  \
                             qss, ksb, kss, vsb, vss, scale, st);              \
    if (D == 128)                                                              \
      return bwd_dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, H,      \
                              qsb, qss, ksb, kss, vsb, vss, scale, st);        \
    return cudaErrorInvalidValue;                                              \
  }

TRAIN_ATTENTION_ENTRIES(bf16, __nv_bfloat16)
TRAIN_ATTENTION_ENTRIES(f32, float)


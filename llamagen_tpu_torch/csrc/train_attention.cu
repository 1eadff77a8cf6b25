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
// (1.3 MB at S = 576); a Hopper block has 227 KB of shared memory. So the
// query rows are tiled (64 per block), key tiles are walked up to the
// diagonal only (tiles above it are skipped), and the forward takes two
// passes over the keys: the first finds each row's max and sum, the second
// forms p = exp(s - lse) exactly normalised, rounds it to T as the TPU
// kernel does, and multiplies by v. The per-row log-sum-exp [B, H, S] f32 is
// the residual the backward reads. The backward is two kernels and needs no
// atomics: `dq` (one block per query tile; it also writes delta), then `dkdv`
// (one block per key tile, walking the query tiles at or below the
// diagonal).
//
// Layout: q, k, v are read in place with a batch and a row stride each (v is
// a view into the wqkv output, row stride 3F), the head at lane offset h * D.
// o, do, dq, dk, dv are dense [B, S, H, D]. No transposes.
//
// What bounds it on the H100: arithmetic. At GPT-L (B 32, S 576, H 16,
// D 64) the forward is ~33 GFLOP with its second pass, the backward ~76;
// the bytes (q, k, v, o, do and the gradients, ~0.5 GB) are small beside
// that. So bf16 inputs run on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums; each warp 16 rows of the tile, the score tile in
// registers), and f32 inputs, which the tensor cores would round, on the
// CUDA cores in f32 (each thread a register micro-tile of 8 or 4 rows by 4
// columns of f32 shared-memory tiles). Each of the three kernels holds both
// bodies and picks one by the input type. wgmma, TMA and a pipelined,
// single-pass forward are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
extern __shared__ __align__(16) unsigned char dyn_smem[];

constexpr int kThreads = 128;  // 8 row groups (ty) x 16 column lanes (tx)
constexpr int kQ = 64;         // query rows per tile
constexpr int kK = 64;         // key rows per tile (forward, dq)
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
// Tensor cores (bf16 inputs): mma.sync.m16n8k16, bf16 operands, f32 sums.
// Each warp owns 16 rows of the block's tile (queries in fwd and dq, keys in
// dkdv). A score tile lives in registers in the mma's accumulator layout;
// p and ds are rounded to bf16 as they are packed into the next product's
// A operand -- the TPU kernel's casts. Tiles sit in shared memory as bf16,
// rows padded by 8 elements (16 bytes) so the 8 rows a fragment load
// touches fall in distinct banks; the operands that the second product
// reads along their rows (v in fwd, k in dq, q and do in dkdv) are also
// stored transposed.
// ---------------------------------------------------------------------------

constexpr int kPad = 8;    // bf16 row padding
constexpr int kKT = 64;    // keys per dkdv block on tensor cores (4 x 16)

template <typename T>
constexpr bool kTensorCores = std::is_same<T, bf16>::value;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Rows [row0, row0 + n) of one head into dst[n][ld] (bf16 pairs); past S: 0.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int rs, int row0, int n, int S) {
  for (int i = threadIdx.x; i < n * D / 2; i += kThreads) {
    const int r = i / (D / 2), c = 2 * (i % (D / 2));
    const int s = row0 + r;
    *reinterpret_cast<uint32_t*>(dst + r * ld + c) =
        s < S ? ld32(src + (size_t)s * rs + c) : 0u;
  }
}
// The same rows transposed: dst[d][ld], dst[d * ld + r] = row r, lane d.
template <int D>
__device__ __forceinline__ void load_rows_t(bf16* dst, int ld,
                                            const bf16* src, int rs, int row0,
                                            int n, int S) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    dst[d * ld + r] = s < S ? src[(size_t)s * rs + d] : __float2bfloat16(0.f);
  }
}

// acc[j] (16 x 8 tile j) = A[16][KD] . Bm[8j .. 8j + 7][KD]^T; A and Bm are
// row-major bf16 in shared memory. Fragment layouts of m16n8k16 (g = lane /
// 4, t = lane % 4): A rows g and g + 8, k pairs 2t and 2t + 8; B column g,
// k pairs 2t and 2t + 8; acc[j][e] at row g + 8 (e / 2), column 2t + e % 2.
template <int KD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* A,
                                        int lda, const bf16* Bm, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    const uint32_t a[4] = {ld32(A + g * lda + kk + 2 * t),
                           ld32(A + (g + 8) * lda + kk + 2 * t),
                           ld32(A + g * lda + kk + 8 + 2 * t),
                           ld32(A + (g + 8) * lda + kk + 8 + 2 * t)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* bp = Bm + (8 * j + g) * ldb + kk + 2 * t;
      mma_bf16(acc[j], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[n] += P[16][KN] . Bt[8n .. 8n + 7][KN]^T, P an accumulator-layout
// register tile (KN / 8 tiles of 16 x 8), rounded to bf16 as it is packed
// into A fragments: tiles 2m and 2m + 1 form the k block m.
template <int KN, int NT>
__device__ __forceinline__ void mma_pbt(float (&acc)[NT][4],
                                        const float (&p)[KN / 8][4],
                                        const bf16* Bt, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < KN / 16; ++m) {
    const uint32_t a[4] = {pack_bf16(p[2 * m][0], p[2 * m][1]),
                           pack_bf16(p[2 * m][2], p[2 * m][3]),
                           pack_bf16(p[2 * m + 1][0], p[2 * m + 1][1]),
                           pack_bf16(p[2 * m + 1][2], p[2 * m + 1][3])};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* bp = Bt + (8 * n + g) * ldb + 16 * m + 2 * t;
      mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
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

template <int D> constexpr int fwd_mma_bytes() {
  return 2 * (2 * kQ * (D + kPad) + D * (kK + kPad));
}
template <int D> constexpr int dq_mma_bytes() {
  return 2 * (4 * kQ * (D + kPad) + D * (kK + kPad)) + 2 * kQ * 4;
}
// dkdv walks 32 query rows at a time at D = 128 (64 at D = 64), so that its
// four accumulator tiles fit in registers
template <int D> constexpr int kDkdvQ = D == 128 ? 32 : 64;
template <int D> constexpr int dkdv_mma_bytes() {
  constexpr int QN = kDkdvQ<D>;
  return 2 * (2 * kKT * (D + kPad) + 2 * QN * (D + kPad) +
              2 * D * (QN + kPad)) + 2 * QN * 4;
}

template <int D>
__device__ __forceinline__ void fwd_mma(const bf16* __restrict__ q,
                                        const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        bf16* __restrict__ o,
                                        float* __restrict__ lse, int S, int H,
                                        int qsb, int qss, int ksb, int kss,
                                        int vsb, int vss, float scale) {
  constexpr int LD = D + kPad, LT = kK + kPad;
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem);  // [kQ][LD]
  bf16* Ks = Qs + kQ * LD;                        // [kK][LD]
  bf16* Vt = Ks + kK * LD;                        // [D][LT]
  const int nqt = (S + kQ - 1) / kQ;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kQ;
  const int row_g = q0 + 16 * warp + g;  // this lane's rows: row_g, row_g + 8
  const bf16* kb = k + (size_t)b * ksb + h * D;
  const bf16* vb = v + (size_t)b * vsb + h * D;
  const bf16* Qw = Qs + 16 * warp * LD;
  load_rows<D>(Qs, LD, q + (size_t)b * qsb + h * D, qss, q0, kQ, S);

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, s[kK / 8][4];
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_rows<D>(Ks, LD, kb, kss, kt * kK, kK, S);
    __syncthreads();
    mma_abt<D, kK / 8>(s, Qw, LD, Ks, LD);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_g + 8 * r;
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < kK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kt * kK + 8 * j + 2 * t + c;
          float& x = s[j][2 * r + c];
          x = (key <= row && key < S) ? x * scale : kNeg;
          tmax = fmaxf(tmax, x);
        }
      const float m_new = fmaxf(m[r], max4(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kK / 8; ++j)
        sum += expf(s[j][2 * r] - m_new) + expf(s[j][2 * r + 1] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + sum4(sum);
      m[r] = m_new;
    }
  }
  float row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = m[r] + logf(l[r]);
    const int row = row_g + 8 * r;
    if (t == 0 && row < S) lse[((size_t)b * H + h) * S + row] = row_lse[r];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_rows<D>(Ks, LD, kb, kss, kt * kK, kK, S);
    load_rows_t<D>(Vt, LT, vb, vss, kt * kK, kK, S);
    __syncthreads();
    mma_abt<D, kK / 8>(s, Qw, LD, Ks, LD);
#pragma unroll
    for (int j = 0; j < kK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + 8 * (e / 2);
        const int key = kt * kK + 8 * j + 2 * t + e % 2;
        s[j][e] = (key <= row && key < S)
                      ? expf(s[j][e] * scale - row_lse[e / 2]) : 0.f;
      }
    mma_pbt<kK, D / 8>(acc, s, Vt, LT);
  }
  store_rows<D>(o + (size_t)b * S * H * D + h * D, H * D, row_g, S, acc,
                1.f);
}

template <int D>
__device__ __forceinline__ void dq_mma(const bf16* __restrict__ q,
                                       const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       const bf16* __restrict__ o,
                                       const bf16* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       float* __restrict__ delta,
                                       bf16* __restrict__ dq, int S, int H,
                                       int qsb, int qss, int ksb, int kss,
                                       int vsb, int vss, float scale) {
  constexpr int LD = D + kPad, LT = kK + kPad;
  bf16* Qs = reinterpret_cast<bf16*>(dyn_smem);  // [kQ][LD]
  bf16* dOs = Qs + kQ * LD;                       // [kQ][LD]
  bf16* Ks = dOs + kQ * LD;                       // [kK][LD]
  bf16* Vs = Ks + kK * LD;                        // [kK][LD]
  bf16* Kt = Vs + kK * LD;                        // [D][LT]
  float* lse_s = reinterpret_cast<float*>(Kt + D * LT);  // [kQ]
  float* dl_s = lse_s + kQ;                               // [kQ]
  const int nqt = (S + kQ - 1) / kQ;
  const int qt = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * kQ;
  const int rs = H * D;
  const int row_g = q0 + 16 * warp + g;
  const bf16* kb = k + (size_t)b * ksb + h * D;
  const bf16* vb = v + (size_t)b * vsb + h * D;
  load_rows<D>(Qs, LD, q + (size_t)b * qsb + h * D, qss, q0, kQ, S);
  load_rows<D>(dOs, LD, dout + (size_t)b * S * rs + h * D, rs, q0, kQ, S);
  __syncthreads();
  {  // delta = rowsum(do * o) in f32: two lanes per row, half a row each
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const int row = q0 + r;
    float part = 0.f;
    if (row < S) {
      const bf16* orow = o + ((size_t)b * S + row) * rs + h * D;
      for (int d = half * D / 2; d < (half + 1) * D / 2; ++d)
        part += __bfloat162float(dOs[r * LD + d]) * __bfloat162float(orow[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      const size_t at = ((size_t)b * H + h) * S + row;
      dl_s[r] = part;
      lse_s[r] = row < S ? lse[at] : 0.f;
      if (row < S) delta[at] = part;
    }
  }
  __syncthreads();
  float row_lse[2], row_dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = lse_s[16 * warp + g + 8 * r];
    row_dl[r] = dl_s[16 * warp + g + 8 * r];
  }

  float acc[D / 8][4], s[kK / 8][4], dp[kK / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_rows<D>(Ks, LD, kb, kss, kt * kK, kK, S);
    load_rows<D>(Vs, LD, vb, vss, kt * kK, kK, S);
    load_rows_t<D>(Kt, LT, kb, kss, kt * kK, kK, S);
    __syncthreads();
    mma_abt<D, kK / 8>(s, Qs + 16 * warp * LD, LD, Ks, LD);
    mma_abt<D, kK / 8>(dp, dOs + 16 * warp * LD, LD, Vs, LD);
#pragma unroll
    for (int j = 0; j < kK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_g + 8 * (e / 2);
        const int key = kt * kK + 8 * j + 2 * t + e % 2;
        float ds = 0.f;
        if (key <= row && key < S && row < S)
          ds = expf(s[j][e] * scale - row_lse[e / 2]) *
               (dp[j][e] - row_dl[e / 2]);
        s[j][e] = ds;
      }
    mma_pbt<kK, D / 8>(acc, s, Kt, LT);
  }
  store_rows<D>(dq + (size_t)b * S * rs + h * D, rs, row_g, S, acc, scale);
}

template <int D>
__device__ __forceinline__ void dkdv_mma(const bf16* __restrict__ q,
                                         const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const bf16* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, int S, int H,
                                         int qsb, int qss, int ksb, int kss,
                                         int vsb, int vss, float scale) {
  constexpr int QN = kDkdvQ<D>;
  constexpr int LD = D + kPad, LT = QN + kPad;
  bf16* Ks = reinterpret_cast<bf16*>(dyn_smem);  // [kKT][LD]
  bf16* Vs = Ks + kKT * LD;                       // [kKT][LD]
  bf16* Qs = Vs + kKT * LD;                       // [QN][LD]
  bf16* dOs = Qs + QN * LD;                       // [QN][LD]
  bf16* Qt = dOs + QN * LD;                       // [D][LT]
  bf16* dOt = Qt + D * LT;                        // [D][LT]
  float* lse_s = reinterpret_cast<float*>(dOt + D * LT);  // [QN]
  float* dl_s = lse_s + QN;                                // [QN]
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kKT;
  const int rs = H * D;
  const int key_g = k0 + 16 * warp + g;  // this lane's keys: key_g, key_g + 8
  const bf16* qb = q + (size_t)b * qsb + h * D;
  const bf16* db = dout + (size_t)b * S * rs + h * D;
  const float* lse_b = lse + ((size_t)b * H + h) * S;
  const float* dl_b = delta + ((size_t)b * H + h) * S;
  load_rows<D>(Ks, LD, k + (size_t)b * ksb + h * D, kss, k0, kKT, S);
  load_rows<D>(Vs, LD, v + (size_t)b * vsb + h * D, vss, k0, kKT, S);

  float acc_k[D / 8][4], acc_v[D / 8][4], st[QN / 8][4], dpt[QN / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  for (int q0 = k0 - k0 % QN; q0 < S; q0 += QN) {
    __syncthreads();
    load_rows<D>(Qs, LD, qb, qss, q0, QN, S);
    load_rows<D>(dOs, LD, db, rs, q0, QN, S);
    load_rows_t<D>(Qt, LT, qb, qss, q0, QN, S);
    load_rows_t<D>(dOt, LT, db, rs, q0, QN, S);
    for (int i = threadIdx.x; i < QN; i += kThreads) {
      lse_s[i] = q0 + i < S ? lse_b[q0 + i] : 0.f;
      dl_s[i] = q0 + i < S ? dl_b[q0 + i] : 0.f;
    }
    __syncthreads();
    // scores transposed: rows are this warp's 16 keys, columns the queries
    mma_abt<D, QN / 8>(st, Ks + 16 * warp * LD, LD, Qs, LD);
    mma_abt<D, QN / 8>(dpt, Vs + 16 * warp * LD, LD, dOs, LD);
#pragma unroll
    for (int j = 0; j < QN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_g + 8 * (e / 2);
        const int c = 8 * j + 2 * t + e % 2;
        const int row = q0 + c;
        float p = 0.f, ds = 0.f;
        if (key <= row && row < S && key < S) {
          p = expf(st[j][e] * scale - lse_s[c]);
          ds = p * (dpt[j][e] - dl_s[c]);
        }
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    mma_pbt<QN, D / 8>(acc_v, st, dOt, LT);
    mma_pbt<QN, D / 8>(acc_k, dpt, Qt, LT);
  }
  store_rows<D>(dk + (size_t)b * S * rs + h * D, rs, key_g, S, acc_k, scale);
  store_rows<D>(dv + (size_t)b * S * rs + h * D, rs, key_g, S, acc_v, 1.f);
}

// ---------------------------------------------------------------------------
// The three kernels: bf16 on tensor cores, f32 on CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S, int H, int qsb, int qss, int ksb,
           int kss, int vsb, int vss, float scale) {
  if constexpr (kTensorCores<T>)
    fwd_mma<D>(q, k, v, o, lse, S, H, qsb, qss, ksb, kss, vsb, vss, scale);
  else
    fwd_simt<T, D>(q, k, v, o, lse, S, H, qsb, qss, ksb, kss, vsb, vss,
                   scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int S, int H,
          int qsb, int qss, int ksb, int kss, int vsb, int vss,
          float scale) {
  if constexpr (kTensorCores<T>)
    dq_mma<D>(q, k, v, o, dout, lse, delta, dq, S, H, qsb, qss, ksb, kss,
              vsb, vss, scale);
  else
    dq_simt<T, D>(q, k, v, o, dout, lse, delta, dq, S, H, qsb, qss, ksb, kss,
                  vsb, vss, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int H, int qsb,
            int qss, int ksb, int kss, int vsb, int vss, float scale) {
  if constexpr (kTensorCores<T>)
    dkdv_mma<D>(q, k, v, dout, lse, delta, dk, dv, S, H, qsb, qss, ksb, kss,
                vsb, vss, scale);
  else
    dkdv_simt<T, D>(q, k, v, dout, lse, delta, dk, dv, S, H, qsb, qss, ksb,
                    kss, vsb, vss, scale);
}

// Launch `kernel` with `bytes` of dynamic shared memory (above the 48 KB
// default, so the limit is raised first).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int bytes, dim3 grid, cudaStream_t st,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, st>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, int qsb, int qss, int ksb,
                int kss, int vsb, int vss, float scale, cudaStream_t st) {
  const int bytes = kTensorCores<T> ? fwd_mma_bytes<D>()
                                    : 4 * fwd_simt_floats<D>();
  return launch(fwd_kernel<T, D>, bytes, dim3((S + kQ - 1) / kQ, H, B), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), S, H, qsb, qss, ksb, kss, vsb, vss,
                scale);
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, int B, int S, int H, int qsb,
                   int qss, int ksb, int kss, int vsb, int vss, float scale,
                   cudaStream_t st) {
  const int bytes = kTensorCores<T> ? dq_mma_bytes<D>()
                                    : 4 * dq_simt_floats<D>();
  return launch(dq_kernel<T, D>, bytes, dim3((S + kQ - 1) / kQ, H, B), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(o),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<float*>(delta), static_cast<T*>(dq), S, H, qsb,
                qss, ksb, kss, vsb, vss, scale);
}

template <typename T, int D>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int H, int qsb,
                     int qss, int ksb, int kss, int vsb, int vss,
                     float scale, cudaStream_t st) {
  const int keys = kTensorCores<T> ? kKT : kKB;
  const int bytes = kTensorCores<T> ? dkdv_mma_bytes<D>()
                                    : 4 * dkdv_simt_floats<D>();
  return launch(dkdv_kernel<T, D>, bytes, dim3((S + keys - 1) / keys, H, B),
                st, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), S, H, qsb, qss, ksb, kss, vsb, vss,
                scale);
}

}  // namespace

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

// W4A16 matmul: out[B, N] = x[B, K] @ dequant(int4 blocks, f32 scales).
//
// Replaces the Pallas kernel llamagen_tpu/ops/w4_matmul.py::w4_matmul (body
// `_w4_kernel`, pallas_call at w4_matmul.py:315). Layout (`pack_w4`):
// blocks [NB, K/2, BN] int8, one byte per (packed row i, column): the low
// nibble is weight row i, the high nibble weight row i + K/2, both
// two's-complement int4. Scales are [NB, 1, BN] f32 (per channel) or
// [NB, 2 * NSEG, BN] f32 (grouped: group g of half h covers weight rows
// h * K/2 + [g * seg_rows, (g + 1) * seg_rows), the last one ragged).
// Numerics as the Pallas body's default "seg" mode: x is rounded to bf16,
// products and sums are f32, a group's scale multiplies the f32 partial
// sum of its rows (per channel: the scale multiplies the whole sum), and
// the result is rounded once to x's dtype. Here a scale multiplies the
// partial sums of 8 packed rows, a piece of one group, and the pieces are
// added; that differs from one sum per group only by f32 rounding.
//
// What bounds it on the H100: reading the packed weights. At decode batch
// (B = 16 for batch 8 + CFG, 80 in a k = 4 verify) the product does 4 * B
// flops per packed byte, far below the ~295 flop/byte where the tensor
// cores would become the limit. GPT-L reads ~6.4 MB of packed int4 per
// layer and step (154 MB per step, ~46 us at 3.35 TB/s), half of W8A16.
//
// What the design does about it: the dequantised matrix never exists, the
// packed bytes are read once per 16 batch rows, and every byte serves two
// weight rows. Each lane owns two adjacent output columns, so a warp reads
// 64 contiguous bytes of a packed row; a block owns 64 columns (inside one
// BN block) x 16 batch rows. K is split across blocks (grid z) so that even
// N = 1024 gives ~2 blocks per SM; a block first stages its split's x (both
// halves, rounded to bf16, as f32) in shared memory, then its eight warps
// take 8 packed rows each of a 64-row chunk, the next chunk's weight bytes
// loaded into registers while the current one is multiplied. A second
// kernel sums the splits' f32 partials in order, then scales (per channel)
// and rounds. Tensor cores, TMA and wider loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 64;       // output columns per block: 32 lanes x 2
constexpr int kRows = 16;       // batch rows per block
constexpr int kChunk = 64;      // packed rows per round (8 per warp)
constexpr int kPerWarp = kChunk / kWarps;
constexpr int kMaxSplit = 256;  // packed rows one block stages
constexpr int kXStride = 20;    // padded f32 row of staged x (16-byte aligned)
constexpr int kThreads = kWarps * 32;
constexpr int kSmem = 2 * kMaxSplit * kXStride;  // floats; >= the reduction
static_assert(kSmem >= kWarps * kRows * kCols, "reduction buffer");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float to_bf16_f32(float v) { return bf16_round(v); }
__device__ __forceinline__ float to_bf16_f32(__nv_bfloat16 v) {
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

// The two int4 levels of one packed byte.
__device__ __forceinline__ float lo_nibble(int8_t v) {
  return static_cast<float>(((v & 0x0F) ^ 8) - 8);
}
__device__ __forceinline__ float hi_nibble(int8_t v) {
  return static_cast<float>(static_cast<int>(v) >> 4);
}

// seg_rows == 0: per-channel scales (R == 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
w4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ blocks,
                 const float* __restrict__ scales, T* __restrict__ out,
                 float* __restrict__ partial_out, int B, int K2, int N,
                 int BN, int R, int seg_rows, int k_per_split) {
  __shared__ __align__(16) float smem[kSmem];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kCols + 2 * lane;  // this lane's column pair
  const int b0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - b0);
  const bool live = n < N;  // N is a multiple of BN, BN of 64
  const int blk = n / BN, c = n % BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K2, k_begin + k_per_split);
  const int span = k_end - k_begin;
  const int8_t* wcol = blocks + (size_t)blk * K2 * BN + c;

  // Stage x for this split: rows [0, span) hold x[:, k_begin + i] (weights
  // in low nibbles), rows [span, 2 span) x[:, K2 + k_begin + i] (high
  // nibbles); each row holds the 16 batch rows, zero past B.
  float(*xs)[kXStride] = reinterpret_cast<float(*)[kXStride]>(smem);
  for (int i = threadIdx.x; i < kRows * 2 * span; i += kThreads) {
    const int r = i / (2 * span), kk = i % (2 * span);
    const int col = kk < span ? k_begin + kk : K2 + k_begin + kk - span;
    xs[kk][r] = r < rows ? to_bf16_f32(x[(size_t)(b0 + r) * 2 * K2 + col])
                         : 0.f;
  }
  __syncthreads();

  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;

  // A warp's 8 packed rows of a chunk lie inside one group (group starts
  // are multiples of 64); rows past k_end load as zero.
  char2 wv[kPerWarp], wnext[kPerWarp];
  auto load = [&](char2* wd, int kc) {
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int k = kc + warp * kPerWarp + j;
      wd[j] = (live && k < k_end)
                  ? *reinterpret_cast<const char2*>(wcol + (size_t)k * BN)
                  : make_char2(0, 0);
    }
  };
  load(wv, k_begin);

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    if (kc + kChunk < k_end) load(wnext, kc + kChunk);
    const int k0 = kc + warp * kPerWarp;  // the same for the whole warp
    if (k0 < k_end) {
      float plo[kRows][2], phi[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        plo[r][0] = plo[r][1] = phi[r][0] = phi[r][1] = 0.f;
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const float l0 = lo_nibble(wv[j].x), l1 = lo_nibble(wv[j].y);
        const float h0 = hi_nibble(wv[j].x), h1 = hi_nibble(wv[j].y);
        const int kk = k0 - k_begin + j;
        const float4* xl = reinterpret_cast<const float4*>(xs[kk]);
        const float4* xh = reinterpret_cast<const float4*>(xs[span + kk]);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 a = xl[q], h = xh[q];
          plo[4 * q + 0][0] += a.x * l0; plo[4 * q + 0][1] += a.x * l1;
          plo[4 * q + 1][0] += a.y * l0; plo[4 * q + 1][1] += a.y * l1;
          plo[4 * q + 2][0] += a.z * l0; plo[4 * q + 2][1] += a.z * l1;
          plo[4 * q + 3][0] += a.w * l0; plo[4 * q + 3][1] += a.w * l1;
          phi[4 * q + 0][0] += h.x * h0; phi[4 * q + 0][1] += h.x * h1;
          phi[4 * q + 1][0] += h.y * h0; phi[4 * q + 1][1] += h.y * h1;
          phi[4 * q + 2][0] += h.z * h0; phi[4 * q + 2][1] += h.z * h1;
          phi[4 * q + 3][0] += h.w * h0; phi[4 * q + 3][1] += h.w * h1;
        }
      }
      if (seg_rows == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] += plo[r][0] + phi[r][0];
          acc[r][1] += plo[r][1] + phi[r][1];
        }
      } else {
        const int g = k0 / seg_rows;
        float2 slo = make_float2(0.f, 0.f), shi = slo;
        if (live) {
          slo = *reinterpret_cast<const float2*>(
              scales + ((size_t)blk * R + g) * BN + c);
          shi = *reinterpret_cast<const float2*>(
              scales + ((size_t)blk * R + R / 2 + g) * BN + c);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] += plo[r][0] * slo.x + phi[r][0] * shi.x;
          acc[r][1] += plo[r][1] * slo.y + phi[r][1] * shi.y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) wv[j] = wnext[j];
  }

  // Sum the eight warps' partials (the x stage is reused for them).
  __syncthreads();
  float(*part)[kRows][kCols] = reinterpret_cast<float(*)[kRows][kCols]>(smem);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    part[warp][r][2 * lane] = acc[r][0];
    part[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, cc = i % kCols;
    const int col = blockIdx.x * kCols + cc;
    if (r < rows && col < N) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += part[wi][r][cc];
      if (partial_out != nullptr)
        partial_out[((size_t)blockIdx.z * B + b0 + r) * N + col] = s;
      else  // per-channel scales [NB, 1, BN] are indexed by the column
        out[(size_t)(b0 + r) * N + col] =
            from_f32<T>(seg_rows == 0 ? s * scales[col] : s);
    }
  }
}

// Split-K epilogue: sum the splits' f32 partials in order, scale (per
// channel), round.
template <typename T>
__global__ void finish_kernel(const float* __restrict__ partial,
                              const float* __restrict__ scales,
                              T* __restrict__ out, int B, int N, int splits,
                              bool per_channel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * B * N + i];
  out[i] = from_f32<T>(per_channel ? s * scales[i % N] : s);
}

template <typename T>
cudaError_t launch(const void* x, const void* blocks, const void* scales,
                   void* out, void* partial, int B, int K2, int N, int BN,
                   int R, int seg_rows, int k_per_split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K2 + k_per_split - 1) / k_per_split;
  const bool per_channel = seg_rows == 0;
  if (k_per_split % kChunk != 0 || k_per_split > kMaxSplit ||
      BN % kCols != 0 || N % BN != 0 || (per_channel != (R == 1)) ||
      (!per_channel && seg_rows % kChunk != 0) ||
      (splits > 1) != (partial != nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid(N / kCols, (B + kRows - 1) / kRows, splits);
  w4_matmul_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(blocks),
      static_cast<const float*>(scales), static_cast<T*>(out),
      static_cast<float*>(partial), B, K2, N, BN, R, seg_rows, k_per_split);
  if (splits > 1)
    finish_kernel<T><<<(B * N + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial),
        static_cast<const float*>(scales), static_cast<T*>(out), B, N, splits,
        per_channel);
  return cudaGetLastError();
}

}  // namespace

// Pointers: x [B, 2 * K2], blocks [NB, K2, BN] int8, scales [NB, R, BN] f32,
// out [B, N], partial (f32 [splits, B, N] workspace, null when K is not
// split). seg_rows: the group size, 0 for per-channel scales (R == 1). K2 is
// split into blocks of k_per_split packed rows (a multiple of 64, <= 256).
extern "C" cudaError_t w4_matmul_bf16(const void* x, const void* blocks,
                                      const void* scales, void* out,
                                      void* partial, int B, int K2, int N,
                                      int BN, int R, int seg_rows,
                                      int k_per_split, void* stream) {
  return launch<__nv_bfloat16>(x, blocks, scales, out, partial, B, K2, N, BN,
                               R, seg_rows, k_per_split, stream);
}

extern "C" cudaError_t w4_matmul_f32(const void* x, const void* blocks,
                                     const void* scales, void* out,
                                     void* partial, int B, int K2, int N,
                                     int BN, int R, int seg_rows,
                                     int k_per_split, void* stream) {
  return launch<float>(x, blocks, scales, out, partial, B, K2, N, BN, R,
                       seg_rows, k_per_split, stream);
}

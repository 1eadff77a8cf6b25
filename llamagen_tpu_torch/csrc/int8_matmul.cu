// W8A16 matmul: out[B, N] = (x[B, K] @ w_q[K, N]) * scale[N].
//
// Replaces the Pallas kernel llamagen_tpu/ops/quant_matmul.py::int8_matmul
// (body `_kernel`, pallas_call at quant_matmul.py:62), and on this card also
// the XLA fusion that `matmul_any` relies on there (quant_matmul.py:239-241):
// the int8 -> float conversion happens in registers, so the dequantised
// weight matrix never exists in device memory. x is bf16 or f32; the sum is
// f32; the per-output-channel f32 scale multiplies the f32 sum, and the
// result is rounded once to x's dtype, as the Pallas body does.
//
// What bounds it on the H100: reading the weights. At decode batch
// (B = 16 rows for batch 8 + CFG) the product does 2*B flops per weight
// byte, far below the ~295 flop/byte where the tensor cores would become the
// limit, so the kernel is a weight stream: GPT-L reads ~12.9 MB of int8 per
// layer and step, ~308 MB per step (~92 us at 3.35 TB/s).
//
// What the design does about it: each lane owns two adjacent output
// columns, so a warp reads 64 contiguous weight bytes per K row and every
// weight byte is read exactly once per 16 batch rows. A block owns 64
// columns x 16 batch rows; its eight warps take 16 K rows each of a 128-row
// chunk, with x for the chunk staged in shared memory as f32 (a K row's 16
// activations are four broadcast 16-byte loads). The next chunk's weights
// and activations are loaded into registers while the current one is
// multiplied. K is split across blocks (grid z) so that even N = 1024 gives
// ~2 blocks per SM; a second kernel sums the splits' f32 partials in order,
// then scales and rounds. Tensor cores (mma/wgmma), TMA and wider loads are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 64;    // output columns per block: 32 lanes x 2
constexpr int kRows = 16;    // batch rows per block
constexpr int kChunk = 128;  // K rows staged per round (16 per warp)
constexpr int kXStride = 20; // padded f32 row of staged x (16-byte aligned)
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = kChunk / kWarps;                // K rows per warp
constexpr int kXPerThread = kRows * kChunk / kThreads;   // staged x values

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ partial_out, int B, int K, int N,
                   int k_per_split) {
  __shared__ __align__(16) float xs[kChunk][kXStride];
  __shared__ float partial[kWarps][kRows][kCols];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kCols + 2 * lane;  // this lane's column pair
  const int b0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - b0);
  const bool live = n < N;  // N is even: a live lane owns a full pair
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;

  // Weights (a warp's 16 K rows of the chunk) and activations (the block's
  // 16 x 128 tile) are loaded into registers one chunk ahead of their use,
  // every load of a chunk issued together: the block waits for memory about
  // once per chunk, overlapped with the previous chunk's arithmetic. Rows
  // past k_end and batch rows past B load as zero.
  char2 wv[kPerWarp], wnext[kPerWarp];
  float xv[kXPerThread], xnext[kXPerThread];
  auto load = [&](char2* wd, float* xd, int kc) {
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int k = kc + warp * kPerWarp + j;
      wd[j] = (live && k < k_end)
                  ? *reinterpret_cast<const char2*>(w + (size_t)k * N + n)
                  : make_char2(0, 0);
    }
#pragma unroll
    for (int it = 0; it < kXPerThread; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / kChunk, k = kc + i % kChunk;
      xd[it] = (r < rows && k < k_end)
                   ? to_f32(x[(size_t)(b0 + r) * K + k]) : 0.f;
    }
  };
  load(wv, xv, k_begin);

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
#pragma unroll
    for (int it = 0; it < kXPerThread; ++it) {
      const int i = it * kThreads + threadIdx.x;
      xs[i % kChunk][i / kChunk] = xv[it];
    }
    __syncthreads();
    if (kc + kChunk < k_end) load(wnext, xnext, kc + kChunk);
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const float w0 = static_cast<float>(wv[j].x);
      const float w1 = static_cast<float>(wv[j].y);
      const float4* xr =
          reinterpret_cast<const float4*>(xs[warp * kPerWarp + j]);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 v = xr[q];
        acc[4 * q + 0][0] += v.x * w0; acc[4 * q + 0][1] += v.x * w1;
        acc[4 * q + 1][0] += v.y * w0; acc[4 * q + 1][1] += v.y * w1;
        acc[4 * q + 2][0] += v.z * w0; acc[4 * q + 2][1] += v.z * w1;
        acc[4 * q + 3][0] += v.w * w0; acc[4 * q + 3][1] += v.w * w1;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) wv[j] = wnext[j];
#pragma unroll
    for (int it = 0; it < kXPerThread; ++it) xv[it] = xnext[it];
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    partial[warp][r][2 * lane] = acc[r][0];
    partial[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int col = blockIdx.x * kCols + c;
    if (r < rows && col < N) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += partial[wi][r][c];
      if (partial_out == nullptr)
        out[(size_t)(b0 + r) * N + col] = from_f32<T>(s * scale[col]);
      else
        partial_out[((size_t)blockIdx.z * B + b0 + r) * N + col] = s;
    }
  }
}

// Split-K epilogue: sum the K splits' f32 partials in order, scale, round.
template <typename T>
__global__ void finish_kernel(const float* __restrict__ partial,
                              const float* __restrict__ scale,
                              T* __restrict__ out, int B, int N, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * B * N + i];
  out[i] = from_f32<T>(s * scale[i % N]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   void* partial, int B, int K, int N, int k_per_split,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (K + k_per_split - 1) / k_per_split;
  if (k_per_split % kChunk != 0 || (splits > 1) != (partial != nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, (B + kRows - 1) / kRows, splits);
  int8_matmul_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(partial), B, K, N, k_per_split);
  if (splits > 1)
    finish_kernel<T><<<(B * N + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(scale),
        static_cast<T*>(out), B, N, splits);
  return cudaGetLastError();
}

}  // namespace

// Pointers: x, w_q, scale, out, partial (f32 [splits, B, N] workspace, null
// when K is not split). K is split into blocks of k_per_split rows (a
// multiple of 128).
extern "C" cudaError_t int8_matmul_bf16(const void* x, const void* w,
                                        const void* scale, void* out,
                                        void* partial, int B, int K, int N,
                                        int k_per_split, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, out, partial, B, K, N,
                               k_per_split, stream);
}

extern "C" cudaError_t int8_matmul_f32(const void* x, const void* w,
                                       const void* scale, void* out,
                                       void* partial, int B, int K, int N,
                                       int k_per_split, void* stream) {
  return launch<float>(x, w, scale, out, partial, B, K, N, k_per_split,
                       stream);
}

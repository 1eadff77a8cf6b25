// W8A16 matmul: out[B, N] = (x[B, K] @ w_q[K, N]) * scale[N].
//
// Replaces the Pallas kernel llamagen_tpu/ops/quant_matmul.py::int8_matmul
// (body `_kernel`, pallas_call at quant_matmul.py:62), and on this card also
// the XLA fusion that `matmul_any` relies on there (quant_matmul.py:239-241):
// the int8 -> bf16 conversion happens in registers, so the dequantised
// weight matrix never exists in device memory. x is bf16 or f32; the sum is
// f32; the per-output-channel f32 scale multiplies the f32 sum, and the
// result is rounded once to x's dtype, as the Pallas body does.
//
// What bounds it on the H100: reading the weights once. At decode batch
// (B = 16 rows for batch 8 + CFG) the product does 2 * B flops per weight
// byte, far below the ~295 flop/byte where the tensor cores would become the
// limit. A GPT-L layer matrix is 1-3 MB of int8 (8-24 KB per SM), so a call
// is one round trip to memory plus the launch: the design starts every load
// of a block at once and makes one launch.
//
// What the design does about it (csrc/w4_matmul.cu's, for int8 levels):
//   - Output columns on M, batch rows on N of `mma.sync.m16n8k16` (bf16 in,
//     f32 accumulate): a block owns 64 columns and a range of K rows for ALL
//     batch rows (looping over passes of <= 96 rows with the weights kept in
//     shared memory), so every weight byte is read by exactly one block
//     whatever B is.
//   - The block's weights, scales and x come in with 16-byte `cp.async`
//     loads, all started up front (narrower synchronous copies only where N
//     or K leaves rows unaligned: N % 16 != 0, K % 8 != 0).
//   - The levels go straight into the A fragment: since a product sums over
//     k in any order, fragment k slots (2t, 2t+1, 2t+8, 2t+9) of lane (g, t)
//     stand for K rows 4t..4t+3 and fragment rows g, g+8 of the warp's two
//     m-tiles for columns 4g..4g+3. A lane reads one 32-bit word (4 columns)
//     of each of 4 rows; `prmt` pairs a column's bytes, and two masks and one
//     bf16x2 fma turn them into bf16 levels, exactly (kernel_util.cuh::
//     i8x2_bf16x2). x is staged as bf16 rows and read 8 bytes a lane (the
//     same 4 rows) as the B fragment.
//   - f32 x keeps f32 semantics: x is split into three bf16 pieces (x1 =
//     bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), whose sum is x to
//     ~2^-24); each piece times an int8 level is exact, and the three
//     products go into the same f32 accumulator.
//   - Where N alone gives too few blocks, the K rows are split across the
//     blocks of a thread block cluster (<= 8, along grid x). Each block
//     pushes its f32 partial into the shared memory of the blocks that sum it
//     (distributed shared memory; rank j sums the j-th 1/ks of the [B, 64]
//     tile), and one cluster barrier later every block sums its part in rank
//     order, scales and stores it: one launch, no workspace in device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "kernel_util.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace kutil;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPass = 96;           // batch rows per pass
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;       // 227 KB, the H100's per-block limit

// Shared memory of one block over `cols` columns: weight rows (padded by 16
// bytes), scales, x (one bf16 plane, three for f32 x), and the slots that
// receive the cluster's f32 partials of the columns this block sums
// (bc * cols / 4 float4 units over the ranks, + kMaxCluster for rounding).
// Mirrored by ops/quant_matmul.py::_smem_bytes.
__host__ __device__ inline int smem_bytes(int kb, int bc, int planes,
                                          int cols) {
  return kb * (cols + 16) + cols * 4 + planes * bc * x_stride(kb) * 2 +
         (bc * (cols / 4) + kMaxCluster) * 16;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// f32 x -> its three bf16 pieces (bits), x1 + x2 + x3 ~ x
__device__ __forceinline__ void split3(float v, uint16_t (&o)[3]) {
  const __nv_bfloat16 a = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(a);
  const __nv_bfloat16 b = __float2bfloat16_rn(r1);
  const float r2 = r1 - __bfloat162float(b);
  o[0] = __bfloat16_as_ushort(a);
  o[1] = __bfloat16_as_ushort(b);
  o[2] = bf16_bits(r2);
}

// Stage x[b0 + r, k0 + j] as bf16 at xs[(p * bc + r) * xstr + j] (plane p
// of 1, or of 3 for f32 x) for r < rows8, j < kb; zero past B (r >= rows)
// and past the block's live rows (j >= kbe).
template <typename T>
__device__ void stage_x(const T* __restrict__ x, __nv_bfloat16* xs, int b0,
                        int rows, int rows8, int K, int k0, int kb, int kbe,
                        int bc, bool vec) {
  const int xstr = x_stride(kb);
  // (row, chunk) pairs over all threads, the pair advanced by increments
  const int per_row = vec ? kb / 8 : kb;  // chunks (or elements) of a row
  const int drr = kThreads / per_row, dch = kThreads % per_row;
  int r = threadIdx.x / per_row, ch = threadIdx.x % per_row;
  for (int i = threadIdx.x; i < rows8 * per_row; i += kThreads) {
    __nv_bfloat16* dst = xs + r * xstr;
    const T* src = x + static_cast<size_t>(b0 + r) * K + k0;
    if (vec) {  // K % 8 == 0: whole 8-element chunks, 16-byte aligned
      const bool live = r < rows && ch * 8 < kbe;
      if constexpr (sizeof(T) == 2) {
        cp_async<16>(dst + ch * 8, live ? src + ch * 8 : x, live ? 16 : 0);
      } else {
        float v[8] = {};
        if (live) {
          const float4 a = *reinterpret_cast<const float4*>(src + ch * 8);
          const float4 c = *reinterpret_cast<const float4*>(src + ch * 8 + 4);
          v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
          v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
        }
        uint16_t pc[8][3];
#pragma unroll
        for (int e = 0; e < 8; ++e) split3(v[e], pc[e]);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint4 u;
          u.x = pc[0][p] | (static_cast<uint32_t>(pc[1][p]) << 16);
          u.y = pc[2][p] | (static_cast<uint32_t>(pc[3][p]) << 16);
          u.z = pc[4][p] | (static_cast<uint32_t>(pc[5][p]) << 16);
          u.w = pc[6][p] | (static_cast<uint32_t>(pc[7][p]) << 16);
          *reinterpret_cast<uint4*>(dst + p * bc * xstr + ch * 8) = u;
        }
      }
    } else {  // any K: one element at a time
      const bool live = r < rows && ch < kbe;
      if constexpr (sizeof(T) == 2) {
        reinterpret_cast<uint16_t*>(dst)[ch] =
            live ? __bfloat16_as_ushort(src[ch]) : uint16_t{0};
      } else {
        uint16_t pc[3];
        split3(live ? static_cast<float>(src[ch]) : 0.f, pc);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          reinterpret_cast<uint16_t*>(dst + p * bc * xstr)[ch] = pc[p];
      }
    }
    r += drr;
    ch += dch;
    if (ch >= per_row) {
      ch -= per_row;
      ++r;
    }
  }
}

// grid (ks, ceil(N / COLS)), cluster (ks, 1, 1): block (rank, tile) owns
// columns [COLS tile, COLS tile + COLS) and K rows [rank * kb, rank * kb +
// kb) for every batch row. A warp owns 32 columns (two m-tiles) and one
// group of batch rows: COLS 64 keeps more blocks for a small N, COLS 128
// reads whole 128-byte lines and keeps all 8 warps busy at 16 batch rows. vec: N % 16 == 0 and K % 8 == 0 with 16-byte
// aligned bases (16-byte copies); otherwise narrower synchronous copies.
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, T* __restrict__ out, int B,
                int K, int N, int kb, int bc, bool vec_w, bool vec_x) {
  constexpr int kPlanes = sizeof(T) == 4 ? 3 : 1;
  constexpr int kCols = COLS;
  constexpr int kWRow = kCols + 16;      // padded shared row of weight bytes
  constexpr int kColPairs = kCols / 32;  // a warp's two m-tiles: 32 columns
  constexpr int kBatchGroups = kWarps / kColPairs;
  constexpr int kMaxNT = kMaxPass / (8 * kBatchGroups);  // n-tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, ks = gridDim.x;
  const int col0 = blockIdx.y * kCols;
  const int k0 = rank * kb;
  const int kbe = min(kb, K - k0);  // live K rows (>= 1)

  unsigned char* ws = smem;
  float* ss = reinterpret_cast<float*>(smem + kb * kWRow);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ss + kCols);
  const int xstr = x_stride(kb);
  float4* red = reinterpret_cast<float4*>(xs + kPlanes * bc * xstr);
  // this block may receive pushes once every rank has arrived here
  cluster_arrive_relaxed();
  bool first = true;

  // Weight rows (zero past the live rows and past N) and the block's
  // scales.
  if (vec_w) {
    for (int i = threadIdx.x; i < kb * (kCols / 16); i += kThreads) {
      const int r = i / (kCols / 16), ch = i % (kCols / 16);
      const bool live = r < kbe && col0 + ch * 16 < N;
      cp_async<16>(ws + r * kWRow + ch * 16,
                   live ? w + static_cast<size_t>(k0 + r) * N + col0 + ch * 16
                        : w,
                   live ? 16 : 0);
    }
    if (threadIdx.x < kCols / 4) {
      const bool live = col0 + threadIdx.x * 4 < N;
      cp_async<16>(ss + threadIdx.x * 4,
                   live ? scale + col0 + threadIdx.x * 4 : scale,
                   live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kb * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      ws[r * kWRow + c] =
          r < kbe && col0 + c < N
              ? static_cast<unsigned char>(
                    w[static_cast<size_t>(k0 + r) * N + col0 + c])
              : 0;
    }
    if (threadIdx.x < kCols)
      ss[threadIdx.x] =
          col0 + threadIdx.x < N ? scale[col0 + threadIdx.x] : 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cp = warp % kColPairs, bg = warp / kColPairs;
  const unsigned char* wl = ws + (4 * t) * kWRow + cp * 32 + 4 * g;
  const int steps = (kbe + 15) / 16;

  for (int b0 = 0; b0 < B; b0 += bc) {
    const int rows = min(bc, B - b0), nt = (rows + 7) / 8;
    const int slots = (nt * 8 * (kCols / 4) + ks - 1) / ks;  // per rank
    stage_x<T>(x, xs, b0, rows, nt * 8, K, k0, kb, kbe, bc, vec_x);
    cp_async_wait_all();
    __syncthreads();

    float tot[2][kMaxNT][4] = {};
    if (bg < nt) {
      const __nv_bfloat16* xl = xs + (bg * 8 + g) * xstr + 4 * t;
#pragma unroll 2
      for (int s = 0; s < steps; ++s) {
        const unsigned char* wp = wl + 16 * s * kWRow;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + kWRow);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wp + 2 * kWRow);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wp + 3 * kWRow);
        uint32_t af[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {  // m-tile m: columns 4g + 2m, +1
          af[m][0] = i8x2_bf16x2(prmt(w0, w1, 0x0400u + 0x0202u * m));
          af[m][1] = i8x2_bf16x2(prmt(w0, w1, 0x0501u + 0x0202u * m));
          af[m][2] = i8x2_bf16x2(prmt(w2, w3, 0x0400u + 0x0202u * m));
          af[m][3] = i8x2_bf16x2(prmt(w2, w3, 0x0501u + 0x0202u * m));
        }
#pragma unroll
        for (int n = 0; n < kMaxNT; ++n) {
          if (bg + n * kBatchGroups >= nt) break;
          const int off = n * kBatchGroups * 8 * xstr + 16 * s;
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            const uint2 bx =
                *reinterpret_cast<const uint2*>(xl + p * bc * xstr + off);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma(tot[m][n], af[m], bx.x, bx.y);
          }
        }
      }
      // Push this pass's partial to the ranks that sum it: float4 unit
      // u = b * 16 + column / 4 goes to rank u / slots, slot (my rank,
      // u % slots), so a warp's stores land in one or two ranks, contiguous.
      if (first) cluster_wait();  // every rank has started
#pragma unroll
      for (int n = 0; n < kMaxNT; ++n) {
        const int nn = bg + n * kBatchGroups;
        if (nn >= nt) break;
        const int u = (nn * 8 + 2 * t) * (kCols / 4) + cp * 8 + g;
        const int u1 = u + kCols / 4;  // batch row + 1
        *cluster.map_shared_rank(red + rank * slots + u % slots,
                                 u / slots) =
            make_float4(tot[0][n][0], tot[0][n][2], tot[1][n][0],
                        tot[1][n][2]);
        *cluster.map_shared_rank(red + rank * slots + u1 % slots,
                                 u1 / slots) =
            make_float4(tot[0][n][1], tot[0][n][3], tot[1][n][1],
                        tot[1][n][3]);
      }
    } else if (first) {
      cluster_wait();
    }
    first = false;
    cluster_arrive();  // release: this block's pushes
    cluster_wait();    // acquire: every push into this block

    // sum the slots of this rank's units in rank order, scale, round
    for (int i = threadIdx.x; i < slots; i += kThreads) {
      const int u = rank * slots + i;
      if (u >= rows * (kCols / 4)) break;
      float4 v = red[i];
      for (int q = 1; q < ks; ++q) {
        const float4 p = red[q * slots + i];
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      const int b = u / (kCols / 4), c = 4 * (u % (kCols / 4));
      v.x *= ss[c]; v.y *= ss[c + 1]; v.z *= ss[c + 2]; v.w *= ss[c + 3];
      T* o = out + static_cast<size_t>(b0 + b) * N + col0 + c;
      if (vec_w && col0 + c + 4 <= N) {
        store4(o, v);
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int q = 0; q < 4 && col0 + c + q < N; ++q) store1(o + q, e[q]);
      }
    }
    // a next pass pushes into the slots only after every rank read them
    if (b0 + bc < B) cluster.sync();
  }
}

template <typename T, int COLS>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   void* out, int B, int K, int N, int ks, int kb, int bc,
                   void* stream) {
  const int planes = sizeof(T) == 4 ? 3 : 1;
  const int smem = smem_bytes(kb, bc, planes, COLS);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B < 1 || K < 1 || N < 2 || N % 2 != 0 || kb % 16 != 0 || ks < 1 ||
      ks > kMaxCluster || static_cast<long>(ks - 1) * kb >= K ||
      static_cast<long>(ks) * kb < K || bc < 8 || bc % 8 != 0 ||
      bc > kMaxPass || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = int8_mma_kernel<T, COLS>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (N + COLS - 1) / COLS, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec_w = N % 16 == 0 && aligned(w) && aligned(scale) &&
                     aligned(out);
  const bool vec_x = K % 8 == 0 && aligned(x);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                            static_cast<const int8_t*>(w),
                            static_cast<const float*>(scale),
                            static_cast<T*>(out), B, K, N, kb, bc, vec_w,
                            vec_x);
}

template <typename T>
cudaError_t launch_cols(const void* x, const void* w, const void* scale,
                        void* out, int B, int K, int N, int cols, int ks,
                        int kb, int bc, void* stream) {
  if (cols == 64)
    return launch<T, 64>(x, w, scale, out, B, K, N, ks, kb, bc, stream);
  if (cols == 128)
    return launch<T, 128>(x, w, scale, out, B, K, N, ks, kb, bc, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Pointers: x [B, K], w_q [K, N] int8, scale [N] f32, out [B, N]. Geometry
// from ops/quant_matmul.py::int8_geometry: cols (64 or 128) output columns
// a block, ks blocks per cluster, each over kb K rows (a multiple of 16),
// batch rows in passes of bc (a multiple of 8, <= 96). Returns
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" cudaError_t int8_matmul_bf16(const void* x, const void* w,
                                        const void* scale, void* out, int B,
                                        int K, int N, int cols, int ks,
                                        int kb, int bc, void* stream) {
  return launch_cols<__nv_bfloat16>(x, w, scale, out, B, K, N, cols, ks, kb,
                                    bc, stream);
}

extern "C" cudaError_t int8_matmul_f32(const void* x, const void* w,
                                       const void* scale, void* out, int B,
                                       int K, int N, int cols, int ks, int kb,
                                       int bc, void* stream) {
  return launch_cols<float>(x, w, scale, out, B, K, N, cols, ks, kb, bc,
                            stream);
}

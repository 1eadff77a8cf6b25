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
// products are exact in f32 (int4 levels and bf16 x are both exact in
// bf16), each group's rows are summed in an f32 accumulator of its own that
// its scale then multiplies before it is added to the total (per channel:
// the scale multiplies the total once), and the result is rounded once to
// x's dtype.
//
// What bounds it on the H100: reading the packed weights once. At decode
// batch (B = 16 for batch 8 + CFG, 80 in a k = 4 verify) the product does
// 4 * B flops per packed byte, far below the ~295 flop/byte where the
// tensor cores would become the limit. A GPT-L layer matrix is 0.5-1.6 MB
// of packed int4 (4-12 KB per SM), so a call is one round trip to memory
// plus the launch: the design starts every load of a block at once and
// makes one launch.
//
// What the design does about it:
//   - Output columns on M, batch rows on N of `mma.sync.m16n8k16` (bf16 in,
//     f32 accumulate): a block owns 64 columns and a range of packed rows
//     for ALL batch rows (looping over passes of <= 96 rows with the weights
//     kept in shared memory), so every packed byte is read by exactly one
//     block whatever B is.
//   - The block's weights, scales and x come in with 16-byte `cp.async`
//     loads, all started up front (a block's share fits in shared memory).
//   - The int4 levels are decoded in registers straight into the A
//     fragment: since a product sums over k in any order, fragment k slots
//     (2t, 2t+1, 2t+8, 2t+9) of lane (g, t) stand for packed rows 4t..4t+3
//     and fragment rows g, g+8 of the warp's two m-tiles for columns
//     4g..4g+3. A lane then reads one 32-bit word (4 columns) of each of 4
//     packed rows; `prmt` pairs the bytes of one column, and a mask, an xor
//     and one bf16x2 fma turn each nibble into its level (the bf16 bit
//     pattern 0x4300 | (u ^ 8) is 128 + level + 8). One packed byte feeds
//     two products: its low nibble against x[:, i], its high nibble against
//     x[:, K/2 + i]. x is staged as bf16 rows and read 8 bytes a lane (the
//     same 4 packed rows) as the B fragment.
//   - Where N alone gives too few blocks, the packed rows are split across
//     the blocks of a thread block cluster (<= 8, along grid x; each block's
//     range a whole number of groups). Each block pushes its f32 partial
//     into the shared memory of the blocks that sum it (distributed shared
//     memory; rank j sums the j-th 1/ks of the [B, 64] tile), and one
//     cluster barrier later every block sums its part in rank order and
//     stores it: one launch, no workspace in device memory.

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
constexpr int kCols = 64;              // output columns per block
constexpr int kWRow = kCols + 16;      // padded shared row of packed bytes
constexpr int kColPairs = kCols / 32;  // a warp's two m-tiles span 32 columns
constexpr int kBatchGroups = kWarps / kColPairs;
constexpr int kMaxNT = 3;              // 8-row n-tiles per warp and pass
constexpr int kMaxPass = kBatchGroups * kMaxNT * 8;  // 96 batch rows
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;       // 227 KB, the H100's per-block limit

// Shared memory of one block: packed rows, scales, x (two halves), and the
// slots that receive the cluster's f32 partials of the columns this block
// sums (bc * 16 float4 units over the ranks, + kMaxCluster for rounding).
// Mirrored by ops/w4_matmul.py::_smem_bytes.
__host__ __device__ inline int smem_bytes(int kb, int bc, int ngb,
                                          bool grouped) {
  const int scales = (grouped ? 2 * ngb : 1) * kCols * 4;
  return kb * kWRow + scales + 2 * bc * x_stride(kb) * 2 +
         (bc * (kCols / 4) + kMaxCluster) * 16;
}

// Two nibbles (bits 0-3 and 16-19 of q) -> bf16x2 levels in [-8, 7]:
// 0x4300 | (u ^ 8) is the bf16 128 + level + 8; subtract 136 exactly.
__device__ __forceinline__ uint32_t levels(uint32_t q) {
  const uint32_t m = (q & 0x000F000Fu) ^ 0x43084308u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(m), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// Stage x[b0 + r, h * K2 + k0 + j] as bf16 at xs[(h * bc + r) * xs_stride
// + j] for r < rows8, j < kb; zero past B (r >= rows) and past the block's
// live rows (j >= kbe).
template <typename T>
__device__ void stage_x(const T* __restrict__ x, __nv_bfloat16* xs, int b0,
                        int rows, int rows8, int K2, int k0, int kb, int kbe,
                        int bc, bool vec) {
  const int xstr = x_stride(kb);
  const size_t K = 2 * static_cast<size_t>(K2);
  // (row, chunk) pairs over all threads, the pair advanced by increments
  // (rows rr: half h = rr >= rows8, batch row rr - h * rows8)
  const int per_row = vec ? kb / 8 : kb;  // chunks (or elements) of a row
  const int drr = kThreads / per_row, dch = kThreads % per_row;
  int rr = threadIdx.x / per_row, ch = threadIdx.x % per_row;
  for (int i = threadIdx.x; i < 2 * rows8 * per_row; i += kThreads) {
    const int h = rr >= rows8, r = rr - h * rows8;
    __nv_bfloat16* dst = xs + (h * bc + r) * xstr;
    const T* src = x + (b0 + r) * K + h * K2 + k0;
    if (vec) {  // K2 % 8 == 0: whole 8-element chunks, 16-byte aligned
      const bool live = r < rows && ch * 8 < kbe;
      if constexpr (sizeof(T) == 2) {
        cp_async<16>(dst + ch * 8, live ? src + ch * 8 : x, live ? 16 : 0);
      } else {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
        if (live) {
          a = *reinterpret_cast<const float4*>(src + ch * 8);
          c = *reinterpret_cast<const float4*>(src + ch * 8 + 4);
        }
        uint4 u;
        u.x = bf16_bits(a.x) | (static_cast<uint32_t>(bf16_bits(a.y)) << 16);
        u.y = bf16_bits(a.z) | (static_cast<uint32_t>(bf16_bits(a.w)) << 16);
        u.z = bf16_bits(c.x) | (static_cast<uint32_t>(bf16_bits(c.y)) << 16);
        u.w = bf16_bits(c.z) | (static_cast<uint32_t>(bf16_bits(c.w)) << 16);
        *reinterpret_cast<uint4*>(dst + ch * 8) = u;
      }
    } else {  // any K2: one element at a time
      reinterpret_cast<uint16_t*>(dst)[ch] =
          r < rows && ch < kbe ? bf16_bits(src[ch]) : uint16_t{0};
    }
    rr += drr;
    ch += dch;
    if (ch >= per_row) {
      ch -= per_row;
      ++rr;
    }
  }
}

// grid (ks, N / 64), cluster (ks, 1, 1): block (rank, tile) owns columns
// [64 tile, 64 tile + 64) and packed rows [rank * kb, rank * kb + kb) for
// every batch row. seg: the group size (grouped), kb a multiple of it.
template <typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
w4_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ blocks,
              const float* __restrict__ scales, T* __restrict__ out, int B,
              int K2, int N, int BN, int R, int seg, int kb, int bc,
              bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x, ks = gridDim.x;
  const int col0 = blockIdx.y * kCols;
  const int blk = col0 / BN, c0 = col0 % BN;
  const int k0 = rank * kb;
  const int kbe = min(kb, K2 - k0);  // live packed rows (>= 1)
  const int ngb = kGrouped ? kb / seg : 1;

  unsigned char* ws = smem;
  float* ss = reinterpret_cast<float*>(smem + kb * kWRow);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      ss + (kGrouped ? 2 * ngb : 1) * kCols);
  const int xstr = x_stride(kb);
  float4* red = reinterpret_cast<float4*>(xs + 2 * bc * xstr);
  // this block may receive pushes once every rank has arrived here
  cluster_arrive_relaxed();
  bool first = true;

  // Packed rows (zero past the live rows: level 0 in both nibbles) and the
  // block's scales, 16 bytes a copy.
  for (int i = threadIdx.x; i < kb * (kCols / 16); i += kThreads) {
    const int r = i / (kCols / 16), ch = i % (kCols / 16);
    const bool live = r < kbe;
    const int8_t* src =
        blocks + (live ? (static_cast<size_t>(blk) * K2 + k0 + r) * BN + c0 +
                             ch * 16
                       : size_t{0});
    cp_async<16>(ws + r * kWRow + ch * 16, src, live ? 16 : 0);
  }
  if (kGrouped) {
    const int g0 = k0 / seg, half = R / 2;
    for (int i = threadIdx.x; i < 2 * ngb * (kCols / 4); i += kThreads) {
      const int ch = i % (kCols / 4), j = (i / (kCols / 4)) % ngb;
      const int h = i / (ngb * (kCols / 4));
      const bool live = g0 + j < half;
      const float* src =
          scales + (live ? (static_cast<size_t>(blk) * R + h * half + g0 +
                            j) * BN + c0 + ch * 4
                         : size_t{0});
      cp_async<16>(ss + (h * ngb + j) * kCols + ch * 4, src, live ? 16 : 0);
    }
  } else if (threadIdx.x < kCols / 4) {
    cp_async<16>(ss + threadIdx.x * 4, scales + col0 + threadIdx.x * 4, 16);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cp = warp % kColPairs, bg = warp / kColPairs;
  const unsigned char* wl = ws + (4 * t) * kWRow + cp * 32 + 4 * g;
  const int steps = (kbe + 15) / 16;
  const int seg_steps = kGrouped ? seg / 16 : steps;

  for (int b0 = 0; b0 < B; b0 += bc) {
    const int rows = min(bc, B - b0), nt = (rows + 7) / 8;
    const int slots = (nt * 8 * (kCols / 4) + ks - 1) / ks;  // per rank
    stage_x<T>(x, xs, b0, rows, nt * 8, K2, k0, kb, kbe, bc, vec);
    cp_async_wait_all();
    __syncthreads();

    float tot[2][kMaxNT][4] = {};
    if (bg < nt) {
      const __nv_bfloat16* xl = xs + (bg * 8 + g) * xstr + 4 * t;
      const __nv_bfloat16* xh = xl + bc * xstr;
      for (int s0 = 0, grp = 0; s0 < steps; s0 += seg_steps, ++grp) {
        float alo[2][kMaxNT][4] = {}, ahi[2][kMaxNT][4] = {};
        const int s1 = min(steps, s0 + seg_steps);
#pragma unroll 2
        for (int s = s0; s < s1; ++s) {
          const unsigned char* wp = wl + 16 * s * kWRow;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wp + kWRow);
          const uint32_t w2 =
              *reinterpret_cast<const uint32_t*>(wp + 2 * kWRow);
          const uint32_t w3 =
              *reinterpret_cast<const uint32_t*>(wp + 3 * kWRow);
          uint32_t lo[2][4], hi[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {  // m-tile m: columns 4g + 2m, +1
            const uint32_t q[4] = {prmt(w0, w1, 0x0400u + 0x0101u * 2 * m),
                                   prmt(w0, w1, 0x0501u + 0x0101u * 2 * m),
                                   prmt(w2, w3, 0x0400u + 0x0101u * 2 * m),
                                   prmt(w2, w3, 0x0501u + 0x0101u * 2 * m)};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              lo[m][e] = levels(q[e]);
              hi[m][e] = levels(q[e] >> 4);
            }
          }
#pragma unroll
          for (int n = 0; n < kMaxNT; ++n) {
            if (bg + n * kBatchGroups >= nt) break;
            const int off = n * kBatchGroups * 8 * xstr + 16 * s;
            const uint2 bl = *reinterpret_cast<const uint2*>(xl + off);
            const uint2 bh = *reinterpret_cast<const uint2*>(xh + off);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              if (kGrouped) {
                mma(alo[m][n], lo[m], bl.x, bl.y);
                mma(ahi[m][n], hi[m], bh.x, bh.y);
              } else {
                mma(tot[m][n], lo[m], bl.x, bl.y);
                mma(tot[m][n], hi[m], bh.x, bh.y);
              }
            }
          }
        }
        if (kGrouped) {  // the group's scales times its accumulators
          const float4 sl = *reinterpret_cast<const float4*>(
              ss + grp * kCols + cp * 32 + 4 * g);
          const float4 sh = *reinterpret_cast<const float4*>(
              ss + (ngb + grp) * kCols + cp * 32 + 4 * g);
          const float l4[4] = {sl.x, sl.y, sl.z, sl.w};
          const float h4[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < kMaxNT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)  // e < 2: column 4g + 2m, else +1
                tot[m][n][e] += alo[m][n][e] * l4[2 * m + e / 2] +
                                ahi[m][n][e] * h4[2 * m + e / 2];
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

    // sum the slots of this rank's units in rank order, scale (per
    // channel), round
    for (int i = threadIdx.x; i < slots; i += kThreads) {
      const int u = rank * slots + i;
      if (u >= rows * (kCols / 4)) break;
      float4 v = red[i];
      for (int q = 1; q < ks; ++q) {
        const float4 p = red[q * slots + i];
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      const int b = u / (kCols / 4), c = 4 * (u % (kCols / 4));
      if (!kGrouped) {
        v.x *= ss[c]; v.y *= ss[c + 1]; v.z *= ss[c + 2]; v.w *= ss[c + 3];
      }
      store4(out + static_cast<size_t>(b0 + b) * N + col0 + c, v);
    }
    // a next pass pushes into the slots only after every rank read them
    if (b0 + bc < B) cluster.sync();
  }
}

template <typename T, bool kGrouped>
cudaError_t launch_one(const void* x, const void* blocks, const void* scales,
                       void* out, int B, int K2, int N, int BN, int R,
                       int seg, int ks, int kb, int bc, int smem,
                       cudaStream_t st) {
  auto kernel = w4_mma_kernel<T, kGrouped>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, N / kCols, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec =
      K2 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                            static_cast<const int8_t*>(blocks),
                            static_cast<const float*>(scales),
                            static_cast<T*>(out), B, K2, N, BN, R, seg, kb,
                            bc, vec);
}

template <typename T>
cudaError_t launch(const void* x, const void* blocks, const void* scales,
                   void* out, int B, int K2, int N, int BN, int R,
                   int seg_rows, int ks, int kb, int bc, void* stream) {
  const bool grouped = seg_rows != 0;
  const int ngb = grouped ? kb / seg_rows : 1;
  const int smem = smem_bytes(kb, bc, ngb, grouped);
  const auto ptr_ok = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B < 1 || K2 < 1 || BN % kCols != 0 || N % BN != 0 ||
      grouped == (R == 1) || (grouped && (seg_rows % 16 != 0 ||
                                          kb % seg_rows != 0)) ||
      kb % 16 != 0 || ks < 1 || ks > kMaxCluster ||
      static_cast<long>(ks - 1) * kb >= K2 ||
      static_cast<long>(ks) * kb < K2 || bc < 8 || bc % 8 != 0 ||
      bc > kMaxPass || smem > kMaxSmem || !ptr_ok(blocks) ||
      !ptr_ok(scales) || !ptr_ok(out))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return grouped ? launch_one<T, true>(x, blocks, scales, out, B, K2, N, BN,
                                       R, seg_rows, ks, kb, bc, smem, st)
                 : launch_one<T, false>(x, blocks, scales, out, B, K2, N, BN,
                                        R, seg_rows, ks, kb, bc, smem, st);
}

}  // namespace

// Pointers: x [B, 2 * K2], blocks [NB, K2, BN] int8, scales [NB, R, BN] f32,
// out [B, N]. seg_rows: the group size, 0 for per-channel scales (R == 1).
// Geometry from ops/w4_matmul.py::w4_geometry: ks blocks per cluster, each
// over kb packed rows (a multiple of 16 and of the group size), batch rows
// in passes of bc (a multiple of 8, <= 96). Returns cudaErrorInvalidValue
// for what the kernel does not take.
extern "C" cudaError_t w4_matmul_bf16(const void* x, const void* blocks,
                                      const void* scales, void* out, int B,
                                      int K2, int N, int BN, int R,
                                      int seg_rows, int ks, int kb, int bc,
                                      void* stream) {
  return launch<__nv_bfloat16>(x, blocks, scales, out, B, K2, N, BN, R,
                               seg_rows, ks, kb, bc, stream);
}

extern "C" cudaError_t w4_matmul_f32(const void* x, const void* blocks,
                                     const void* scales, void* out, int B,
                                     int K2, int N, int BN, int R,
                                     int seg_rows, int ks, int kb, int bc,
                                     void* stream) {
  return launch<float>(x, blocks, scales, out, B, K2, N, BN, R, seg_rows, ks,
                       kb, bc, stream);
}

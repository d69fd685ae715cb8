// Attention pieces on Hopper shared by the one-pass forward
// (flash_attention.cu, namespace op), its two-pass wgmma variant (namespace
// wg) and the sublayer backward's one-block kernel (attn_sublayer.cu,
// namespace bwd): wgmma with A from registers, the S = Q K^T products over a
// key capacity, the 4-D head tensor maps and the TMA box loads and stores on
// them, the proxy fence and the warpgroup barrier.  The mbarrier, descriptor
// and smem-operand wgmma helpers they build on are gemm_sm90.cuh's.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_sm90.cuh"

namespace muse {
namespace attn {

using muse::sm90::encode_tiled;
using muse::sm90::smem_desc;
using muse::sm90::smem_u32;
using muse::sm90::wgmma_m64n128k16;
using muse::sm90::wgmma_m64n256k16;
using muse::sm90::wgmma_m64n64k16;

// D (64 x 64 fp32) (+)= A (64 x 16) B: A from registers (each warp its 16
// rows as an mma.sync A fragment), B 16 x 64 from 128-byte-swizzled shared
// memory, K-major (kTransB 0: rows of B's 64 columns) or MN-major (1: rows
// of its 16 k); scale_d 0 overwrites D
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
}

// the same product at N 32: D (64 x 32 fp32, 16 accumulators a thread)
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t a[4], uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
}

// a shared-memory matrix descriptor moved `bytes` (a multiple of 16, inside
// the 256 KB window) further on, computed where it is used: an unrolled
// loop's descriptors then take no register each
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  uint64_t out;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(out) : "l"(desc), "l"(uint64_t(bytes >> 4)));
  return out;
}

// the A fragments of rows r and r + 8 (a warp's 16 rows) of a 64 x 64 bf16
// tile in the 128-byte swizzle, for its four 16-column k steps: register j
// of step kk holds columns 16 kk + 8 (j / 2) + 2 t4, + 1 of row r (j even)
// or r + 8
__device__ __forceinline__ void tile_a_frags(uint32_t (&f)[4][4], const unsigned char* tile, int r,
                                             int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r + 8 * (j & 1), chunk = 2 * kk + (j >> 1);
      f[kk][j] = *reinterpret_cast<const uint32_t*>(tile + row * 128 + ((chunk ^ (row & 7)) << 4) +
                                                    4 * t4);
    }
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kBox = 64 * 128;  // a TMA box: 64 tokens x 64 d of bf16, rows of 128 bytes

// The key capacities instantiated, in 32-key chunks: 1 (up to 32 keys), 3
// (96: the 77 text keys), 8 (256: v2's tokens), 9 (288: 257, v1's and CLIP
// ViT-L/14's).  S's products cover the capacity, none skipped at run time
// (a product under a run-time condition makes ptxas serialise the
// warpgroup's products); keys past Tk are masked.
constexpr int chunks_for(int Tk) { return Tk <= 32 ? 1 : Tk <= 96 ? 3 : Tk <= 256 ? 8 : 9; }

// S (64 x 32, fp32) += A (64 x 16) B: A = Q and B = K, both K-major in
// 128-byte-swizzled shared memory
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b));
}

// one k step (16 of d) of S = Q K^T over the capacity, in few products
// (n256 + n32 at 9; n128 + n128 at 8, whose three warpgroups compile to 128
// registers a thread, too few for an n256 product's operands; n64 + n32; n32);
// K's row r lies 128 r bytes into its stage
template <int kChunks>
__device__ __forceinline__ void scores_step(float* sc, uint32_t qa, uint32_t ks, int kk) {
  const uint64_t a = smem_desc(qa + kk * 32);
  if constexpr (kChunks == 9) {
    wgmma_m64n256k16<0, 0>(sc, a, smem_desc(ks + kk * 32));
    wgmma_m64n32k16(sc + 128, a, smem_desc(ks + 256 * 128 + kk * 32));
  } else if constexpr (kChunks == 8) {
    wgmma_m64n128k16<0, 0>(sc, a, smem_desc(ks + kk * 32));
    wgmma_m64n128k16<0, 0>(sc + 64, a, smem_desc(ks + 128 * 128 + kk * 32));
  } else if constexpr (kChunks == 3) {
    wgmma_m64n64k16<0, 0>(sc, a, smem_desc(ks + kk * 32));
    wgmma_m64n32k16(sc + 32, a, smem_desc(ks + 64 * 128 + kk * 32));
  } else {
    static_assert(kChunks == 1, "a capacity of chunks_for");
    wgmma_m64n32k16(sc, a, smem_desc(ks + kk * 32));
  }
}

// keeps the compiler from reusing the registers of an A operand that an
// asynchronous product may still be reading
template <int kCount>
__device__ __forceinline__ void fence_operands(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// one box of a (D, H, T, B) tensor map (d 0 .. 63 of head h, 64 tokens from
// t, batch row b) into this block's shared memory, completion counted in
// bytes on `bar`; the multicast form writes it, and counts it, at the same
// offsets in every block of the cluster that `mask` names
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                        int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// a box of the O tile from this block's shared memory into (D, H, T, B),
// clipped at D and T; completion tracked by the issuing thread's bulk groups
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, const void* src, int h, int t,
                                              int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(0), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// until the O tiles this thread stored no longer read shared memory
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void tma_box_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                  int h, int t, int b, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(0), "r"(h),
      "r"(t), "r"(b)
      : "memory");
}

// (B, T, H, D) bf16 with d contiguous, heads D apart and batch and token
// strides sb, st in elements, as the 4-D tensor (D, H, T, B) in boxes of 64
// d x one head x 64 tokens, 128-byte swizzle; zeros past D (at 48) and T
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                            int64_t sb, int64_t st) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(st) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace muse

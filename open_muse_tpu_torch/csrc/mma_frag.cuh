// Warp-level tensor-core pieces shared by the attention kernels
// (flash_attention.cu's forward, attn_sublayer.cu's self backward): bf16
// mma.sync m16n8k16 with fp32 accumulators, ldmatrix fragment loads,
// cp.async 16-byte copies, and the quad reductions over the four lanes that
// hold one row of an m16n8 accumulator.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane l = 4 g + t4 holds, of an
// A fragment (16 x 16), rows g and g + 8 at columns 2 t4, + 1 and 2 t4 + 8,
// + 9 (registers 0 - 3: (g, lo), (g + 8, lo), (g, hi), (g + 8, hi)); of a C
// fragment (16 x 8), (c0, c1) row g and (c2, c3) row g + 8 at columns 2 t4,
// + 1.  Two neighbouring C fragments (16 x 16) packed to bf16 are thus one A
// fragment: what a kernel keeps in registers as S or P feeds the next
// product without shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace muse {
namespace frag {

using T = __nv_bfloat16;

constexpr int kRowsPerWarp = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one 32-bit register of two bf16 values, the first in the
// low half (the lower column of an mma fragment)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without staging in registers; bytes 0 copies
// nothing and zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>  // wait until at most kPending committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const T* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const T* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the A fragments of rows r0 and r0 + 8 of a (rows, D) operand with row
// stride st, straight from global memory (zeros past `rows`)
template <int D>
__device__ __forceinline__ void load_a(uint32_t af[D / 16][4], const T* base, int64_t st, int r0,
                                       int rows, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    af[kc][0] = r0 < rows ? *reinterpret_cast<const uint32_t*>(base + r0 * st + c) : 0u;
    af[kc][1] = r1 < rows ? *reinterpret_cast<const uint32_t*>(base + r1 * st + c) : 0u;
    af[kc][2] = r0 < rows ? *reinterpret_cast<const uint32_t*>(base + r0 * st + c + 8) : 0u;
    af[kc][3] = r1 < rows ? *reinterpret_cast<const uint32_t*>(base + r1 * st + c + 8) : 0u;
  }
}

}  // namespace frag
}  // namespace muse

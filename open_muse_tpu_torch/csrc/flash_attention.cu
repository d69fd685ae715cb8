// Multi-head attention over (B, T, H, D) tensors with the TPU kernel's
// precision staging:
//
//   S = (Q K^T) * 1/sqrt(D)           fp32 (bf16 products, fp32 sums)
//   keys at or beyond Tk masked
//   P = exp(S - rowmax) / rowsum      fp32, then cast to the input type
//   O = P V                           fp32 sums, one cast at the end
//
// Replaces the Pallas TPU kernel open_muse_tpu/ops/pallas/flash_attention.py
// `flash_attention` (body `_kernel`), which holds a group of (batch, head)
// pairs' whole K/V in VMEM, pads K/V to 128 lanes and masks the pad.  Neither
// the grouping nor the padding is carried over: here a block owns one
// (batch, head) pair and 64 query rows, and walks K/V in 64-key tiles,
// masking the ragged last tile in place.
//
// What bounds it on the H100: at the paths' shapes (T 257 / 256 x 77, D 48 /
// 64) the bytes (q, k, v read once, o written once: 1.6 MB for v1's
// (1, 257, 16, 48)) and the 4 B H Tq Tk D operations (0.2 GFLOP there) are
// both a microsecond or less; a kernel this small is bound by its launch and
// its few blocks, not by either.
//
// What the design does about it, and about exactness: four warps, each
// holding 16 query rows as mma.sync m16n8k16 A fragments in registers
// (loaded once from device memory); K tiles ([key][d]) and V tiles transposed
// ([d][key]) in padded shared memory, so every B fragment is one 32-bit
// shared load without bank conflicts.  Two passes over the keys keep the
// TPU kernel's staging exact: the first computes each row's max and sum of
// exponentials (online, in fp32), the second recomputes S, forms the
// normalised weights P = exp(S - max) / sum, rounds them to the input type
// as the TPU kernel does before its PV product, and accumulates P V in fp32.
// The rows' statistics never leave registers and S never reaches device
// memory.  Query rows, keys and the batch / token strides are free: q, k and
// v may be views into a fused projection (token stride 3 H D for a packed
// [q | k | v]), with no padding and no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows a block
constexpr int kBlockK = 64;                      // keys a tile
constexpr int kKPad = kBlockK + 8;               // V^T row length in shared memory

using T = __nv_bfloat16;

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

// strides in elements: sb between batch rows, st between tokens; heads are D
// apart and d is contiguous
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H, int Tq, int Tk,
                       int64_t q_sb, int64_t q_st, int64_t k_sb, int64_t k_st, int64_t v_sb,
                       int64_t v_st, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kDPad = D + 8;  // K row length in shared memory
  constexpr int kChunks = D / 8;
  __shared__ __align__(16) T Ks[kBlockK][kDPad];
  __shared__ __align__(16) T Vt[D][kKPad];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qb = q + b * q_sb + int64_t(h) * D;
  const T* kb = k + b * k_sb + int64_t(h) * D;
  const T* vb = v + b * v_sb + int64_t(h) * D;
  const int64_t o_st = int64_t(H) * D;
  T* ob = o + (int64_t(b) * Tq * H + h) * D;

  // this thread's two query rows and their A fragments for Q K^T
  const int r0 = blockIdx.x * kBlockQ + warp * kRowsPerWarp + g, r1 = r0 + 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qf[kc][0] = r0 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_st + c) : 0u;
    qf[kc][1] = r1 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_st + c) : 0u;
    qf[kc][2] = r0 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_st + c + 8) : 0u;
    qf[kc][3] = r1 < Tq ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_st + c + 8) : 0u;
  }

  auto load_k = [&](int j0) {
    for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < Tk) val = *reinterpret_cast<const uint4*>(kb + (j0 + r) * k_st + c);
      *reinterpret_cast<uint4*>(&Ks[r][c]) = val;
    }
  };
  auto load_v = [&](int j0) {
    for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < Tk) val = *reinterpret_cast<const uint4*>(vb + (j0 + r) * v_st + c);
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[c + i][r] = e[i];
    }
  };

  // S for this warp's 16 rows and the tile's 64 keys: s[n] is the m16n8 C
  // fragment of keys n*8 .. n*8+7; (s[n][0], s[n][1]) row g, (s[n][2],
  // s[n][3]) row g+8, columns t4*2 and t4*2+1; masked keys are -inf
  float s[kBlockK / 8][4];
  auto scores = [&](int j0) {
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kc * 16 + t4 * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kc * 16 + t4 * 2 + 8]);
        mma16816(s[n], qf[kc], bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + n * 8 + t4 * 2 + (e & 1);
        s[n][e] = key < Tk ? s[n][e] * scale : -INFINITY;
      }
    }
  };

  // pass 1: each row's max and sum of exp(S - max), online over the tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Tk; j0 += kBlockK) {
    __syncthreads();
    load_k(j0);
    __syncthreads();
    scores(j0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));  // finite: a tile holds a key < Tk
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n)
        sum += expf(s[n][2 * r] - m_new) + expf(s[n][2 * r + 1] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + quad_sum(sum);
      m[r] = m_new;
    }
  }

  // pass 2: P = exp(S - max) / sum in the input type, O += P V in fp32
  float acc[kChunks][4];
#pragma unroll
  for (int n = 0; n < kChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += kBlockK) {
    __syncthreads();
    load_k(j0);
    load_v(j0);
    __syncthreads();
    scores(j0);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      // the A fragment of P for keys kk*16 .. kk*16+15: C fragments 2kk, 2kk+1
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        pa[2 * half] = pack2(__fdiv_rn(expf(s[n][0] - m[0]), l[0]),
                                __fdiv_rn(expf(s[n][1] - m[0]), l[0]));
        pa[2 * half + 1] = pack2(__fdiv_rn(expf(s[n][2] - m[1]), l[1]),
                                    __fdiv_rn(expf(s[n][3] - m[1]), l[1]));
      }
#pragma unroll
      for (int n = 0; n < kChunks; ++n) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Vt[n * 8 + g][kk * 16 + t4 * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Vt[n * 8 + g][kk * 16 + t4 * 2 + 8]);
        mma16816(acc[n], pa, bf);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < Tq) *reinterpret_cast<uint32_t*>(ob + r0 * o_st + c) = pack2(acc[n][0], acc[n][1]);
    if (r1 < Tq) *reinterpret_cast<uint32_t*>(ob + r1 * o_st + c) = pack2(acc[n][2], acc[n][3]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Tq, int Tk,
           const int64_t* strides, float scale, cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  flash_attention_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Tq, Tk, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], scale);
  return int(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) bf16, D 48 (v1) or 64 (v2's
// blocks), each with d contiguous, heads D apart, and the batch and
// token strides given in elements (multiples of 8; pointers 16-byte aligned);
// o (B, Tq, H, D) contiguous.  strides: q_sb, q_st, k_sb, k_st, v_sb, v_st.
extern "C" int muse_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Tq, int Tk, int D, const int64_t* strides,
                                    float scale, void* stream_ptr) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 48: return launch<48>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    case 64: return launch<64>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

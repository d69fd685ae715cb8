// Nearest codebook entry for each latent row:
//
//   id[n] = argmin_k ( e_sq[k] - 2 * z[n] . cb[k] )      fp32, first k on ties
//
// z (N, C) and cb (K, C) fp32, e_sq (K,) = |cb[k]|^2 computed by the wrapper.
// Replaces the Pallas TPU kernel open_muse_tpu/ops/pallas/vq_argmin.py
// `vq_argmin` (body `_kernel`), which streams codebook tiles past a VMEM
// block of rows and keeps a running (min, argmin) per row.
//
// What bounds it on the H100: the products.  The scores need fp32's
// accuracy (a single TF32 or bf16 product moves near-tied scores and with
// them the ids), and fp32 FMA runs at 67 TFLOP/s: 2 N K C = 68.7 GFLOP for
// the pre-encode batch (N = 16384, K = 8192, C = 256) is 1.03 ms there.  On
// the bf16 tensor cores the same accuracy costs six products: each fp32
// value x is split into three bf16 parts, hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid) (each subtraction exact in fp32, so the parts
// carry x to about 2^-24 of itself), and z . e is summed over hi.hi, hi.mid,
// mid.hi, hi.lo, mid.mid and lo.hi in fp32 (bf16 x bf16 products are exact
// in fp32; the dropped mid.lo, lo.mid and lo.lo stay within about 2^-23 of
// each |z_c e_c|, the size of fp32's own rounding of a product).  That
// is 12 N K C = 412 GFLOP, 417 us at 989 TFLOP/s; the bytes (z, cb, ids: ~25
// MB; the split operands the kernel writes and reads: 38 MB) are 7.5 - 20 us.
//
// What the design does about it, three launches after a memset:
// - A split pass: one elementwise kernel over z and the codebook writes z'
//   (N, 3 Cp) = -2 [z_hi | z_mid | z_lo] and cb' (K', 3 Cp) = [e_hi | e_mid |
//   e_lo] in bf16.  Cp is C rounded up to a multiple of 64 (one GEMM k step
//   then reads one part) and K' is K rounded up to an even count (the GEMM's
//   even N), both padded with zeros; the -2 is exact.
// - The Hopper GEMM (gemm_sm90.cuh, TMA + wgmma) on z' x cb'^T over a K of 6
//   Cp: its epilogue remaps the k steps so that the six Cp-wide spans read
//   the part pairs (hi, hi), (hi, mid), (mid, hi), (hi, lo), (mid, mid), (lo,
//   hi), the six products in one reduction, each part stored once.  The
//   epilogue is staged: the block's 128 x kBN fp32 tile of -2 z . e
//   arrives in shared memory, one warp a row adds e_sq, masks the columns
//   past K and reduces to (lowest score, lowest column on equal scores) with
//   shuffles, and one lane merges it into best[row] with a 64-bit atomicMin
//   on (order-preserving score bits << 32 | id).  The (N, K) scores never
//   reach device memory, and the atomics keep the lowest score and, on equal
//   scores, the lowest id whatever order the blocks run in: two calls give
//   the same ids.
// - unpack_ids: the ids from the packed minima.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

constexpr int kParts = 3;  // hi, mid, lo
// the parts of z' and of cb' that the six Cp-wide spans of the product's K
// read, two bits a span: z' (hi, hi, mid, hi, mid, lo), cb' (hi, mid, hi, lo,
// mid, hi)
constexpr unsigned kZSpans = 0x910, kCbSpans = 0x184;

// monotone map of a float to an unsigned key: a < b  <=>  key(a) < key(b)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Eight bf16 values packed in 16 bytes.
union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// One thread an 8-column chunk of a row of z (rows [0, N)) or of the
// codebook (rows [N, N + Kp)): the three bf16 parts of (z: -2 x, cb: x).
// Columns past C and codebook rows past K are zeros.
__global__ void __launch_bounds__(256)
vq_split_kernel(const float* __restrict__ z, const float* __restrict__ cb, int N, int C, int K,
                int Kp, int Cp, __nv_bfloat16* __restrict__ zp, __nv_bfloat16* __restrict__ cbp) {
  const int chunks = Cp / 8;
  const int64_t total = int64_t(N + Kp) * chunks;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < total;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int row = int(i / chunks), c0 = int(i % chunks) * 8;
    const bool is_z = row < N;
    const int r = is_z ? row : row - N;
    const float* src = is_z ? z + int64_t(r) * C : cb + int64_t(r) * C;
    const bool live = is_z || r < K;
    float x[8];
    if (live && C % 4 == 0 && c0 + 8 <= C) {
      const float4 a = *reinterpret_cast<const float4*>(src + c0);
      const float4 b = *reinterpret_cast<const float4*>(src + c0 + 4);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = live && c0 + e < C ? src[c0 + e] : 0.f;
    }
    Pack8 part[3];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = is_z ? -2.f * x[e] : x[e];
      part[0].h[e] = __float2bfloat16_rn(v);
      const float r1 = __fsub_rn(v, __bfloat162float(part[0].h[e]));
      part[1].h[e] = __float2bfloat16_rn(r1);
      part[2].h[e] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(part[1].h[e])));
    }
    __nv_bfloat16* dst = (is_z ? zp : cbp) + int64_t(r) * kParts * Cp + c0;
#pragma unroll
    for (int p = 0; p < kParts; ++p) *reinterpret_cast<uint4*>(dst + p * Cp) = part[p].u;
  }
}

// The epilogue of z' x cb'^T.  It maps k step k of the 6 Cp-long product to
// the columns of z' and of cb' holding its span's parts; it is staged: the
// block's fp32 tile of -2 z . e in
// shared memory, every thread of the block.  One warp a row at a time: each
// lane takes columns lane, lane + 32, ... (increasing, strict <: the first
// column wins within a lane), the warp reduces to the lowest score and on
// equal scores the lowest column, and lane 0 merges it into best[row].
struct VqArgminEpilogue {
  static constexpr bool kStaged = true;
  static constexpr bool kRemapK = true;
  const float* e_sq;
  int codes;  // K: columns at or past it are cb's zero padding
  unsigned long long* best;
  int cp;        // the width of a part, a multiple of the k step
  int k_extent;  // the operands' width, 3 cp

  __device__ __forceinline__ int k_a(int k) const { return remap(kZSpans, k); }
  __device__ __forceinline__ int k_w(int k) const { return remap(kCbSpans, k); }
  __device__ __forceinline__ int remap(unsigned spans, int k) const {
    const int span = k / cp;
    return int((spans >> (2 * span)) & 3) * cp + k - span * cp;
  }

  template <int kBM, int kBN, int kLd, int kThreads>
  __device__ __forceinline__ void tile(const float* s, int m0, int n0, int M, int) const {
    constexpr int kWarps = kThreads / 32, kPer = kBN / 32;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float e[kPer];  // +inf past K: such a column never wins
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = n0 + lane + 32 * j;
      e[j] = col < codes ? e_sq[col] : INFINITY;
    }
    for (int r = warp; r < kBM && m0 + r < M; r += kWarps) {
      float best_s = INFINITY;
      int best_i = INT_MAX;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float v = __fadd_rn(e[j], s[r * kLd + lane + 32 * j]);
        if (v < best_s) {
          best_s = v;
          best_i = n0 + lane + 32 * j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best_s, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (os < best_s || (os == best_s && oi < best_i)) {
          best_s = os;
          best_i = oi;
        }
      }
      if (lane == 0 && best_i < codes)
        atomicMin(best + m0 + r, (static_cast<unsigned long long>(order_key(best_s)) << 32) |
                                     static_cast<uint32_t>(best_i));
    }
  }
};

__global__ void unpack_ids(const unsigned long long* __restrict__ best, int N,
                           int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) ids[i] = static_cast<int>(best[i] & 0xffffffffull);
}

int split_blocks(int N, int Kp, int Cp) {
  const int64_t chunks = int64_t(N + Kp) * (Cp / 8);
  return int(std::min<int64_t>((chunks + 255) / 256, 8 * muse::sm90::sm_count()));
}

}  // namespace

// The split pass alone: z (N, C), cb (K, C) fp32 -> zp (N, 3 Cp), cbp (Kp, 3
// Cp) bf16, Cp = C rounded up to a multiple of 64, Kp = K rounded up to even.
extern "C" int muse_vq_split(const float* z, const float* cb, int N, int C, int K, void* zp,
                             void* cbp, void* stream_ptr) {
  if (N <= 0 || K <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  const int Cp = (C + 63) / 64 * 64, Kp = (K + 1) / 2 * 2;
  vq_split_kernel<<<split_blocks(N, Kp, Cp), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      z, cb, N, C, K, Kp, Cp, static_cast<__nv_bfloat16*>(zp), static_cast<__nv_bfloat16*>(cbp));
  return int(cudaGetLastError());
}

// z (N, C), cb (K, C), e_sq (K,) fp32 contiguous; zp (N, 3 Cp) and cbp (Kp,
// 3 Cp) bf16 scratch for the split operands (as muse_vq_split); best: (N,)
// 64-bit scratch; ids: (N,) int32 out.
extern "C" int muse_vq_argmin(const float* z, const float* cb, const float* e_sq, int N, int C,
                              int K, void* zp, void* cbp, unsigned long long* best, int* ids,
                              void* stream_ptr) {
  using bf = __nv_bfloat16;
  if (N <= 0 || K <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int Cp = (C + 63) / 64 * 64, Kp = (K + 1) / 2 * 2;
  cudaError_t err = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * size_t(N), stream);
  if (err != cudaSuccess) return int(err);
  int status = muse_vq_split(z, cb, N, C, K, zp, cbp, stream_ptr);
  if (status != 0) return status;
  const VqArgminEpilogue epi{e_sq, K, best, Cp, kParts * Cp};
  err = muse::sm90::gemm_tn(static_cast<const bf*>(zp), static_cast<const bf*>(cbp), epi, N, Kp,
                            6 * Cp, stream);
  if (err != cudaSuccess) return int(err);
  unpack_ids<<<(N + 255) / 256, 256, 0, stream>>>(best, N, ids);
  return int(cudaGetLastError());
}

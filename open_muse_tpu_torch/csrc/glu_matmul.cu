// GLU down-projection, forward and backward.
//
// Forward:  out = bf16((gelu_erf(a) * b) in fp32) @ wo^T, fp32 accumulate.
// Backward: dh = g @ wo (fp32, never stored)
//           da = bf16(dh * b * gelu'(a)),  db = bf16(dh * gelu(a))
//           dwo = g^T @ bf16(gelu(a) * b), fp32 accumulate over the rows
//
// Replaces the Pallas TPU kernels open_muse_tpu/ops/pallas/glu_matmul.py
// `glu_down_matmul` (body `_kernel`) and its backward `_bwd_pallas` (body
// `_bwd_kernel`), the FFN down-projection of every trunk layer of
// MaskGiTUViT_v2.  wo is the torch nn.Linear weight (N, K).
//
// What bounds it on the H100: at the serving shape (a, b: 512 x 2816 bf16,
// wo: 1024 x 2816 bf16) the forward reads 5.8 MB of activations and 5.8 MB
// of weight for 3 GFLOP, about 260 FLOP per byte, near the card's bf16 ridge.
// At the training shape (4096 rows) the backward is two 23.6 GFLOP products
// plus an erf per element of a (M, K) panel: compute-bound, with the GELU
// work on the CUDA cores and 5 x 23 MB of a, b, da, db and h beside them.
//
// What the design does about it, all on the Hopper GEMM of gemm_sm90.cuh
// (TMA, wgmma):
// - Forward, two launches: an elementwise kernel computes h = bf16(gelu(a)
//   * b) once per element, with 16-byte loads and stores, into a (M, K) bf16
//   scratch the wrapper allocates (2.9 MB at the serving shape, which stays
//   in L2); then the GEMM (at 512 rows 64-wide tiles with K split over
//   clusters of two) reads h and wo.
// - Backward, two launches.  dh = g (M, N) @ wo (N, K), wo read MN-major
//   (gemm_nn), with an epilogue that reads a and b once, evaluates gelu and
//   gelu' with erff in fp32 and writes da, db and h = bf16(gelu(a) * b): the
//   fp32 dh never reaches device memory (the TPU kernel keeps it in VMEM),
//   and h is computed once an element.  The epilogue takes the dh tile
//   staged in shared memory and works on 16-byte row chunks, several loads
//   in flight a thread: the epilogue moves 5 x 23 MB at 4096 rows, and from
//   the accumulators, two columns at a time, each thread waited on its loads
//   pair by pair (321 against 75 us a launch on an H100).  Then dwo = g^T (N,
//   M) @ h (M, K) with both read MN-major (gemm_tnn): the sum over the M
//   rows runs in fp32 inside a block, no atomics, so two calls give
//   bit-equal results.
// erf is CUDA's `erff`, not the Abramowitz-Stegun polynomial the TPU kernel
// needs because Mosaic has no erf.
#include <algorithm>

#include "bf16x2.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * kSqrtHalf));
}

// dh epilogue: da = dh * b * gelu'(a), db = dh * gelu(a), h = gelu(a) * b,
// all bf16, (M, K) with leading dimension ld, K a multiple of 8.  Staged:
// the block's fp32 dh tile comes in shared memory, and every thread of the
// block takes 8-column chunks of it, its 16-byte loads of a and b issued
// kBatch chunks at a time before any arithmetic (one memory round trip for
// kBatch chunks, where a chunk at a time would wait on every load).
struct GluGradEpilogue {
  static constexpr bool kStaged = true;
  static constexpr int kBatch = 4;
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  __nv_bfloat16* da;
  __nv_bfloat16* db;
  __nv_bfloat16* h;
  int64_t ld;

  // dh (kBM x kBN fp32, rows kLd floats apart) at (m0, n0) of the output
  template <int kBM, int kBN, int kLd, int kThreads>
  __device__ __forceinline__ void tile(const float* dh, int m0, int n0, int M, int N) const {
    constexpr int kRowChunks = kBN / 8, kPer = (kBM * kRowChunks + kThreads - 1) / kThreads;
    for (int i0 = 0; i0 < kPer; i0 += kBatch) {
      uint4 va[kBatch], vb[kBatch];
      int64_t off[kBatch];
      int at[kBatch];  // the chunk's first float in the tile, -1 past M or N
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
        const bool ok = i0 + i < kPer && r < kBM && m0 + r < M && n0 + col < N;
        at[i] = ok ? r * kLd + col : -1;
        off[i] = (m0 + r) * ld + n0 + col;
        if (ok) {
          va[i] = *reinterpret_cast<const uint4*>(a + off[i]);
          vb[i] = *reinterpret_cast<const uint4*>(b + off[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (at[i] < 0) continue;
        const float4 d0 = *reinterpret_cast<const float4*>(dh + at[i]);
        const float4 d1 = *reinterpret_cast<const float4*>(dh + at[i] + 4);
        const float g[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        uint4 o_da, o_db, o_h;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 x = muse::pair(va[i], p), y = muse::pair(vb[i], p);
          float2 r_da, r_db, r_h;
          grads(x.x, y.x, g[2 * p], r_da.x, r_db.x, r_h.x);
          grads(x.y, y.y, g[2 * p + 1], r_da.y, r_db.y, r_h.y);
          reinterpret_cast<__nv_bfloat162*>(&o_da)[p] = __float22bfloat162_rn(r_da);
          reinterpret_cast<__nv_bfloat162*>(&o_db)[p] = __float22bfloat162_rn(r_db);
          reinterpret_cast<__nv_bfloat162*>(&o_h)[p] = __float22bfloat162_rn(r_h);
        }
        *reinterpret_cast<uint4*>(da + off[i]) = o_da;
        *reinterpret_cast<uint4*>(db + off[i]) = o_db;
        *reinterpret_cast<uint4*>(h + off[i]) = o_h;
      }
    }
  }

  // gelu(x) = x cdf(x), gelu'(x) = cdf(x) + x pdf(x)
  __device__ __forceinline__ static void grads(float x, float y, float dh, float& da_,
                                               float& db_, float& h_) {
    const float cdf = 0.5f * (1.0f + erff(x * kSqrtHalf));
    const float pdf = expf(-0.5f * x * x) * kInvSqrt2Pi;
    const float gelu = x * cdf;
    da_ = dh * y * (cdf + x * pdf);
    db_ = dh * gelu;
    h_ = gelu * y;
  }
};

// Eight bf16 values packed in 16 bytes.
union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// h = bf16(gelu(a) * b), eight elements a thread step, one conversion an
// element (32 registers: eight 256-thread blocks an SM, as the grid assumes)
__global__ void __launch_bounds__(256)
glu_product_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ h,
                   int64_t vectors) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < vectors;
       i += int64_t(gridDim.x) * blockDim.x) {
    Pack8 pa, pb, out;
    pa.u = a[i];
    pb.u = b[i];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out.h[e] = __float2bfloat16_rn(gelu_erf(__bfloat162float(pa.h[e])) * __bfloat162float(pb.h[e]));
    h[i] = out.u;
  }
}

}  // namespace

// a, b, h (M, K); wo (N, K); out (M, N).  K a multiple of 8, N even; h is
// the scratch for the GLU product.
extern "C" int muse_glu_down(const void* a, const void* b, const void* wo, void* h, void* out,
                             int M, int N, int K, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t vectors = int64_t(M) * K / 8;
  const int blocks = int(std::min<int64_t>((vectors + 255) / 256, 8 * muse::sm90::sm_count()));
  glu_product_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint4*>(a),
                                            static_cast<const uint4*>(b), static_cast<uint4*>(h),
                                            vectors);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(muse::sm90::gemm_tn(static_cast<const bf*>(h), static_cast<const bf*>(wo),
                                 muse::StoreBf16{static_cast<bf*>(out), N}, M, N, K, s));
}

// a, b, da, db, h (M, K); wo, dwo (N, K); g (M, N).  K and N multiples of 8;
// h is the scratch for the GLU product, written by the first launch and read
// by the second.
extern "C" int muse_glu_down_bwd(const void* a, const void* b, const void* wo, const void* g,
                                 void* da, void* db, void* dwo, void* h, int M, int N, int K,
                                 void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf* g_ = static_cast<const bf*>(g);
  bf* h_ = static_cast<bf*>(h);
  // dh (M, K) = g (M, N) x wo (N, K), consumed by the epilogue
  const GluGradEpilogue epi{static_cast<const bf*>(a), static_cast<const bf*>(b),
                            static_cast<bf*>(da), static_cast<bf*>(db), h_, K};
  cudaError_t err = muse::sm90::gemm_nn(g_, static_cast<const bf*>(wo), epi, M, K, N, s);
  if (err != cudaSuccess) return int(err);
  // dwo (N, K) = g^T (N, M) x h (M, K), the sum over the M rows
  return int(muse::sm90::gemm_tnn(g_, h_, muse::StoreBf16{static_cast<bf*>(dwo), K}, N, K, M, s));
}

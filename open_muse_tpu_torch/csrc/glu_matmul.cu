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
// plus an erf per element of a (M, K) panel in each: compute-bound, with the
// GELU work on the CUDA cores competing with the tensor cores.
//
// What the design does about it:
// - Forward, two launches: an elementwise kernel computes h = bf16(gelu(a)
//   * b) once per element, with 16-byte loads and stores, into a (M, K) bf16
//   scratch the wrapper allocates (2.9 MB at the serving shape, which stays
//   in L2); then the Hopper GEMM of gemm_sm90.cuh (TMA, wgmma; at 512 rows
//   64-wide tiles with K split over clusters of two) reads h and wo.  The PR 1 design computed the
//   product in the `wmma` GEMM's A-tile prologue, once for each of the 8
//   column tiles: 11.5 M erff for 1.44 M elements.
// - Backward, dh: one GEMM g (M, N) x wo (N, K) whose epilogue reads a and b,
//   evaluates gelu and gelu' with erff in fp32 and writes da and db, so the
//   fp32 dh never reaches device memory (the TPU kernel keeps it in VMEM).
// - Backward, dwo: one GEMM g^T (N, M) x h (M, K) whose B-operand prologue
//   recomputes h = bf16(gelu(a) * b).  Every block with the same K columns
//   recomputes its slice of h, so the tile is tall along N: 128 rows of the
//   1024 give each h element 1024 / 128 = 8 evaluations, the same ratio as the
//   forward (1024 / 128 column tiles).  A 256-row tile (4 evaluations) was
//   slower (0.392 vs 0.329 ms on an H100 at M 4096), as were 64-row tiles
//   (16 evaluations, 0.44 - 0.63 ms): the K step of 32 keeps the prefetch
//   registers low enough for two blocks per SM.  The sum over the M rows runs
//   inside one block in fp32: no atomics, so two calls give bit-equal results.
// erf is CUDA's `erff`, not the Abramowitz-Stegun polynomial the TPU kernel
// needs because Mosaic has no erf.
#include <algorithm>

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace {

constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * kSqrtHalf));
}

// Eight consecutive gelu(a) * b values of one row, computed on the way to
// shared memory.
struct GluLoader {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int64_t ld;
  struct Frag {
    uint4 va, vb;
  };
  __device__ __forceinline__ Frag fetch(int outer, int inner) const {
    const int64_t off = outer * ld + inner;
    return Frag{*reinterpret_cast<const uint4*>(a + off), *reinterpret_cast<const uint4*>(b + off)};
  }
  __device__ __forceinline__ Frag zero() const {
    return Frag{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  }
  __device__ __forceinline__ uint4 transform(const Frag& f) const {
    muse::Pack8 pa, pb, out;
    pa.u = f.va;
    pb.u = f.vb;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out.h[i] = __float2bfloat16_rn(gelu_erf(__bfloat162float(pa.h[i])) * __bfloat162float(pb.h[i]));
    return out.u;
  }
};

// dh epilogue: da = dh * b * gelu'(a), db = dh * gelu(a), both bf16.
struct GluGradEpilogue {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  __nv_bfloat16* da;
  __nv_bfloat16* db;
  int64_t ld;
  __device__ __forceinline__ void one(int64_t off, float dh) const {
    const float x = __bfloat162float(a[off]);
    const float y = __bfloat162float(b[off]);
    const float cdf = 0.5f * (1.0f + erff(x * kSqrtHalf));
    const float pdf = expf(-0.5f * x * x) * kInvSqrt2Pi;
    da[off] = __float2bfloat16_rn(dh * y * (cdf + x * pdf));
    db[off] = __float2bfloat16_rn(dh * (x * cdf));
  }
  __device__ __forceinline__ void store2(int r, int col, float v0, float v1) const {
    one(r * ld + col, v0);
    one(r * ld + col + 1, v1);
  }
  __device__ __forceinline__ void store1(int r, int col, float v) const { one(r * ld + col, v); }
};

// h = bf16(gelu(a) * b), eight elements a thread step, as GluLoader does
__global__ void __launch_bounds__(256)
glu_product_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ h,
                   int64_t vectors) {
  GluLoader glu{};
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < vectors;
       i += int64_t(gridDim.x) * blockDim.x)
    h[i] = glu.transform(GluLoader::Frag{a[i], b[i]});
}

using kGluDhTile = muse::GemmTile<64, 128, 32>;   // dh with the da/db epilogue
using kGluDwoTile = muse::GemmTile<128, 64, 32>;  // dwo: tall along N (see above)

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

// a, b, da, db (M, K); wo, dwo (N, K); g (M, N).  K and N multiples of 8.
extern "C" int muse_glu_down_bwd(const void* a, const void* b, const void* wo, const void* g,
                                 void* da, void* db, void* dwo, int M, int N, int K, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf* a_ = static_cast<const bf*>(a);
  const bf* b_ = static_cast<const bf*>(b);
  const bf* g_ = static_cast<const bf*>(g);
  // dh (M, K) = g (M, N) x wo (N, K) rows, consumed by the epilogue
  cudaError_t err = muse::launch_gemm<kGluDhTile, true, false>(
      muse::RowLoader{g_, N}, muse::RowLoader{static_cast<const bf*>(wo), K},
      GluGradEpilogue{a_, b_, static_cast<bf*>(da), static_cast<bf*>(db), K}, M, K, N, s);
  if (err != cudaSuccess) return int(err);
  // dwo (N, K) = g^T (N, M) x h (M, K): g read as (M, N) rows, h recomputed
  err = muse::launch_gemm<kGluDwoTile, false, false>(
      muse::RowLoader{g_, N}, GluLoader{a_, b_, K}, muse::StoreBf16{static_cast<bf*>(dwo), K}, N, K,
      M, s);
  return int(err);
}

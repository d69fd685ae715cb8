// GLU down-projection: out = bf16((gelu_erf(a) * b) in fp32) @ wo^T, fp32 accumulate.
//
// Replaces the Pallas TPU kernel open_muse_tpu/ops/pallas/glu_matmul.py
// `glu_down_matmul` (body `_kernel`), the FFN down-projection of every trunk
// layer of MaskGiTUViT_v2.
//
// What bounds it on the H100: at the serving shape (a, b: 512 x 2816 bf16,
// wo: 1024 x 2816 bf16) it reads 2.9 MB of activations and 5.8 MB of weight
// for 3 GFLOP, about 340 FLOP per byte, near the card's bf16 ridge; and M =
// 512 rows give only 8 row tiles of 64.
//
// What the design does about it: the GLU product is computed in the GEMM's
// A-tile prologue (registers -> shared memory) and never written to device
// memory.  Each column tile recomputes it, so the tile is wide (64 x 128, on
// eight warps): 8 x 8 = 64 blocks, a measured 17% faster than 64 x 64 tiles
// here.  erf is CUDA's `erff`, not the Abramowitz-Stegun polynomial the TPU
// kernel needs because Mosaic has no erf.
#include "gemm_tile.cuh"

namespace {

struct GluLoader {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  int64_t ld;
  struct Frag {
    uint4 va, vb;
  };
  __device__ __forceinline__ Frag fetch(int row, int k) const {
    const int64_t off = row * ld + k;
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
    for (int i = 0; i < 8; ++i) {
      const float x = __bfloat162float(pa.h[i]);
      const float y = __bfloat162float(pb.h[i]);
      const float gelu = 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
      out.h[i] = __float2bfloat16_rn(gelu * y);
    }
    return out.u;
  }
};

using kGluTile = muse::GemmTile<128, 64>;  // BN 128, BK 64

}  // namespace

extern "C" int muse_glu_down(const void* a, const void* b, const void* wo, void* out, int M,
                             int N, int K, void* stream) {
  GluLoader loader{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), K};
  return static_cast<int>(muse::launch_gemm_tn<kGluTile>(loader, static_cast<const __nv_bfloat16*>(wo),
                                               static_cast<__nv_bfloat16*>(out), M, N, K,
                                               static_cast<cudaStream_t>(stream)));
}

// The Hopper GEMM of gemm_sm90.cuh alone, C (M, N) bf16 = A (M, K) W^T with W
// an nn.Linear weight (N, K): the mainloop that kernels 7 and 9 run, exposed
// to the tests and to chip_smoke.py's measurements.  No path calls it.
#include "gemm_sm90.cuh"

// bn: the tile width (64, 128, 256), split: the K split over a cluster (1,
// 2, 4); both 0 take the kernels' rule (variant_for)
extern "C" int muse_gemm_tn(const void* a, const void* w, void* c, int M, int N, int K, int bn,
                            int split, void* stream) {
  using bf = __nv_bfloat16;
  return int(muse::sm90::gemm_tn(static_cast<const bf*>(a), static_cast<const bf*>(w),
                                 muse::StoreBf16{static_cast<bf*>(c), N}, M, N, K,
                                 static_cast<cudaStream_t>(stream), bn, split));
}

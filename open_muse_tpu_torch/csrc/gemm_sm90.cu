// The Hopper GEMM of gemm_sm90.cuh alone, C (M, N) bf16 = A (M, K) W^T with W
// an nn.Linear weight (N, K), or A W with W read as (K, N) rows (the
// MN-major stage): the mainloop that kernels 7, 9, 10 and 11 run, exposed to
// the tests and to chip_smoke.py's measurements.  No path calls it.
#include "gemm_sm90.cuh"

// bn: the tile width (64, 128, 256), split: the K split over a cluster (1,
// 2, 4); both 0 take the kernels' rule (variant_for).  kn != 0: w is (K, N)
// and C = A W.
extern "C" int muse_gemm(const void* a, const void* w, void* c, int M, int N, int K, int bn,
                         int split, int kn, void* stream) {
  using bf = __nv_bfloat16;
  const bf* a_ = static_cast<const bf*>(a);
  const bf* w_ = static_cast<const bf*>(w);
  const muse::StoreBf16 epi{static_cast<bf*>(c), N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(kn ? muse::sm90::gemm_nn(a_, w_, epi, M, N, K, s, bn, split)
                : muse::sm90::gemm_tn(a_, w_, epi, M, N, K, s, bn, split));
}

// An empty kernel: what one launch costs by itself (chip_smoke.py's floor
// line times it by graph replay).
__global__ void null_kernel() {}

extern "C" int muse_null(int blocks, void* stream) {
  null_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

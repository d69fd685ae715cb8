// Shared block-tiled GEMM for the port's Hopper kernels.
//
//   C[m, n] = sum_k A'[m, k] * W[n, k]      A' = prologue(A), bf16 x bf16 -> fp32
//
// W is a torch nn.Linear weight, (N, K) row-major, so both operands are
// contiguous along K ("TN" GEMM).  The JAX kernels do these products inside
// their own bodies (glu_matmul.py `_kernel`, attn_sublayer.py `_self_kernel`
// / `_cross_kernel`), so the port does them here and not in cuBLAS.
//
// Design: a BM x BN output tile per block (BM = 64; BN = 64 or 128), K in
// steps of BK (masked past K), 2 x (BN / 32) warps each owning 32 x 32
// outputs as 2 x 2 wmma 16x16x16 bf16 fragments (mma.sync on the tensor
// cores) with fp32 accumulators.  The next K step's global loads are issued
// into registers before the current step's MMAs (register double
// buffering).  The fp32 staging tile of the epilogue reuses the operand
// tiles' shared memory.
//
// The A-side hook (`ALoader`) fetches eight consecutive K values of one row
// into registers (`fetch`) and turns them into eight bf16 values when they
// are stored to shared memory (`transform`).  The GLU down-projection uses it
// to apply gelu(a) * b on the fly, so the GLU product never reaches device
// memory.
//
// Bound on the H100 at the serving shapes (M = 512 rows, 1-3 GFLOP per
// product): few blocks of few warps, each re-reading its operand panels
// from L2, so the kernel is latency- and L2-bound at 30-120 TFLOP/s.  The
// tile shapes are the fastest of a measured sweep (PERF.md); wgmma, TMA, a
// multi-stage pipeline and larger tiles are left for later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace muse {

// Tile shape: BM x BN outputs per block, K in steps of BK (masked past K);
// 2 x (BN / 32) warps, each owning 32 x 32 outputs as 2 x 2 wmma fragments.
template <int BN_, int BK_>
struct GemmTile {
  static constexpr int BM = 64, BN = BN_, BK = BK_;
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = 64 * kWarpsN;
  static constexpr int kLds = BK + 8;  // bf16 per shared row, 16 B aligned
  static constexpr int kLdc = BN + 4;  // fp32 per staging row
  static constexpr int kAChunks = BM * BK / 8 / kThreads;  // 16-byte chunks per thread
  static constexpr int kWChunks = BN * BK / 8 / kThreads;
  static constexpr int kABytes = BM * kLds * 2;
  static constexpr int kSmem = (kABytes + BN * kLds * 2) > (BM * kLdc * 4)
                                   ? (kABytes + BN * kLds * 2) : (BM * kLdc * 4);
};

// Eight bf16 values packed in 16 bytes.
union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// Plain A operand: bf16 rows with leading dimension `ld`.
struct RowLoader {
  const __nv_bfloat16* a;
  int64_t ld;
  struct Frag {
    uint4 v;
  };
  __device__ __forceinline__ Frag fetch(int row, int k) const {
    return Frag{*reinterpret_cast<const uint4*>(a + row * ld + k)};
  }
  __device__ __forceinline__ uint4 transform(const Frag& f) const { return f.v; }
  __device__ __forceinline__ Frag zero() const { return Frag{make_uint4(0, 0, 0, 0)}; }
};

template <class Tile, class ALoader>
__global__ void __launch_bounds__(Tile::kThreads)
gemm_tn_kernel(ALoader loader, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  using namespace nvcuda;
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, kLds = Tile::kLds;
  constexpr int kLdc = Tile::kLdc, kThreads = Tile::kThreads, kRowChunks = BK / 8;
  __shared__ __align__(128) unsigned char smem[Tile::kSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem + Tile::kABytes);
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / Tile::kWarpsN;  // warp row (0..1) -> 32 rows
  const int wn = warp % Tile::kWarpsN;  // warp col -> 32 cols
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  typename ALoader::Frag fa[Tile::kAChunks];
  uint4 fw[Tile::kWChunks];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tile::kAChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / kRowChunks;
      const int k = k0 + (chunk % kRowChunks) * 8;
      fa[i] = (m0 + r < M && k < K) ? loader.fetch(m0 + r, k) : loader.zero();
    }
#pragma unroll
    for (int i = 0; i < Tile::kWChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / kRowChunks;
      const int k = k0 + (chunk % kRowChunks) * 8;
      fw[i] = (n0 + r < N && k < K)
                  ? *reinterpret_cast<const uint4*>(w + int64_t(n0 + r) * K + k)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < Tile::kAChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(chunk / kRowChunks) * kLds + (chunk % kRowChunks) * 8]) =
          loader.transform(fa[i]);
    }
#pragma unroll
    for (int i = 0; i < Tile::kWChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&Ws[(chunk / kRowChunks) * kLds + (chunk % kRowChunks) * 8]) =
          fw[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa_[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb_[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa_[i], &As[(wm * 32 + i * 16) * kLds + kk], kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb_[j], &Ws[(wn * 32 + j * 16) * kLds + kk], kLds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa_[i], fb_[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * kLdc + wn * 32 + j * 16], acc[i][j], kLdc,
                              wmma::mem_row_major);
  __syncthreads();
  // fp32 -> bf16, two columns per thread step, masked at the ragged edges
  for (int idx = tid; idx < BM * BN / 2; idx += kThreads) {
    const int r = idx / (BN / 2);
    const int col = (idx % (BN / 2)) * 2;
    const int gm = m0 + r;
    const int gn = n0 + col;
    if (gm >= M) continue;
    if (gn + 1 < N) {
      *reinterpret_cast<__nv_bfloat162*>(c + int64_t(gm) * N + gn) =
          __floats2bfloat162_rn(Cs[r * kLdc + col], Cs[r * kLdc + col + 1]);
    } else if (gn < N) {
      c[int64_t(gm) * N + gn] = __float2bfloat16_rn(Cs[r * kLdc + col]);
    }
  }
}

// Launch on `stream`; K must be a multiple of 8 (16-byte rows) and N even
// (the wrappers check both).  Returns the launch's cudaGetLastError().
template <class Tile, class ALoader>
inline cudaError_t launch_gemm_tn(const ALoader& loader, const __nv_bfloat16* w, __nv_bfloat16* c,
                                  int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM);
  gemm_tn_kernel<Tile, ALoader><<<grid, Tile::kThreads, 0, stream>>>(loader, w, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace muse

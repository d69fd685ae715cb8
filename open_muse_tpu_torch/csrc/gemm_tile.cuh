// Shared block-tiled GEMM for the port's Hopper kernels.
//
//   C[m, n] = epilogue(sum_k A'[m, k] * B'[k, n])     bf16 x bf16 -> fp32
//
// Each operand is read through a loader and is stored either contiguous
// along K ("K-major": A as (M, K) rows, B as a torch nn.Linear weight (N, K))
// or contiguous along its other dimension (A as (K, M) rows -- a transposed
// operand such as g^T in a weight gradient; B as (K, N) rows -- a weight used
// untransposed, as in g @ W).  The JAX kernels do these products inside their
// own bodies, so the port does them in its own GEMMs and not in cuBLAS: this
// one now serves the GLU backward (glu_matmul.py `_bwd_kernel`) and the cross
// sublayer's backward (attn_sublayer.py `_cross_bwd_kernel`); the other
// kernels' products moved to the Hopper GEMM of gemm_sm90.cuh.
//
// Design: a BM x BN output tile per block, K in steps of BK (masked past K),
// (BM / 32) x (BN / 32) warps each owning 32 x 32 outputs as 2 x 2 wmma
// 16x16x16 bf16 fragments (mma.sync on the tensor cores) with fp32
// accumulators.  The next K step's global loads are issued into registers
// before the current step's MMAs (register double buffering).  The fp32
// staging tile of the epilogue reuses the operand tiles' shared memory.
//
// A loader fetches eight consecutive elements along the operand's contiguous
// dimension into registers (`fetch(outer, inner)`) and turns them into eight
// bf16 values when they are stored to shared memory (`transform`).  The GLU
// kernels use it to apply gelu(a) * b on the fly, so the GLU product never
// reaches device memory.  The epilogue receives two neighbouring fp32 outputs
// of one row (`store2`) or a last odd one (`store1`).
//
// Bound on the H100 at the port's shapes (512 - 4096 rows, 1-24 GFLOP per
// product): few blocks of few warps, each re-reading its operand panels from
// L2, so the kernel is latency- and L2-bound at 30-140 TFLOP/s.  The tile
// shapes are the fastest of a measured sweep (PERF.md); wgmma, TMA, a
// multi-stage pipeline and larger tiles are left for later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace muse {

// Tile shape: BM x BN outputs per block, K in steps of BK (masked past K);
// (BM / 32) x (BN / 32) warps, each owning 32 x 32 outputs.
template <int BM_, int BN_, int BK_>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int kWarpsM = BM / 32, kWarpsN = BN / 32;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kLdc = BN + 4;  // fp32 per staging row
};

// One operand's shared-memory tile: Outer rows of Inner contiguous bf16,
// padded by 8 (16 bytes) per row; loaded as 16-byte chunks over Threads.
template <int Outer, int Inner, int Threads>
struct Stage {
  static constexpr int kLd = Inner + 8;
  static constexpr int kRowChunks = Inner / 8;
  static constexpr int kChunks = Outer * Inner / 8 / Threads;
  static constexpr int kBytes = Outer * kLd * 2;
  static_assert(Outer * Inner / 8 % Threads == 0, "tile does not split over the threads");
};

// Eight bf16 values packed in 16 bytes.
union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// Plain operand: bf16 rows with leading dimension `ld`.
struct RowLoader {
  const __nv_bfloat16* a;
  int64_t ld;
  struct Frag {
    uint4 v;
  };
  __device__ __forceinline__ Frag fetch(int outer, int inner) const {
    return Frag{*reinterpret_cast<const uint4*>(a + outer * ld + inner)};
  }
  __device__ __forceinline__ uint4 transform(const Frag& f) const { return f.v; }
  __device__ __forceinline__ Frag zero() const { return Frag{make_uint4(0, 0, 0, 0)}; }
};

// Epilogue: C rounded to bf16, row-major with leading dimension `ldc`.
struct StoreBf16 {
  __nv_bfloat16* c;
  int64_t ldc;
  __device__ __forceinline__ void store2(int r, int col, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(c + r * ldc + col) = __floats2bfloat162_rn(v0, v1);
  }
  __device__ __forceinline__ void store1(int r, int col, float v) const {
    c[r * ldc + col] = __float2bfloat16_rn(v);
  }
};

// kAKMajor: A is (M, K) rows, else (K, M) rows.  kBKMajor: B is (N, K) rows,
// else (K, N) rows.  The non-K-major dimension (M or N) must then be a
// multiple of 8; K-major operands need K a multiple of 8.
template <class Tile, bool kAKMajor, bool kBKMajor, class ALoader, class BLoader, class Epilogue>
__global__ void __launch_bounds__(Tile::kThreads)
gemm_kernel(ALoader la, BLoader lb, Epilogue epi, int M, int N, int K) {
  using namespace nvcuda;
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, kThreads = Tile::kThreads;
  constexpr int kLdc = Tile::kLdc;
  using SA = Stage<kAKMajor ? BM : BK, kAKMajor ? BK : BM, kThreads>;
  using SB = Stage<kBKMajor ? BN : BK, kBKMajor ? BK : BN, kThreads>;
  constexpr int kOperandBytes = SA::kBytes + SB::kBytes;
  constexpr int kStagingBytes = BM * kLdc * 4;
  constexpr int kSmem = kOperandBytes > kStagingBytes ? kOperandBytes : kStagingBytes;
  using ALayout = std::conditional_t<kAKMajor, wmma::row_major, wmma::col_major>;
  using BLayout = std::conditional_t<kBKMajor, wmma::col_major, wmma::row_major>;

  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + SA::kBytes);
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / Tile::kWarpsN;  // warp row -> 32 rows
  const int wn = warp % Tile::kWarpsN;  // warp col -> 32 cols
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  typename ALoader::Frag fa[SA::kChunks];
  typename BLoader::Frag fb[SB::kChunks];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < SA::kChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / SA::kRowChunks;
      const int c = (chunk % SA::kRowChunks) * 8;
      if (kAKMajor)
        fa[i] = (m0 + r < M && k0 + c < K) ? la.fetch(m0 + r, k0 + c) : la.zero();
      else
        fa[i] = (k0 + r < K && m0 + c < M) ? la.fetch(k0 + r, m0 + c) : la.zero();
    }
#pragma unroll
    for (int i = 0; i < SB::kChunks; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / SB::kRowChunks;
      const int c = (chunk % SB::kRowChunks) * 8;
      if (kBKMajor)
        fb[i] = (n0 + r < N && k0 + c < K) ? lb.fetch(n0 + r, k0 + c) : lb.zero();
      else
        fb[i] = (k0 + r < K && n0 + c < N) ? lb.fetch(k0 + r, n0 + c) : lb.zero();
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < SA::kChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&As[(chunk / SA::kRowChunks) * SA::kLd +
                                    (chunk % SA::kRowChunks) * 8]) = la.transform(fa[i]);
    }
#pragma unroll
    for (int i = 0; i < SB::kChunks; ++i) {
      const int chunk = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&Bs[(chunk / SB::kRowChunks) * SB::kLd +
                                    (chunk % SB::kRowChunks) * 8]) = lb.transform(fb[i]);
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa_[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb_[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16;
        wmma::load_matrix_sync(fa_[i], kAKMajor ? &As[row * SA::kLd + kk] : &As[kk * SA::kLd + row],
                               SA::kLd);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb_[j], kBKMajor ? &Bs[col * SB::kLd + kk] : &Bs[kk * SB::kLd + col],
                               SB::kLd);
      }
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
  // two columns per thread step, masked at the ragged edges
  for (int idx = tid; idx < BM * BN / 2; idx += kThreads) {
    const int r = idx / (BN / 2);
    const int col = (idx % (BN / 2)) * 2;
    const int gm = m0 + r;
    const int gn = n0 + col;
    if (gm >= M) continue;
    if (gn + 1 < N) {
      epi.store2(gm, gn, Cs[r * kLdc + col], Cs[r * kLdc + col + 1]);
    } else if (gn < N) {
      epi.store1(gm, gn, Cs[r * kLdc + col]);
    }
  }
}

// Launch on `stream`; returns the launch's cudaGetLastError().
template <class Tile, bool kAKMajor, bool kBKMajor, class ALoader, class BLoader, class Epilogue>
inline cudaError_t launch_gemm(const ALoader& la, const BLoader& lb, const Epilogue& epi, int M,
                               int N, int K, cudaStream_t stream) {
  dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM);
  gemm_kernel<Tile, kAKMajor, kBKMajor, ALoader, BLoader, Epilogue>
      <<<grid, Tile::kThreads, 0, stream>>>(la, lb, epi, M, N, K);
  return cudaGetLastError();
}

// C (M, N) bf16 = A' (M, K) x W^T with W a torch nn.Linear weight (N, K).
// K must be a multiple of 8 (16-byte rows) and N even (the wrappers check).
template <class Tile, class ALoader>
inline cudaError_t launch_gemm_tn(const ALoader& loader, const __nv_bfloat16* w, __nv_bfloat16* c,
                                  int M, int N, int K, cudaStream_t stream) {
  return launch_gemm<Tile, true, true>(loader, RowLoader{w, K}, StoreBf16{c, N}, M, N, K, stream);
}

// C (M, N) bf16 = A (M, K) x W with W (K, N) rows: a torch nn.Linear weight
// used untransposed, as in the input gradient g @ W.  K and N multiples of 8.
template <class Tile>
inline cudaError_t launch_gemm_nn(const __nv_bfloat16* a, const __nv_bfloat16* w, __nv_bfloat16* c,
                                  int M, int N, int K, cudaStream_t stream) {
  return launch_gemm<Tile, true, false>(RowLoader{a, K}, RowLoader{w, N}, StoreBf16{c, N}, M, N, K,
                                        stream);
}

}  // namespace muse

// Nearest codebook entry for each latent row:
//
//   id[n] = argmin_k ( e_sq[k] - 2 * z[n] . cb[k] )      fp32, first k on ties
//
// z (N, C) and cb (K, C) fp32, e_sq (K,) = |cb[k]|^2 computed by the wrapper.
// Replaces the Pallas TPU kernel open_muse_tpu/ops/pallas/vq_argmin.py
// `vq_argmin` (body `_kernel`), which streams codebook tiles past a VMEM
// block of rows and keeps a running (min, argmin) per row.
//
// What bounds it on the H100: the products, 2*N*K*C fp32 operations (68.7
// GFLOP for the pre-encode batch N = 16384, K = 8192, C = 256, 1.03 ms at
// the 67 TFLOP/s fp32 rate); the bytes (z, cb, ids: ~25 MB) are 7.5 us.  The
// scores are summed in fp32 FMA on purpose: TF32 or bf16 tensor cores would
// move near-tied scores and with them the chosen ids.
//
// What the design does about it: an SGEMM-style tile of 128 rows x 128 codes
// per block, 256 threads each holding an 8 x 8 register tile of scores, fed
// from shared memory in 16-wide steps along C (double-buffered, the next
// step's global loads in flight while the current step computes).  The (N, K)
// score matrix never reaches device memory: after each code tile every
// thread folds its scores into a running (min, argmin) for its 8 rows.  A
// block walks a contiguous range of code tiles; where the rows alone give
// too few blocks to fill the card (one inpainting request has 256 rows) the
// codebook is split over more blocks, and the splits merge through a 64-bit
// atomicMin on (order-preserving score bits << 32 | id), which keeps the
// lowest score and, on equal scores, the lowest id: the result does not
// depend on the order the blocks run in.  Rows, codes and C are masked at
// their tails, so any N, K and C work without padding copies.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBM = 128;  // rows of z per block
constexpr int kBN = 128;  // codes per tile
constexpr int kBK = 16;   // step along C
constexpr int kThreads = 256;
constexpr int kPad = 4;   // shared rows of kBM + kPad floats: fewer bank conflicts on the stores

// monotone map of a float to an unsigned key: a < b  <=>  key(a) < key(b)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                 const float* __restrict__ e_sq, int N, int C, int K, int tiles_per_split,
                 unsigned long long* __restrict__ best) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];  // z chunk, transposed: [c][row]
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];  // codebook chunk: [c][code]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int k_tiles = (K + kBN - 1) / kBN;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(k_tiles, tile_begin + tiles_per_split);
  if (tile_begin >= tile_end) return;
  const int c_steps = (C + kBK - 1) / kBK;
  const int total = (tile_end - tile_begin) * c_steps;

  // global -> register staging: each thread moves 8 floats of z and 8 of the
  // codebook per step; consecutive threads read consecutive c of one row
  float ra[8], rb[8];
  auto load = [&](int step) {
    const int n0 = (tile_begin + step / c_steps) * kBN;
    const int c0 = (step % c_steps) * kBK;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = c0 + idx % kBK;
      const bool c_ok = c < C;
      ra[i] = (c_ok && m0 + r < N) ? z[int64_t(m0 + r) * C + c] : 0.f;
      rb[i] = (c_ok && n0 + r < K) ? cb[int64_t(n0 + r) * C + c] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads;
      As[buf][idx % kBK][idx / kBK] = ra[i];
      Bs[buf][idx % kBK][idx / kBK] = rb[i];
    }
  };

  // this thread's rows: ty*4 + {0..3} and 64 + ty*4 + {0..3}; codes likewise with tx
  float acc[8][8];
  float best_s[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_s[i] = INFINITY;
    best_i[i] = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < total; ++step) {
    const int buf = step & 1;
    if (step + 1 < total) load(step + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (step % c_steps == c_steps - 1) {
      // end of a code tile: fold the scores into the running best, codes in
      // increasing order with a strict < so the earliest code wins ties
      const int n0 = (tile_begin + step / c_steps) * kBN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int code = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (code < K) {
          const float e = e_sq[code];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float s = __fsub_rn(e, 2.f * acc[i][j]);
            if (s < best_s[i]) {
              best_s[i] = s;
              best_i[i] = code;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = 0.f;
      }
    }
    if (step + 1 < total) store(buf ^ 1);
    __syncthreads();
  }

  // merge the 16 threads (tx) that share each row; lower code on equal scores
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = best_s[i];
    int id = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      if (os < s || (os == s && oi < id)) {
        s = os;
        id = oi;
      }
    }
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (tx == 0 && row < N && id != 0x7fffffff)
      atomicMin(best + row, (static_cast<unsigned long long>(order_key(s)) << 32) |
                                static_cast<uint32_t>(id));
  }
}

__global__ void unpack_ids(const unsigned long long* __restrict__ best, int N,
                           int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) ids[i] = static_cast<int>(best[i] & 0xffffffffull);
}

}  // namespace

// z (N, C), cb (K, C), e_sq (K,) fp32 contiguous; best: (N,) 64-bit scratch;
// ids: (N,) int32 out.  `sms` (the card's SM count) sizes the codebook split.
extern "C" int muse_vq_argmin(const float* z, const float* cb, const float* e_sq, int N, int C,
                              int K, int sms, unsigned long long* best, int* ids,
                              void* stream_ptr) {
  if (N <= 0 || K <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int row_tiles = (N + kBM - 1) / kBM;
  const int k_tiles = (K + kBN - 1) / kBN;
  // at least two blocks per SM where the codebook allows it
  int splits = (2 * sms + row_tiles - 1) / row_tiles;
  splits = splits < 1 ? 1 : (splits > k_tiles ? k_tiles : splits);
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  cudaError_t err = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * size_t(N), stream);
  if (err != cudaSuccess) return int(err);
  vq_argmin_kernel<<<dim3(row_tiles, splits), kThreads, 0, stream>>>(z, cb, e_sq, N, C, K,
                                                                      tiles_per_split, best);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  unpack_ids<<<(N + 255) / 256, 256, 0, stream>>>(best, N, ids);
  return int(cudaGetLastError());
}

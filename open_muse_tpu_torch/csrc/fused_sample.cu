// Sampling tail of one MaskGIT decode step, in one pass over the logits:
//
//   x     = u + g * (c - u)      fp32, columns < vocab_limit (codebook crop)
//   id    = argmax(x + gumbel)   lowest index wins ties
//   sel   = exp(x[id] - logsumexp(x))
//
// With CFG, c and u are the cond and uncond halves of the raw (2B, S, V_raw)
// logits; without (kCfg = false), x is the cropped fp32 logit itself.
// Replaces the Pallas TPU kernels open_muse_tpu/ops/pallas/fused_sample.py
// `fused_categorical_cfg` (body `_cfg_kernel`) and `fused_categorical` (body
// `_kernel`; the JAX loop crops and casts to fp32 before it, this kernel
// reads the raw bf16 logits and crops in place, the same function).
//
// Noise: either an explicit fp32 gumbel tensor (tests and comparisons, as the
// TPU kernel's `gumbel=`), or a counter-based Philox4x32-10 stream in place of
// the TPU's PRNG, keyed by a 64-bit seed the wrapper draws from the caller's
// torch.Generator, with one counter per (row, column).
//
// What bounds it on the H100: reading the logits -- 2 x 256 x 8192 bf16 = 8 MB
// per serving step with CFG, half that without -- plus one exp and (with
// Philox) two logs per element.
// What the design does about it: one block per row streams both halves once
// with coalesced loads, keeps a running (best score, index, logit) and an
// online (max, sum) per thread, and merges them with warp shuffles; the
// combined fp32 logits never reach device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t philox_bits(uint64_t seed, uint32_t row, uint32_t col) {
  uint32_t c0 = col, c1 = row, c2 = 0, c3 = 0;
  uint32_t k0 = uint32_t(seed), k1 = uint32_t(seed >> 32);
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  // 24 bits -> u in (0, 1), as the TPU kernel does (fused_sample.py:271-274)
  const float u = (float(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

struct Best {
  float score, logit, m, s;
  int idx;
};

__device__ __forceinline__ void merge(Best& a, const Best& b) {
  if (b.score > a.score || (b.score == a.score && b.idx < a.idx)) {
    a.score = b.score;
    a.idx = b.idx;
    a.logit = b.logit;
  }
  if (b.m > -INFINITY) {
    if (a.m > -INFINITY) {
      const float mm = fmaxf(a.m, b.m);
      a.s = a.s * expf(a.m - mm) + b.s * expf(b.m - mm);
      a.m = mm;
    } else {
      a.m = b.m;
      a.s = b.s;
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool kCfg>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ logits, int N, int v_raw, int vocab_limit, float guidance,
              const float* __restrict__ gumbel, int64_t g_stride, uint64_t seed,
              int* __restrict__ ids, float* __restrict__ sel) {
  const int row = blockIdx.x;
  const T* cond = logits + int64_t(row) * v_raw;
  const T* uncond = kCfg ? logits + (int64_t(N) + row) * v_raw : nullptr;
  const float* g_row = gumbel ? gumbel + row * g_stride : nullptr;

  Best best{-INFINITY, -INFINITY, -INFINITY, 0.f, 0x7fffffff};
  for (int v = threadIdx.x; v < vocab_limit; v += kThreads) {
    float x = to_f32(cond[v]);
    if constexpr (kCfg) {
      const float u = to_f32(uncond[v]);
      // no FMA contraction: the same roundings as u + g * (c - u) in XLA / torch
      x = __fadd_rn(u, __fmul_rn(guidance, __fsub_rn(x, u)));
    }
    const float noise = g_row ? g_row[v] : gumbel_from_bits(philox_bits(seed, row, v));
    const float score = __fadd_rn(x, noise);
    if (score > best.score) {  // v increases per thread: the first index wins ties
      best.score = score;
      best.idx = v;
      best.logit = x;
    }
    if (x > best.m) {
      best.s = (best.m > -INFINITY ? best.s * expf(best.m - x) : 0.f) + 1.f;
      best.m = x;
    } else {
      best.s += expf(x - best.m);
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    Best other;
    other.score = __shfl_xor_sync(0xffffffffu, best.score, off);
    other.logit = __shfl_xor_sync(0xffffffffu, best.logit, off);
    other.m = __shfl_xor_sync(0xffffffffu, best.m, off);
    other.s = __shfl_xor_sync(0xffffffffu, best.s, off);
    other.idx = __shfl_xor_sync(0xffffffffu, best.idx, off);
    merge(best, other);
  }
  __shared__ Best warp_best[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(best, warp_best[w]);
    ids[row] = best.idx;
    sel[row] = expf(best.logit - (best.m + logf(best.s)));
  }
}

template <bool kCfg>
int launch(const void* logits, int logits_bf16, int N, int v_raw, int vocab_limit, float guidance,
           const float* gumbel, int64_t g_stride, uint64_t seed, int* ids, float* sel,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (logits_bf16)
    sample_kernel<__nv_bfloat16, kCfg><<<N, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), N, v_raw, vocab_limit, guidance, gumbel,
        g_stride, seed, ids, sel);
  else
    sample_kernel<float, kCfg><<<N, kThreads, 0, stream>>>(static_cast<const float*>(logits), N,
                                                           v_raw, vocab_limit, guidance, gumbel,
                                                           g_stride, seed, ids, sel);
  return int(cudaGetLastError());
}

}  // namespace

// logits: (2N, v_raw), cond rows first; bf16 when logits_bf16 != 0, else fp32.
// gumbel: (N, g_stride) fp32, or nullptr for the in-kernel Philox stream.
extern "C" int muse_cfg_sample(const void* logits, int logits_bf16, int N, int v_raw,
                               int vocab_limit, float guidance, const float* gumbel,
                               int64_t g_stride, uint64_t seed, int* ids, float* sel,
                               void* stream_ptr) {
  return launch<true>(logits, logits_bf16, N, v_raw, vocab_limit, guidance, gumbel, g_stride,
                      seed, ids, sel, stream_ptr);
}

// logits: (N, v_raw); no guidance.  Otherwise as muse_cfg_sample.
extern "C" int muse_sample(const void* logits, int logits_bf16, int N, int v_raw,
                           int vocab_limit, const float* gumbel, int64_t g_stride, uint64_t seed,
                           int* ids, float* sel, void* stream_ptr) {
  return launch<false>(logits, logits_bf16, N, v_raw, vocab_limit, 0.f, gumbel, g_stride, seed,
                       ids, sel, stream_ptr);
}

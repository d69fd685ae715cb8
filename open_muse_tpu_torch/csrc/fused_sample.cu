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
// the TPU's PRNG, keyed by a 64-bit seed that each block loads from device
// memory (the TPU kernel takes its seed as an SMEM operand, so one compiled
// program serves every request; here one captured CUDA graph does, the seed
// buffer refilled before each replay): one Philox call per four columns,
// counter (col / 4, row0 + row, 0, 0), its output word col % 4 the bits of column col
// (kernels/fused_sample.py `philox_gumbel_plain` is the same stream in torch).
//
// What bounds it on the H100: reading the logits -- 2 x 256 x 8192 bf16 = 8 MB
// per serving step with CFG, half that without (2.5 / 1.3 us at 3.35 TB/s,
// less from L2, where a decode's logits lie after the LM head) -- and, on the
// Philox route, the integer work of N V / 4 Philox calls (10 rounds of two
// 32 x 32 -> 64-bit multiplies, xors and key adds), about as long.
// What the design does about it: a block of 256 threads takes a row and
// holds it in registers, 8192 bf16 columns at a time (4 chunks of 8 columns a
// thread; fp32 logits 4096): every 16-byte load of the cond and uncond
// halves (and of the explicit noise) is issued before any arithmetic, then
// three passes over the registers -- the combine, the thread's max, and the
// sum of p = exp2((x - max) log2 e) together with the argmax of x + gumbel --
// with no rescale or branch per element.  At most 128 registers a thread,
// so two blocks share an SM and a serving step's 256 rows run in one wave.
// On the Philox route (its own instantiation) one call gives four columns
// their bits, and the outer log of the Gumbel draw -log(E), E = -log(u), is
// not taken per column: x + gumbel = max + log(p / E), so the argmax compares
// p / E by cross products and the thread's winner alone gets its log.  The
// threads merge (score, id, logit, max, sum) with warp shuffles, then one
// warp merges the eight warps'.  The combined fp32 logits never reach device
// memory.  Rows whose pitch is not 16-byte aligned (the chi-square checks'
// 20 columns) take element loads in the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// E = -log(u), u in (0, 1) from 24 bits as the TPU kernel makes it
// (fused_sample.py:86-88); the Gumbel draw is -log(E)
__device__ __forceinline__ float exp_draw(uint32_t bits) {
  const float u = (float(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(u);
}

// Eight columns as loaded: 16 bytes of bf16, or 2 x 16 bytes of fp32.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  };
  __device__ __forceinline__ float get(int e) const { return __bfloat162float(h[e]); }
};
template <>
struct Raw<float> {
  union {
    float4 v[2];
    float f[8];
  };
  __device__ __forceinline__ float get(int e) const { return f[e]; }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// columns col0 .. col0 + 7 of a row, one 16-byte load per 16 bytes where the
// row allows it, element loads (0 past `limit`) otherwise
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int col0, int limit, bool vec,
                                      Raw<__nv_bfloat16>& out) {
  if (vec && col0 + 8 <= limit) {
    out.u = *reinterpret_cast<const uint4*>(row + col0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out.h[e] = col0 + e < limit ? row[col0 + e] : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void load8(const float* row, int col0, int limit, bool vec,
                                      Raw<float>& out) {
  if (vec && col0 + 8 <= limit) {
    out.v[0] = *reinterpret_cast<const float4*>(row + col0);
    out.v[1] = *reinterpret_cast<const float4*>(row + col0 + 4);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out.f[e] = col0 + e < limit ? row[col0 + e] : 0.f;
  }
}

struct Best {
  float score, logit, m, s;  // argmax score and its logit; max and sum of exp(x - m)
  int idx;
};

// (m, s) of two sets of columns merged: s = sum of exp(x - m) over both
__device__ __forceinline__ void merge_sum(float& m, float& s, float om, float os) {
  const float mm = fmaxf(m, om);
  s = mm == -INFINITY ? 0.f
                      : s * exp2f((m - mm) * kLog2e) + os * exp2f((om - mm) * kLog2e);
  m = mm;
}

__device__ __forceinline__ void merge(Best& a, const Best& b) {
  if (b.score > a.score || (b.score == a.score && b.idx < a.idx)) {
    a.score = b.score;
    a.idx = b.idx;
    a.logit = b.logit;
  }
  merge_sum(a.m, a.s, b.m, b.s);
}

__device__ __forceinline__ Best shuffle_merge(Best best, int width) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1) {
    Best other;
    other.score = __shfl_xor_sync(0xffffffffu, best.score, off);
    other.logit = __shfl_xor_sync(0xffffffffu, best.logit, off);
    other.m = __shfl_xor_sync(0xffffffffu, best.m, off);
    other.s = __shfl_xor_sync(0xffffffffu, best.s, off);
    other.idx = __shfl_xor_sync(0xffffffffu, best.idx, off);
    merge(best, other);
  }
  return best;
}

// Two blocks an SM (at most 128 registers a thread): the 256 rows of a
// serving step then run in one wave on 132 SMs.
template <typename T, bool kCfg, bool kPhilox>
__global__ void __launch_bounds__(kThreads, 2)
sample_kernel(const T* __restrict__ logits, int N, int v_raw, int vocab_limit, float guidance,
              const float* __restrict__ gumbel, int64_t g_stride,
              const uint64_t* __restrict__ seed, int64_t row0, int* __restrict__ ids,
              float* __restrict__ sel) {
  // 8-column chunks a thread per segment: 8192 bf16 or 4096 fp32 columns
  constexpr int kChunks = sizeof(T) == 2 ? 4 : 2;
  constexpr int kSegment = kThreads * 8 * kChunks;
  const int row = blockIdx.x;
  const T* cond = logits + int64_t(row) * v_raw;
  const T* uncond = kCfg ? logits + (int64_t(N) + row) * v_raw : cond;
  const float* g_row = kPhilox ? nullptr : gumbel + row * g_stride;
  const bool vec_x = aligned16(cond) && aligned16(uncond);
  const bool vec_g = !kPhilox && aligned16(g_row);
  const uint64_t key = kPhilox ? *seed : 0ull;  // one load a block
  const uint32_t k0 = uint32_t(key), k1 = uint32_t(key >> 32);
  // the stream's row: a rank that samples rows row0 .. row0 + N - 1 of a
  // larger batch draws what the whole batch's call draws for them
  const uint32_t prow = uint32_t(row0 + row);

  Best best{-INFINITY, -INFINITY, -INFINITY, 0.f, INT_MAX};
  for (int seg = 0; seg < vocab_limit; seg += kSegment) {
    // every load first
    Raw<T> rc[kChunks], ru[kChunks];
    Raw<float> rg[kPhilox ? 1 : kChunks];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col0 = seg + (i * kThreads + threadIdx.x) * 8;
      if (col0 >= vocab_limit) continue;
      load8(cond, col0, vocab_limit, vec_x, rc[i]);
      if constexpr (kCfg) load8(uncond, col0, vocab_limit, vec_x, ru[i]);
      if constexpr (!kPhilox) load8(g_row, col0, vocab_limit, vec_g, rg[i]);
    }
    // the combine (no FMA contraction: the roundings of u + g * (c - u) in
    // XLA / torch) and the thread's max; columns past the crop are -inf
    float x[kChunks][8];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col0 = seg + (i * kThreads + threadIdx.x) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = rc[i].get(e);
        if constexpr (kCfg) {
          const float u = ru[i].get(e);
          v = __fadd_rn(u, __fmul_rn(guidance, __fsub_rn(v, u)));
        }
        x[i][e] = col0 + e < vocab_limit ? v : -INFINITY;
        m = fmaxf(m, x[i][e]);
      }
    }
    // the sum of p = exp(x - m) and the argmax of x + gumbel, columns in
    // increasing order with a strict > (the first index wins ties).  On the
    // Philox route gumbel = -log(E), E = -log(u), and x + gumbel = m +
    // log(p / E): the argmax compares p / E by cross products, and the
    // outer log is taken once a segment, for the thread's winner only.
    const float m_shift = m == -INFINITY ? 0.f : m;
    float s = 0.f;
    float win_p = 0.f, win_e = 1.f, win_x = -INFINITY;  // Philox: p / E of the winner
    int win_i = INT_MAX;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col0 = seg + (i * kThreads + threadIdx.x) * 8;
      if (col0 >= vocab_limit) continue;
      if constexpr (kPhilox) {  // two Philox calls: counters col0 / 4 and col0 / 4 + 1
        const uint4 b0 = philox4x32_10(make_uint4(col0 / 4, prow, 0, 0), k0, k1);
        const uint4 b1 = philox4x32_10(make_uint4(col0 / 4 + 1, prow, 0, 0), k0, k1);
        const uint32_t bits[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float p = exp2f((x[i][e] - m_shift) * kLog2e);  // 0 past the crop
          s += p;
          const float ex = exp_draw(bits[e]);
          if (p * win_e > win_p * ex) {
            win_p = p;
            win_e = ex;
            win_i = col0 + e;
            win_x = x[i][e];
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += exp2f((x[i][e] - m_shift) * kLog2e);
          const float score = __fadd_rn(x[i][e], rg[i].get(e));
          if (score > best.score) {
            best.score = score;
            best.idx = col0 + e;
            best.logit = x[i][e];
          }
        }
      }
    }
    if constexpr (kPhilox) {
      if (win_i != INT_MAX) {  // x + gumbel of the segment's winner, as the explicit route sums it
        const float score = __fadd_rn(win_x, -logf(win_e));
        if (score > best.score) {
          best.score = score;
          best.idx = win_i;
          best.logit = win_x;
        }
      }
    }
    merge_sum(best.m, best.s, m, s);
  }

  best = shuffle_merge(best, 32);
  __shared__ Best warp_best[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? warp_best[lane]
                                : Best{-INFINITY, -INFINITY, -INFINITY, 0.f, INT_MAX};
    best = shuffle_merge(best, kThreads / 32);
    if (lane == 0) {
      ids[row] = best.idx;
      sel[row] = expf(best.logit - (best.m + logf(best.s)));
    }
  }
}

template <typename T, bool kCfg>
void launch_route(const T* logits, int N, int v_raw, int vocab_limit, float guidance,
                  const float* gumbel, int64_t g_stride, const uint64_t* seed, int64_t row0,
                  int* ids, float* sel, cudaStream_t stream) {
  if (gumbel)
    sample_kernel<T, kCfg, false><<<N, kThreads, 0, stream>>>(
        logits, N, v_raw, vocab_limit, guidance, gumbel, g_stride, seed, row0, ids, sel);
  else
    sample_kernel<T, kCfg, true><<<N, kThreads, 0, stream>>>(
        logits, N, v_raw, vocab_limit, guidance, gumbel, g_stride, seed, row0, ids, sel);
}

template <bool kCfg>
int launch(const void* logits, int logits_bf16, int N, int v_raw, int vocab_limit, float guidance,
           const float* gumbel, int64_t g_stride, const uint64_t* seed, int64_t row0, int* ids,
           float* sel, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (logits_bf16)
    launch_route<__nv_bfloat16, kCfg>(static_cast<const __nv_bfloat16*>(logits), N, v_raw,
                                      vocab_limit, guidance, gumbel, g_stride, seed, row0, ids,
                                      sel, stream);
  else
    launch_route<float, kCfg>(static_cast<const float*>(logits), N, v_raw, vocab_limit, guidance,
                              gumbel, g_stride, seed, row0, ids, sel, stream);
  return int(cudaGetLastError());
}

}  // namespace

// logits: (2N, v_raw), cond rows first; bf16 when logits_bf16 != 0, else fp32.
// gumbel: (N, g_stride) fp32, or nullptr for the in-kernel Philox stream,
// keyed by the 64-bit value at `seed` (device memory; unread with gumbel),
// its counters' rows starting at row0 (0 but for a rank's share of a batch).
extern "C" int muse_cfg_sample(const void* logits, int logits_bf16, int N, int v_raw,
                               int vocab_limit, float guidance, const float* gumbel,
                               int64_t g_stride, const uint64_t* seed, int64_t row0, int* ids,
                               float* sel, void* stream_ptr) {
  return launch<true>(logits, logits_bf16, N, v_raw, vocab_limit, guidance, gumbel, g_stride,
                      seed, row0, ids, sel, stream_ptr);
}

// logits: (N, v_raw); no guidance.  Otherwise as muse_cfg_sample.
extern "C" int muse_sample(const void* logits, int logits_bf16, int N, int v_raw,
                           int vocab_limit, const float* gumbel, int64_t g_stride,
                           const uint64_t* seed, int64_t row0, int* ids, float* sel,
                           void* stream_ptr) {
  return launch<false>(logits, logits_bf16, N, v_raw, vocab_limit, 0.f, gumbel, g_stride, seed,
                       row0, ids, sel, stream_ptr);
}

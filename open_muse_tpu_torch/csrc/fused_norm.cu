// Residual add + RMSNorm or LayerNorm over the last axis, one pass over the
// rows:
//
//   h        = x (+ residual)
//   prenorm  = h in the input type                 (written only with a residual)
//   RMS:  out = h * rsqrt(mean(h^2) + eps) * scale
//   LN:   out = (h - mean(h)) * rsqrt(mean((h - mean)^2) + eps) * scale (+ bias)
//
// Replaces the Pallas TPU kernels open_muse_tpu/ops/pallas/fused_norm.py
// `fused_residual_rmsnorm` (body `_rms_kernel`) and `fused_residual_layernorm`
// (body `_ln_kernel`), which take blocks of 256 rows into VMEM; here the
// kernel kind is a template flag.  A second template flag picks the staging:
//
//  * the Pallas kernels' (kModel = false): h, the moments and the affine in
//    fp32, one cast at the end;
//  * the JAX model's (kModel = true), as the layers the model runs compute it
//    (open_muse_tpu/ops/layers.py RMSNorm / LayerNorm): h = x + residual
//    rounded to the input type, the moments of that h in fp32, the rsqrt
//    factor (RMS) or the normalised value (LN) rounded to the input type,
//    then the scale and the bias each applied in the input type.
//
// What bounds it on the H100: the bytes at the large shapes, latency at the
// small ones.  Each row is read once (x, and the residual when given) and
// written once or twice (out, and prenorm with a residual), and a few fp32
// operations an element are nothing beside that: 33.6 MB at the v1 text
// model's mid-MLP norm under CFG, (2, 1024, 4096), 10.0 us at 3.35 TB/s, so
// there every SM needs enough 16-byte loads in flight; 3.16 MB at v1's (1,
// 257, 3072), 0.94 us, where a call of a few microseconds waits on its
// memory round trips in a row and on how many SMs hold a block.
//
// What the design does about it.  Variant rule, chosen on the width D before
// launch:
//
//  * D 768 and 1024 (v2's blocks and trunk, v1's hidden width): a warp a
//    row, two rows a block; each lane holds 3 / 4 16-byte vectors of the row.
//  * D 1280 (the larger Paella-VQ U-ViTs' hidden width): a block of 160
//    threads a row, one vector a thread (40 registers; five vectors a lane,
//    as a warp a row would hold them, take 156 - 159, so few warps fit an
//    SM, and measured up to 20% slower).
//  * D 3072 and 4096 (v1's mid-MLP norm: intermediate_size 3072 in the
//    ImageNet config, 4096 in the CC12M and MOVQ ones): a block of 128
//    threads a row, D / 1024 (3, 4) vectors a thread, so (1, 257, 3072)
//    runs 257 blocks on the 132 SMs and (2, 1024, 4096) 2048.
//
//    Where a block holds one row, its warps' partial sums meet in shared
//    memory, one float a warp, added in warp order.
//
//    In both, the row lives in registers.  Every thread issues all of its
//    16-byte loads of x, the residual, the scale and the bias before any
//    arithmetic, so they are in flight together and the row costs one round
//    trip; the LayerNorm variance is a second sweep over the registers.
//  * Any other width, D % 8 != 0 included: a warp a row, four rows a block,
//    16-byte loads where the width is a multiple of 8 and scalar ones
//    otherwise, the fp32 row kept in shared memory between the sweeps.
//
// Sums run in a fixed order, with no atomics: two calls are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16x2.cuh"

namespace {

constexpr int kVec = 8;  // bf16 elements in 16 bytes
constexpr int kDefaultSmem = 48 * 1024;

using T = __nv_bfloat16;

__device__ __forceinline__ float to_f(T v) { return __bfloat162float(v); }
__device__ __forceinline__ T from_f(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Every rounding to the input type converts two values at once
// (bf16x2.cuh): the model staging rounds up to four times an element.
using T2 = __nv_bfloat162;
using muse::pair;
using muse::round2;

// h = x + residual of two elements: fp32, or rounded to the input type in the
// model staging; *pre gets h in the input type (the prenorm output)
template <bool kModel>
__device__ __forceinline__ float2 residual_sum2(float2 x, float2 r, T2* pre) {
  const float2 h = make_float2(x.x + r.x, x.y + r.y);
  *pre = __floats2bfloat162_rn(h.x, h.y);
  return kModel ? __bfloat1622float2(*pre) : h;
}

// the normalising factor: rounded to the input type for RMS in the model
// staging (jax.lax.rsqrt(var + eps).astype(x.dtype))
template <bool kModel, bool kLayerNorm>
__device__ __forceinline__ float norm_factor(float var, float eps) {
  const float inv = __frsqrt_rn(var + eps);
  return kModel && !kLayerNorm ? __bfloat162float(from_f(inv)) : inv;
}

// out = ((h - mean) * inv) * scale + bias for two elements, in fp32 or, in
// the model staging, rounded to the input type after each step; has_scale /
// has_bias false: no affine, no bias
template <bool kModel>
__device__ __forceinline__ T2 normed2(float2 h, float mean, float inv, bool has_scale, float2 s,
                                      bool has_bias, float2 b) {
  float2 y = make_float2((h.x - mean) * inv, (h.y - mean) * inv);
  if (kModel) y = round2(y);
  if (has_scale) {
    y = make_float2(y.x * s.x, y.y * s.y);
    if (kModel) y = round2(y);
  }
  if (has_bias) {
    y = make_float2(y.x + b.x, y.y + b.y);
    if (kModel) y = round2(y);
  }
  return __floats2bfloat162_rn(y.x, y.y);
}

// ---------------------------------------------------------------------------
// the row in registers: D = kVecs * kRowThreads * 8

// the sum of v over the kRowThreads threads of a row, in a fixed order;
// red holds one float a warp of the row
template <int kRowThreads>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (kRowThreads == 32) {
    return v;
  } else {
    constexpr int kWarps = kRowThreads / 32;
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    return total;
  }
}

template <bool kLayerNorm, bool kModel, int kVecs, int kRowThreads, int kRowsPerBlock>
__global__ void __launch_bounds__(kRowThreads * kRowsPerBlock)
register_row_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const T* __restrict__ scale, const T* __restrict__ bias,
                    T* __restrict__ out, T* __restrict__ prenorm, int rows, float eps) {
  static_assert(kRowThreads == 32 || kRowsPerBlock == 1, "a block of warps holds one row");
  constexpr int D = kVecs * kRowThreads * kVec;
  __shared__ float red[2][kRowThreads / 32];  // the two moments' per-warp sums
  const int t = threadIdx.x % kRowThreads;
  const int64_t row = int64_t(blockIdx.x) * kRowsPerBlock + threadIdx.x / kRowThreads;
  if (row >= rows) return;  // whole warps of a warp-a-row block only: no barrier there
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  const uint4* rr = reinterpret_cast<const uint4*>(res + row * D);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  const uint4* br = reinterpret_cast<const uint4*>(bias);

  // every load first: vector i of this thread is the row's vector i * kRowThreads + t
  uint4 xv[kVecs], rv[kVecs] = {}, sv[kVecs] = {}, bv[kVecs] = {};
#pragma unroll
  for (int i = 0; i < kVecs; ++i) xv[i] = xr[i * kRowThreads + t];
  if (res != nullptr) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) rv[i] = rr[i * kRowThreads + t];
  }
  if (scale != nullptr) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) sv[i] = sr[i * kRowThreads + t];
  }
  if (bias != nullptr) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) bv[i] = br[i * kRowThreads + t];
  }

  // h = x (+ res), the prenorm out, the first moment
  float h[kVecs][kVec];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    uint4 pv;
    T2* pe = reinterpret_cast<T2*>(&pv);
#pragma unroll
    for (int p = 0; p < kVec / 2; ++p) {
      const float2 v = res != nullptr
                           ? residual_sum2<kModel>(pair(xv[i], p), pair(rv[i], p), &pe[p])
                           : pair(xv[i], p);
      h[i][2 * p] = v.x;
      h[i][2 * p + 1] = v.y;
    }
    if (res != nullptr) reinterpret_cast<uint4*>(prenorm + row * D)[i * kRowThreads + t] = pv;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc += kLayerNorm ? h[i][j] : h[i][j] * h[i][j];
  }
  acc = row_sum<kRowThreads>(acc, red[0]);

  float mean = 0.f, var;
  if (kLayerNorm) {
    mean = acc / D;
    float acc2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = h[i][j] - mean;
        acc2 += d * d;
      }
    var = row_sum<kRowThreads>(acc2, red[1]) / D;
  } else {
    var = acc / D;
  }
  const float inv = norm_factor<kModel, kLayerNorm>(var, eps);

  // the normalised row with its affine.  RMS in the model staging multiplies
  // bf16 pairs: h, the rounded factor and the scale are bf16 values, so the
  // exact product rounded once is the staging's rounding of each step
  const T2 inv2 = __float2bfloat162_rn(inv);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    uint4 ov;
    T2* oe = reinterpret_cast<T2*>(&ov);
#pragma unroll
    for (int p = 0; p < kVec / 2; ++p) {
      if constexpr (kModel && !kLayerNorm) {
        T2 y = __hmul2(__floats2bfloat162_rn(h[i][2 * p], h[i][2 * p + 1]), inv2);
        oe[p] = scale != nullptr ? __hmul2(y, reinterpret_cast<const T2*>(&sv[i])[p]) : y;
      } else {
        oe[p] = normed2<kModel>(make_float2(h[i][2 * p], h[i][2 * p + 1]), mean, inv,
                                scale != nullptr, pair(sv[i], p), bias != nullptr,
                                pair(bv[i], p));
      }
    }
    reinterpret_cast<uint4*>(out + row * D)[i * kRowThreads + t] = ov;
  }
}

// ---------------------------------------------------------------------------
// any width: a warp a row, the fp32 row in shared memory

constexpr int kGenericRows = 4;  // one warp a row
constexpr int kGenericThreads = 32 * kGenericRows;

template <bool kLayerNorm, bool kModel>
__global__ void __launch_bounds__(kGenericThreads)
generic_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const T* __restrict__ scale, const T* __restrict__ bias,
               T* __restrict__ out, T* __restrict__ prenorm, int rows, int D, float eps) {
  extern __shared__ float srow[];  // kGenericRows rows of D floats
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kGenericRows + warp;
  if (row >= rows) return;  // whole warps only: no block barrier below
  float* h = srow + warp * D;
  const int64_t base = row * D;
  const bool vec = D % kVec == 0;

  // sweep 1: h = x (+ res) into shared memory, prenorm out, first moment
  float acc = 0.f;
  if (vec) {
    for (int v = lane; v < D / kVec; v += 32) {
      const uint4 xv = reinterpret_cast<const uint4*>(x + base)[v];
      float f[kVec];
#pragma unroll
      for (int p = 0; p < kVec / 2; ++p) {
        f[2 * p] = pair(xv, p).x;
        f[2 * p + 1] = pair(xv, p).y;
      }
      if (res != nullptr) {
        const uint4 rv = reinterpret_cast<const uint4*>(res + base)[v];
        uint4 pv;
        T2* pe = reinterpret_cast<T2*>(&pv);
#pragma unroll
        for (int p = 0; p < kVec / 2; ++p) {
          const float2 h2 = residual_sum2<kModel>(make_float2(f[2 * p], f[2 * p + 1]),
                                                  pair(rv, p), &pe[p]);
          f[2 * p] = h2.x;
          f[2 * p + 1] = h2.y;
        }
        reinterpret_cast<uint4*>(prenorm + base)[v] = pv;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        h[v * kVec + i] = f[i];
        acc += kLayerNorm ? f[i] : f[i] * f[i];
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      float f = to_f(x[base + i]);
      if (res != nullptr) {
        T2 pre;
        const float r = to_f(res[base + i]);
        f = residual_sum2<kModel>(make_float2(f, f), make_float2(r, r), &pre).x;
        prenorm[base + i] = pre.x;
      }
      h[i] = f;
      acc += kLayerNorm ? f : f * f;
    }
  }
  __syncwarp();
  acc = warp_sum(acc);

  float mean = 0.f, var;
  if (kLayerNorm) {
    mean = acc / D;
    float acc2 = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = h[i] - mean;
      acc2 += d * d;
    }
    var = warp_sum(acc2) / D;
  } else {
    var = acc / D;
  }
  const float inv = norm_factor<kModel, kLayerNorm>(var, eps);
  // elements i and j (j = i for one element alone)
  auto elems = [&](int i, int j) {
    const float2 s2 = scale ? make_float2(to_f(scale[i]), to_f(scale[j])) : make_float2(0.f, 0.f);
    const float2 b2 = bias ? make_float2(to_f(bias[i]), to_f(bias[j])) : make_float2(0.f, 0.f);
    return normed2<kModel>(make_float2(h[i], h[j]), mean, inv, scale != nullptr, s2,
                           bias != nullptr, b2);
  };

  // sweep 2: the normalised row with its affine
  if (vec) {
    for (int v = lane; v < D / kVec; v += 32) {
      uint4 ov;
      T2* oe = reinterpret_cast<T2*>(&ov);
#pragma unroll
      for (int p = 0; p < kVec / 2; ++p) oe[p] = elems(v * kVec + 2 * p, v * kVec + 2 * p + 1);
      reinterpret_cast<uint4*>(out + base)[v] = ov;
    }
  } else {
    for (int i = lane; i < D; i += 32) out[base + i] = elems(i, i).x;
  }
}

struct Args {
  const T *x, *res, *scale, *bias;
  T *out, *prenorm;
  int rows;
  float eps;
};

template <bool kLayerNorm, bool kModel, int kVecs, int kRowThreads, int kRowsPerBlock>
int launch_register_row(const Args& a, cudaStream_t stream) {
  const int blocks = (a.rows + kRowsPerBlock - 1) / kRowsPerBlock;
  register_row_kernel<kLayerNorm, kModel, kVecs, kRowThreads, kRowsPerBlock>
      <<<blocks, kRowThreads * kRowsPerBlock, 0, stream>>>(a.x, a.res, a.scale, a.bias, a.out,
                                                            a.prenorm, a.rows, a.eps);
  return int(cudaGetLastError());
}

template <bool kLayerNorm, bool kModel>
int launch(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 768: return launch_register_row<kLayerNorm, kModel, 3, 32, 2>(a, stream);
    case 1024: return launch_register_row<kLayerNorm, kModel, 4, 32, 2>(a, stream);
    case 1280: return launch_register_row<kLayerNorm, kModel, 1, 160, 1>(a, stream);
    case 3072: return launch_register_row<kLayerNorm, kModel, 3, 128, 1>(a, stream);
    case 4096: return launch_register_row<kLayerNorm, kModel, 4, 128, 1>(a, stream);
    default: break;
  }
  const size_t smem = sizeof(float) * kGenericRows * size_t(D);
  auto kernel = generic_kernel<kLayerNorm, kModel>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int blocks = (a.rows + kGenericRows - 1) / kGenericRows;
  kernel<<<blocks, kGenericThreads, smem, stream>>>(a.x, a.res, a.scale, a.bias, a.out,
                                                    a.prenorm, a.rows, D, a.eps);
  return int(cudaGetLastError());
}

}  // namespace

// x, res (rows, D); scale, bias (D,); out, prenorm (rows, D); all bf16,
// contiguous, 16-byte aligned.  res, scale, bias and prenorm may be null
// (prenorm must be given with res).  layer_norm 0 = RMSNorm, 1 = LayerNorm;
// model_staging 0 = the Pallas kernels' staging, 1 = the JAX model's.  D 768,
// 1024, 1280, 3072 and 4096 keep the row in registers; other widths take the
// generic kernel.
extern "C" int muse_fused_norm(const void* x, const void* res, const void* scale,
                               const void* bias, void* out, void* prenorm, int rows, int D,
                               float eps, int layer_norm, int model_staging, void* stream_ptr) {
  if (rows <= 0 || D <= 0 || (res != nullptr && prenorm == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Args a{static_cast<const T*>(x),     static_cast<const T*>(res),
               static_cast<const T*>(scale), static_cast<const T*>(bias),
               static_cast<T*>(out),         static_cast<T*>(prenorm),
               rows,                         eps};
  if (model_staging)
    return layer_norm ? launch<true, true>(a, D, stream) : launch<false, true>(a, D, stream);
  return layer_norm ? launch<true, false>(a, D, stream) : launch<false, false>(a, D, stream);
}

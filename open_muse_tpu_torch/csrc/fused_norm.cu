// Residual add + RMSNorm or LayerNorm over the last axis, one pass over the
// rows:
//
//   h        = x (+ residual)                     fp32
//   prenorm  = h cast to the input type            (written only with a residual)
//   RMS:  out = h * rsqrt(mean(h^2) + eps) * scale
//   LN:   out = (h - mean(h)) * rsqrt(mean((h - mean)^2) + eps) * scale (+ bias)
//
// the moments and the affine in fp32, one cast at the end.  Replaces the
// Pallas TPU kernels open_muse_tpu/ops/pallas/fused_norm.py
// `fused_residual_rmsnorm` (body `_rms_kernel`) and `fused_residual_layernorm`
// (body `_ln_kernel`), which take blocks of 256 rows into VMEM; here the
// kernel kind is a template flag on one kernel.
//
// What bounds it on the H100: the bytes.  Each row is read once (x, and the
// residual when given) and written once or twice (out, and prenorm with a
// residual); a few fp32 operations an element are nothing beside that at
// 3.35 TB/s.  A (2, 256, 768) bf16 call with a residual moves 3.1 MB: ~0.9 us.
//
// What the design does about it: one warp per row, four rows a block, 16-byte
// loads and stores where the row width allows (a multiple of 8 elements),
// scalar ones otherwise, so any width works.  The fp32 row is kept
// in shared memory between the passes, so device memory is read once; the
// LayerNorm variance is a second pass over that copy (the TPU kernel's
// mean((h - mean)^2), not E[h^2] - mean^2).  Warp shuffles reduce; no block
// barrier, no atomics, so two calls are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp a row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kDefaultSmem = 48 * 1024;

using T = __nv_bfloat16;

__device__ __forceinline__ float to_f(T v) { return __bfloat162float(v); }
__device__ __forceinline__ T from_f(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out = ((h - mean) * inv) * scale + bias for one element; scale / bias may
// be null (no affine, no bias)
__device__ __forceinline__ float affine(float h, float mean, float inv, const T* scale,
                                        const T* bias, int i) {
  float y = (h - mean) * inv;
  if (scale != nullptr) y *= to_f(scale[i]);
  if (bias != nullptr) y += to_f(bias[i]);
  return y;
}

template <bool kLayerNorm>
__global__ void __launch_bounds__(kThreads)
fused_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                  const T* __restrict__ scale, const T* __restrict__ bias,
                  T* __restrict__ out, T* __restrict__ prenorm, int rows, int D, float eps) {
  extern __shared__ float srow[];  // kRowsPerBlock rows of D floats
  constexpr int kVec = 8;  // bf16 elements in 16 bytes
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warps only: no block barrier below
  float* h = srow + warp * D;
  const int64_t base = row * D;
  const bool vec = D % kVec == 0;

  // pass 1: h = x (+ res) in fp32 into shared memory, prenorm out, first moment
  float acc = 0.f;
  if (vec) {
    for (int v = lane; v < D / kVec; v += 32) {
      const uint4 xv = reinterpret_cast<const uint4*>(x + base)[v];
      const T* xe = reinterpret_cast<const T*>(&xv);
      float f[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = to_f(xe[i]);
      if (res != nullptr) {
        const uint4 rv = reinterpret_cast<const uint4*>(res + base)[v];
        const T* re = reinterpret_cast<const T*>(&rv);
        uint4 pv;
        T* pe = reinterpret_cast<T*>(&pv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          f[i] += to_f(re[i]);
          pe[i] = from_f(f[i]);
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
        f += to_f(res[base + i]);
        prenorm[base + i] = from_f(f);
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
  const float inv = __frsqrt_rn(var + eps);

  // pass 2: the normalised row with its affine, one cast
  if (vec) {
    for (int v = lane; v < D / kVec; v += 32) {
      uint4 ov;
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        oe[i] = from_f(affine(h[v * kVec + i], mean, inv, scale, bias, v * kVec + i));
      reinterpret_cast<uint4*>(out + base)[v] = ov;
    }
  } else {
    for (int i = lane; i < D; i += 32)
      out[base + i] = from_f(affine(h[i], mean, inv, scale, bias, i));
  }
}

template <bool kLayerNorm>
int launch(const void* x, const void* res, const void* scale, const void* bias, void* out,
           void* prenorm, int rows, int D, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRowsPerBlock * size_t(D);
  auto kernel = fused_norm_kernel<kLayerNorm>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(out), static_cast<T*>(prenorm), rows, D, eps);
  return int(cudaGetLastError());
}

}  // namespace

// x, res (rows, D); scale, bias (D,); out, prenorm (rows, D); all bf16,
// contiguous, 16-byte aligned.  res, scale,
// bias and prenorm may be null (prenorm must be given with res).
// layer_norm 0 = RMSNorm, 1 = LayerNorm.
extern "C" int muse_fused_norm(const void* x, const void* res, const void* scale,
                               const void* bias, void* out, void* prenorm, int rows, int D,
                               float eps, int layer_norm, void* stream_ptr) {
  if (rows <= 0 || D <= 0 || (res != nullptr && prenorm == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return layer_norm ? launch<true>(x, res, scale, bias, out, prenorm, rows, D, eps, stream)
                    : launch<false>(x, res, scale, bias, out, prenorm, rows, D, eps, stream);
}

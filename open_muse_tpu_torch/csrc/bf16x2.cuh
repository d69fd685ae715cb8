// Two bf16 values at a time: every rounding to bf16 converts a pair with one
// instruction, since conversions run at a quarter of the arithmetic rate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace muse {

// v rounded to bf16 and back
__device__ __forceinline__ float2 round2(float2 v) {
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
}

// the two bf16 values at pair p (0 - 3) of a 16-byte vector, as floats
__device__ __forceinline__ float2 pair(const uint4& v, int p) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&v)[p]);
}

}  // namespace muse

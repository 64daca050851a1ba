// Element types the kernels take (f32 and bf16) and their conversions to
// and from the f32 the kernels compute in; f64, the guarded fits' last
// fallback rung, has kernels of its own (f64_tile.cuh) that compute in f64.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch_log.cuh"

namespace rt {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F64 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O>
__device__ __forceinline__ O from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace rt

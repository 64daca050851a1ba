// What the KMV and gram kernels share: the kernel parameters and the
// paper's Table-1 epilogue (linear / polynomial / rbf), applied to an f32
// dot product a . b in registers, with the squared norms |a|^2 and |b|^2
// for rbf; the cp.async copies that fill their shared-memory rings; loads
// of four elements (f32, or bf16 widened to f32) and the fixed-order warp
// sum.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "dtype.cuh"

namespace rt {

constexpr int KERNEL_LINEAR = 0;
constexpr int KERNEL_POLYNOMIAL = 1;
constexpr int KERNEL_RBF = 2;

struct KernelParams {
  int kind;
  int degree;
  float coef0;
  float sigma;
};

// x^d by binary exponentiation: the same products as jnp's integer **.
__device__ __forceinline__ float integer_pow(float x, int d) {
  if (d == 0) return 1.0f;
  float acc = 0.0f;
  bool have = false;
  while (d > 0) {
    if (d & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    d >>= 1;
    if (d > 0) x = x * x;
  }
  return acc;
}

__device__ __forceinline__ float epilogue(float dot, float rs, float cs,
                                          const KernelParams& p) {
  if (p.kind == KERNEL_LINEAR) return dot;
  if (p.kind == KERNEL_POLYNOMIAL) return integer_pow(p.coef0 + dot, p.degree);
  const float sq = (rs + cs) - 2.0f * dot;
  return expf(-p.sigma * fmaxf(sq, 0.0f));
}

// ---- copies into shared memory --------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int src_bytes = in ? BYTES : 0;          // 0: fill with zeros
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- four elements at a time ------------------------------------------------

__device__ __forceinline__ float4 bf16x4_to_f32(uint2 u) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  return bf16x4_to_f32(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float warp_sum(float v) {
  // a fixed butterfly; a + b == b + a, so every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rt

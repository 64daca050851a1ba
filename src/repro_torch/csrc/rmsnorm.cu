// RMSNorm: y = x * rsqrt(mean(x^2, -1) + eps) * scale, row by row, with
// the statistics in f32 and y in x's dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (body
// _rmsnorm_kernel).  In the port every norm of the LM (norm1, norm2, the
// Qwen3 q_norm / k_norm rows and final_norm) goes through it: 113
// launches per Qwen3-1.7B forward or decode step.
//
// What bounds it on an H100: it reads x once and writes y once, 4 FLOP
// per element, so it is bound by bytes: (8192, 2048) bf16 is 67.1 MB, 20
// us at 3.35 TB/s, and so are the (131 072, 128) q/k-norm rows.
//
// Design.  The model's widths, D = 128 and 2048, are compiled in
// (rmsnorm_row_kernel): a row is read once, in 16-byte vectors, into
// registers, where it stays between the sum of squares and the scaling.
// A row takes as many lanes as it has vectors, up to a warp (at D = 128
// in bf16, 16 lanes: two rows a warp, where one row left half the warp
// idle), and a lane takes up to 4 rows' vectors at once, so enough loads
// are in flight at D = 128.  scale is read in 16-byte vectors too.  Any
// other D takes the generic kernel (rmsnorm_kernel: one warp a row, the
// second pass re-reading the row from L1), and a row or pointer off a
// 16-byte boundary its element-by-element form.  Each lane sums its
// squares in index order and a fixed butterfly of warp shuffles finishes
// the sum, so every lane holds the same bits and results repeat.  Rows
// past the end are masked by the row index, not padded.
#include <stdint.h>

#include "dtype.cuh"

namespace rt {

constexpr int RMS_WARPS = 8;
constexpr int RMS_THREADS = 32 * RMS_WARPS;

// scale[c .. c + V) as f32, V = 4 or 8, from 16-byte-aligned memory
template <int V>
__device__ __forceinline__ void load_scale(const float* __restrict__ scale,
                                           int c, float (&s)[V]) {
#pragma unroll
  for (int q = 0; q < V; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(scale + c + q);
    s[q] = f.x;
    s[q + 1] = f.y;
    s[q + 2] = f.z;
    s[q + 3] = f.w;
  }
}

// D compiled in; x, y and scale 16-byte aligned.  A row is LPR lanes' VPL
// vectors each; a warp holds RPW rows at a time and each lane G of them.
template <typename T, int D>
__global__ void __launch_bounds__(RMS_THREADS)
    rmsnorm_row_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ y,
                       int rows, float eps) {
  constexpr int V = 16 / sizeof(T);        // elements a vector
  constexpr int VPR = D / V;               // vectors a row
  constexpr int LPR = VPR < 32 ? VPR : 32; // lanes a row
  constexpr int RPW = 32 / LPR;            // rows a warp side by side
  constexpr int VPL = VPR / LPR;           // vectors a lane in a row
  constexpr int G = VPL >= 4 ? 1 : 4 / VPL;  // rows a lane at once
  static_assert(D % V == 0 && VPR % LPR == 0, "D");
  const int lane = threadIdx.x % 32, sub = lane % LPR;
  const long row0 = ((long)blockIdx.x * RMS_WARPS + threadIdx.x / 32) *
                        RPW * G + lane / LPR;

  uint4 raw[G][VPL];
  float ss[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long row = row0 + (long)RPW * g;
    ss[g] = 0.0f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      raw[g][v] = row < rows ? *reinterpret_cast<const uint4*>(
                                   x + row * D + (sub + LPR * v) * V)
                             : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const T* e = reinterpret_cast<const T*>(&raw[g][v]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = to_f32(e[k]);
        ss[g] = fmaf(f, f, ss[g]);
      }
    }
    // every lane takes part, rows past the end too (their sums are unused)
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      ss[g] += __shfl_xor_sync(0xffffffffu, ss[g], off);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long row = row0 + (long)RPW * g;
    if (row >= rows) continue;
    const float r = rsqrtf(ss[g] / (float)D + eps);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c = (sub + LPR * v) * V;
      float s[V];
      load_scale<V>(scale, c, s);
      const T* e = reinterpret_cast<const T*>(&raw[g][v]);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = from_f32<T>(to_f32(e[k]) * r * s[k]);
      *reinterpret_cast<uint4*>(y + row * D + c) = packed;
    }
  }
}

// Any D: one warp a row.  VECTOR: D a whole number of 16-byte vectors and
// x, y, scale aligned for them.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(RMS_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * RMS_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  constexpr int V = 16 / sizeof(T);    // elements in one 16-byte vector

  float ss = 0.0f;
  if (VECTOR) {
    for (int c = lane * V; c < D; c += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float f = to_f32(e[v]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float f = to_f32(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)D + eps);

  if (VECTOR) {
    for (int c = lane * V; c < D; c += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      float s[V];
      load_scale<V>(scale, c, s);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = from_f32<T>(to_f32(e[v]) * r * s[v]);
      *reinterpret_cast<uint4*>(yr + c) = packed;
    }
  } else {
    for (int c = lane; c < D; c += 32)
      yr[c] = from_f32<T>(to_f32(xr[c]) * r * scale[c]);
  }
}

template <typename T, int D>
void launch_rows(const T* x, const float* scale, T* y, int rows, float eps,
                 cudaStream_t st) {
  constexpr int VPR = D * (int)sizeof(T) / 16;
  constexpr int LPR = VPR < 32 ? VPR : 32, VPL = VPR / LPR;
  constexpr int PER_BLOCK =
      RMS_WARPS * (32 / LPR) * (VPL >= 4 ? 1 : 4 / VPL);
  rt::launch(rmsnorm_row_kernel<T, D>, (rows + PER_BLOCK - 1) / PER_BLOCK,
      RMS_THREADS, 0, st, x, scale, y, rows, eps);
}

template <typename T>
void launch_rmsnorm(const void* x, const float* scale, void* y, int rows,
                    int D, float eps, cudaStream_t st) {
  const int blocks = (rows + RMS_WARPS - 1) / RMS_WARPS;
  const bool vector = D % (16 / (int)sizeof(T)) == 0 &&
                      (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                      (uintptr_t)scale % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vector && D == 128)
    launch_rows<T, 128>(xt, scale, yt, rows, eps, st);
  else if (vector && D == 2048)
    launch_rows<T, 2048>(xt, scale, yt, rows, eps, st);
  else if (vector)
    rt::launch(rmsnorm_kernel<T, true>, blocks, RMS_THREADS, 0, st, xt, scale,
        yt, rows, D, eps);
  else
    rt::launch(rmsnorm_kernel<T, false>, blocks, RMS_THREADS, 0, st, xt, scale,
        yt, rows, D, eps);
}

}  // namespace rt

// x, y (rows, D) row-major in dtype f32 (0) or bf16 (1); scale (D,) f32.
// Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              int rows, int D, int dtype, float eps,
                              void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (dtype == DTYPE_BF16)
    launch_rmsnorm<__nv_bfloat16>(x, s, y, rows, D, eps, st);
  else
    launch_rmsnorm<float>(x, s, y, rows, D, eps, st);
  return static_cast<int>(cudaGetLastError());
}

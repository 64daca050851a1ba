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
// us at 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block.  Each lane
// reads its share of the row in 16-byte vectors (when D and the pointers
// allow; element by element otherwise), sums the squares in f32 in index
// order, and a butterfly of warp shuffles finishes the sum in a fixed
// order, so every lane holds the same bits and results repeat.  The
// second pass re-reads the row (from L1: a block's eight rows are at most
// 64 KB at D = 2048 f32) and writes x * r * scale.  Rows past the end are
// masked by the row index, not padded.
#include <stdint.h>

#include "dtype.cuh"

namespace rt {

constexpr int RMS_WARPS = 8;
constexpr int RMS_THREADS = 32 * RMS_WARPS;

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
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = from_f32<T>(to_f32(e[v]) * r * scale[c + v]);
      *reinterpret_cast<uint4*>(yr + c) = packed;
    }
  } else {
    for (int c = lane; c < D; c += 32)
      yr[c] = from_f32<T>(to_f32(xr[c]) * r * scale[c]);
  }
}

template <typename T>
void launch_rmsnorm(const void* x, const float* scale, void* y, int rows,
                    int D, float eps, cudaStream_t st) {
  const int blocks = (rows + RMS_WARPS - 1) / RMS_WARPS;
  const bool vector = D % (16 / (int)sizeof(T)) == 0 &&
                      (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vector)
    rmsnorm_kernel<T, true><<<blocks, RMS_THREADS, 0, st>>>(xt, scale, yt,
                                                            rows, D, eps);
  else
    rmsnorm_kernel<T, false><<<blocks, RMS_THREADS, 0, st>>>(xt, scale, yt,
                                                             rows, D, eps);
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

// Gram: out = K(A, B) = epilogue(A B^T), an (m, r) kernel slab in f32 or
// bf16, with f32 accumulation.
//
// Replaces: src/repro/kernels/gram.py, gram_pallas (body _gram_kernel), the
// TPU kernel behind every s-step round's (sb x sb) cross block and the
// materialized-slab (slab_free=False) parity path.
//
// What bounds it on an H100: 2*m*r*n FLOP against (m + r)*n input words
// and m*r output words.  The round's cross block (256 x 256 x 8192 for
// K-RR at s = 8, b = 32) does ~63 FLOP per byte: operation-bound at the
// card's FP32 rate (16 us for its 1.07 GFLOP at 67 TFLOP/s), but it fills
// only 16 of the 132 SMs, so its time is mostly one block's latency.
// The K-SVM cross block (32 x 32) is a single block.
//
// Design: one block per (BM x BR) output tile (the TPU grid's parallel
// (i, j) axes), looping over n through shared memory (kernel_tile.cuh)
// where the TPU grid had its sequential k axis; the RBF norms are
// accumulated in the same loop, the epilogue is applied once in
// registers, and the store into the (m, r) output is masked at the
// ragged edges instead of padding copies.
#include "kernel_tile.cuh"

namespace rt {

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
    gram_kernel(const T* __restrict__ A, const T* __restrict__ B,
                O* __restrict__ out, int m, int r, int n, KernelParams p) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x;
  const int tx = tid % COL_STRIDE;
  const int ty = tid / COL_STRIDE;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BR;
  float acc[TM][TN];
  tile_dots<T>(A, B, row0, m, col0, r, n, p.kind == KERNEL_RBF, sm, acc);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty + ROW_STRIDE * i;
    if (row0 + row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tx + COL_STRIDE * j;
      if (col0 + col >= r) continue;
      out[(size_t)(row0 + row) * r + col0 + col] =
          from_f32<O>(epilogue(acc[i][j], sm.rs[row], sm.cs[col], p));
    }
  }
}

template <typename T>
void launch_gram(const void* A, const void* B, void* out, int m, int r, int n,
                 int out_dtype, const KernelParams& p, cudaStream_t st) {
  const dim3 grid((r + BR - 1) / BR, (m + BM - 1) / BM);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  if (out_dtype == DTYPE_BF16)
    gram_kernel<T, __nv_bfloat16><<<grid, THREADS, 0, st>>>(
        a, b, static_cast<__nv_bfloat16*>(out), m, r, n, p);
  else
    gram_kernel<T, float><<<grid, THREADS, 0, st>>>(
        a, b, static_cast<float*>(out), m, r, n, p);
}

}  // namespace rt

// A (m, n), B (r, n): row-major, in_dtype f32 (0) or bf16 (1) for both.
// out (m, r) row-major in out_dtype.  Returns cudaGetLastError().
extern "C" int gram_launch(const void* A, const void* B, void* out, int m,
                           int r, int n, int in_dtype, int out_dtype, int kind,
                           int degree, float coef0, float sigma,
                           void* stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == DTYPE_BF16)
    launch_gram<__nv_bfloat16>(A, B, out, m, r, n, out_dtype, p, st);
  else
    launch_gram<float>(A, B, out, m, r, n, out_dtype, p, st);
  return static_cast<int>(cudaGetLastError());
}

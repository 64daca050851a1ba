// KMV: out = K(A, B)^T X for the paper's three kernels, without ever
// writing the m x r kernel slab to device memory.
//
// Replaces: src/repro/kernels/kmv.py, kmv_pallas (body _kmv_kernel), the
// TPU kernel behind every s-step round's U^T alpha, the full K @ alpha of
// the convergence checks, and the query-block contraction of prediction.
//
// What bounds it on an H100: at the solve path's shapes the work is
// 2*m*r*n FMAs against m*n input words.  For a K-SVM round (r = 32) that
// is ~16 FLOP per byte of A: below the FP32 ridge of the card (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte), so the ideal kernel streams A once at
// memory speed.  For the full matvec (r = m) it is operation-bound, at
// half the FLOP of a general B = 19 996 rows, since K(A, A) is symmetric.
//
// Design: the TPU grid carried its (c x br) output accumulator across a
// sequential (i, k) sweep in VMEM; blocks on Hopper run in no order, so
// that sweep becomes a loop inside each block and the cross-block sum a
// second pass.  The contraction takes one design per width r of the
// output (kmv_partial.cuh): rows of A streamed by warps at r <= 8, a tile
// as wide as r up to 64, an SGEMM-class 128 x 128 FP32 tile beyond, and
// for B = A only the tiles on and above the diagonal (K(A, A) is
// symmetric, so each off-diagonal tile serves its mirror too); each
// block writes its (r x c) partial to its own slice of an f32 workspace
// (splits, r, c), and a second small kernel sums the slices in a fixed
// order, so results repeat from run to run (no atomics).  Rows at or past
// m are masked in the kernel and contribute exactly zero (K(0, b) != 0
// for rbf and polynomial).
#include "kmv_partial.cuh"

// A (m, n), B (r, n): row-major, dtype f32 (0) or bf16 (1), the same for
// both.  X (m, c) row-major f32.  ws: f32 scratch of splits * r * c + r
// floats (the blocks' (r, c) slices, then |b_j|^2), out (r, c) f32.  The
// plan (kernels/kmv.kmv_plan): regime (rows 0, narrow 1, wide 2), bm x br
// the tile (the row group x r for rows), and row split s covering rows
// [s*rows_per_split, (s+1)*rows_per_split).  Returns the first CUDA error
// (cudaErrorInvalidValue for a plan that has no kernel), or 0.
extern "C" int kmv_launch(const void* A, const void* B, const void* X,
                          void* ws, void* out, int m, int r, int n, int c,
                          int regime, int bm, int br, int splits,
                          int rows_per_split, int dtype, int kind,
                          int degree, float coef0, float sigma,
                          void* stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  float* wsf = static_cast<float*>(ws);
  float* bn = wsf + (size_t)splits * r * c;
  const bool bf16 = dtype == DTYPE_BF16;
  cudaError_t err = cudaSuccess;
  if (kind == KERNEL_RBF)
    err = bf16 ? kmv_bnorms<__nv_bfloat16>(B, bn, r, n, st)
               : kmv_bnorms<float>(B, bn, r, n, st);
  if (err == cudaSuccess)
    err = bf16 ? kmv_partial<__nv_bfloat16>(A, B, bn, Xf, wsf, m, r, n, c,
                                            regime, bm, br, splits,
                                            rows_per_split, 0, p, st)
               : kmv_partial<float>(A, B, bn, Xf, wsf, m, r, n, c, regime, bm,
                                    br, splits, rows_per_split, 0, p, st);
  if (err == cudaSuccess)
    err = kmv_reduce(wsf, static_cast<float*>(out), splits, (long long)r * c,
                     st);
  return static_cast<int>(err);
}

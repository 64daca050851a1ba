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
// memory speed.  For the full matvec (r = m) it is operation-bound.
//
// Design: the TPU grid carried its (c x br) output accumulator across a
// sequential (i, k) sweep in VMEM; blocks on Hopper run in no order, so
// that sweep becomes a loop inside each block and the cross-block sum a
// second pass.  With r as small as 32, splitting along r alone would
// leave 131 of 132 SMs idle, so the grid is (r tiles) x (m splits): each
// block loops over the BM-row tiles of its m range, accumulates the dot
// tile over n through shared memory (kernel_tile.cuh), applies the
// epilogue in registers, stages the finished (BM x BR) kernel tile in
// shared memory and contracts it at once against the matching rows of X
// into its own slice of an f32 workspace (splits, r, c).  A second small
// kernel sums the slices in a fixed order, so results repeat from run to
// run (no atomics).  Rows at or past m are masked in the kernel and
// contribute exactly zero (K(0, b) != 0 for rbf and polynomial).
#include "kmv_partial.cuh"

// A (m, n), B (r, n): row-major, dtype f32 (0) or bf16 (1), the same for
// both.  X (m, c) row-major f32.  ws (splits, r, c) f32 scratch, out (r, c)
// f32.  Row split s covers rows [s*rows_per_split, (s+1)*rows_per_split);
// rows_per_split is a multiple of BM.  Returns cudaGetLastError().
extern "C" int kmv_launch(const void* A, const void* B, const void* X,
                          void* ws, void* out, int m, int r, int n, int c,
                          int splits, int rows_per_split, int dtype, int kind,
                          int degree, float coef0, float sigma,
                          void* stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((r + BR - 1) / BR, splits);
  if (dtype == DTYPE_BF16) {
    kmv_partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), static_cast<const float*>(X),
        static_cast<float*>(ws), m, r, n, c, rows_per_split, 0, p);
  } else {
    kmv_partial_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(X), static_cast<float*>(ws), m, r, n, c,
        rows_per_split, 0, p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rc = (long long)r * c;
  const int threads = 256;
  kmv_reduce_kernel<<<(unsigned)((rc + threads - 1) / threads), threads, 0,
                      st>>>(static_cast<const float*>(ws),
                            static_cast<float*>(out), splits, rc);
  return static_cast<int>(cudaGetLastError());
}

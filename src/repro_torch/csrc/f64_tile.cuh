// The f64 route of KMV and gram: the guarded fits' last fallback rung
// (ROADMAP C12) runs its rounds, corrections and checks in f64, which the
// f32 kernels cannot give.  A simple FP64 tile, shared by kmv.cu, gram.cu
// and kmv_stream.cu: correctness first, since the rung runs only after
// every f32 rung has diverged.
//
// One block of 256 threads owns a 32 x 32 tile of K(A, B): it walks the
// feature axis in 32-wide chunks staged through shared memory (a row
// stride of 33 doubles), each thread summing four dots (rows ty + 8q,
// column tx) in DFMAs, and for rbf the squared norms of the tile's rows
// of A and B from the same chunks; the epilogue (the paper's Table 1, as
// kernel_tile.cuh, in f64 with the kernel's parameters in f64) follows.
//   gram_f64_kernel        writes the tile to the (m, r) output;
//   kmv_f64_kernel         a block of the (r tiles) x (m splits) grid walks
//                          the row tiles of its split, contracts each K
//                          tile with X's rows into its (32 x c) slice of an
//                          f64 workspace (splits, r, c), each output owned
//                          by one thread, tile after tile in order;
//   kmv_f64_reduce_kernel  sums the slices in split order.
// No atomics: every sum runs in a fixed order, so results repeat bit for
// bit.  Rows past m are masked (K(0, b) != 0 for rbf and polynomial).
// What bounds it on an H100: 2 m r n FLOP at 67 TFLOP/s (FP64 on the
// tensor cores, NVIDIA's SXM data sheet) against m n words of A.  This
// tile's DFMAs run outside the tensor cores (34 TFLOP/s at most), so it
// reaches a fraction of the bound (PERF.md); it repeats the contraction,
// split and epilogue of kmv_partial.cuh and gram.cu at f64 (ROADMAP A7c).
#pragma once

#include "kernel_tile.cuh"

namespace rt {

struct KernelParamsF64 {
  int kind;
  int degree;
  double coef0;
  double sigma;
};

constexpr int F64_T = 32;          // tile rows and columns
constexpr int F64_BK = 32;         // features a chunk
constexpr int F64_THREADS = 256;   // 32 columns x 8 row groups
constexpr int F64_RED_THREADS = 256;

__device__ __forceinline__ double integer_pow_f64(double x, int d) {
  if (d == 0) return 1.0;
  double acc = 0.0;
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

__device__ __forceinline__ double epilogue_f64(double dot, double rs,
                                               double cs,
                                               const KernelParamsF64& p) {
  if (p.kind == KERNEL_LINEAR) return dot;
  if (p.kind == KERNEL_POLYNOMIAL)
    return integer_pow_f64(p.coef0 + dot, p.degree);
  const double sq = (rs + cs) - 2.0 * dot;
  return exp(-p.sigma * fmax(sq, 0.0));
}

struct F64Tile {
  double a[F64_T][F64_BK + 1];
  double b[F64_T][F64_BK + 1];
  double an[F64_T];                // |a_i|^2 of the tile's rows (rbf)
  double bn[F64_T];                // |b_j|^2
};

// dots[q] = a_{ty + 8q} . b_{tx} over the n features of the ra rows of A
// and rb rows of B the tile starts at (rows past them read as zero); with
// `norms`, t.an and t.bn hold the rows' squared norms on return.
__device__ __forceinline__ void f64_dot_tile(const double* A, int ra,
                                             const double* B, int rb, int n,
                                             F64Tile& t, double (&dots)[4],
                                             bool norms) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) dots[q] = 0.0;
  double nrm = 0.0;
  for (int k0 = 0; k0 < n; k0 += F64_BK) {
    for (int e = threadIdx.x; e < F64_T * F64_BK; e += F64_THREADS) {
      const int row = e / F64_BK, k = e % F64_BK;
      const bool in = k0 + k < n;
      t.a[row][k] = (row < ra && in) ? A[(size_t)row * n + k0 + k] : 0.0;
      t.b[row][k] = (row < rb && in) ? B[(size_t)row * n + k0 + k] : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < F64_BK; ++k) {
      const double bv = t.b[tx][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) dots[q] = fma(t.a[ty + 8 * q][k], bv, dots[q]);
    }
    if (norms && ty < 2) {
      const double* row = ty == 0 ? t.a[tx] : t.b[tx];
      for (int k = 0; k < F64_BK; ++k) nrm = fma(row[k], row[k], nrm);
    }
    __syncthreads();
  }
  if (norms && ty < 2) (ty == 0 ? t.an : t.bn)[tx] = nrm;
  __syncthreads();
}

// out (m, r) = K(A, B), A (m, n) and B (r, n) row-major f64; grid
// (ceil(r / 32), ceil(m / 32)).
__global__ void __launch_bounds__(F64_THREADS)
    gram_f64_kernel(const double* __restrict__ A, const double* __restrict__ B,
                    double* __restrict__ out, int m, int r, int n,
                    KernelParamsF64 p) {
  __shared__ F64Tile t;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.y * F64_T, col0 = blockIdx.x * F64_T;
  const int ra = min(F64_T, m - row0), rb = min(F64_T, r - col0);
  double dots[4];
  f64_dot_tile(A + (size_t)row0 * n, ra, B + (size_t)col0 * n, rb, n, t,
               dots, p.kind == KERNEL_RBF);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = ty + 8 * q;
    if (i < ra && tx < rb)
      out[(size_t)(row0 + i) * r + col0 + tx] =
          epilogue_f64(dots[q], t.an[i], t.bn[tx], p);
  }
}

// ws (splits, r, c): block (x, y) adds K(A[rows of split y], B[32 x-tile
// columns])^T X[rows of split y] over the rows [0, rows) of A, tile after
// tile, into its slice; with `accumulate` onto what an earlier launch on
// the stream left there (the streamed pipe's sum over chunks).
__global__ void __launch_bounds__(F64_THREADS)
    kmv_f64_kernel(const double* __restrict__ A, const double* __restrict__ B,
                   const double* __restrict__ X, double* __restrict__ ws,
                   int rows, int r, int n, int c, int rows_per_split,
                   int accumulate, KernelParamsF64 p) {
  __shared__ F64Tile t;
  __shared__ double K[F64_T][F64_T + 1];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col0 = blockIdx.x * F64_T, rb = min(F64_T, r - col0);
  const int lo = blockIdx.y * rows_per_split;
  const int hi = min(rows, lo + rows_per_split);
  double* w = ws + (size_t)blockIdx.y * r * c + (size_t)col0 * c;
  bool first = !accumulate;
  for (int row0 = lo; row0 < hi; row0 += F64_T) {
    const int ra = min(F64_T, hi - row0);
    double dots[4];
    f64_dot_tile(A + (size_t)row0 * n, ra, B + (size_t)col0 * n, rb, n, t,
                 dots, p.kind == KERNEL_RBF);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = ty + 8 * q;
      K[i][tx] = (i < ra && tx < rb)
                     ? epilogue_f64(dots[q], t.an[i], t.bn[tx], p)
                     : 0.0;
    }
    __syncthreads();
    const double* x = X + (size_t)row0 * c;
    for (int e = threadIdx.x; e < rb * c; e += F64_THREADS) {
      const int j = e / c, col = e % c;
      double acc = 0.0;
      for (int i = 0; i < ra; ++i) acc = fma(K[i][j], x[(size_t)i * c + col], acc);
      w[e] = first ? acc : w[e] + acc;
    }
    first = false;
    __syncthreads();
  }
  if (first)                       // a split with no rows: a defined zero
    for (int e = threadIdx.x; e < rb * c; e += F64_THREADS) w[e] = 0.0;
}

__global__ void __launch_bounds__(F64_RED_THREADS)
    kmv_f64_reduce_kernel(const double* __restrict__ ws,
                          double* __restrict__ out, int splits, long long rc) {
  const long long e = (long long)blockIdx.x * F64_RED_THREADS + threadIdx.x;
  if (e >= rc) return;
  double acc = 0.0;
  for (int s = 0; s < splits; ++s) acc += ws[(size_t)s * rc + e];
  out[e] = acc;
}

inline cudaError_t gram_f64(const double* A, const double* B, double* out,
                            int m, int r, int n, const KernelParamsF64& p,
                            cudaStream_t st) {
  if ((m + F64_T - 1) / F64_T > 65535) return cudaErrorInvalidValue;
  const dim3 grid((r + F64_T - 1) / F64_T, (m + F64_T - 1) / F64_T);
  rt::launch(gram_f64_kernel, grid, F64_THREADS, 0, st, A, B, out, m, r, n, p);
  return cudaGetLastError();
}

// The partial contraction over `rows` rows of A into ws (splits, r, c);
// rows_per_split a multiple of 32 (kernels/kmv.kmv_f64_plan).
inline cudaError_t kmv_f64_partial(const double* A, const double* B,
                                   const double* X, double* ws, int rows,
                                   int r, int n, int c, int splits,
                                   int rows_per_split, int accumulate,
                                   const KernelParamsF64& p, cudaStream_t st) {
  if (splits < 1 || splits > 65535 || rows_per_split % F64_T != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((r + F64_T - 1) / F64_T, splits);
  rt::launch(kmv_f64_kernel, grid, F64_THREADS, 0, st, A, B, X, ws, rows, r, n,
      c, rows_per_split, accumulate, p);
  return cudaGetLastError();
}

inline cudaError_t kmv_f64_reduce(const double* ws, double* out, int splits,
                                  long long rc, cudaStream_t st) {
  rt::launch(kmv_f64_reduce_kernel,
      (unsigned)((rc + F64_RED_THREADS - 1) / F64_RED_THREADS),
      F64_RED_THREADS, 0, st, ws, out, splits, rc);
  return cudaGetLastError();
}

}  // namespace rt

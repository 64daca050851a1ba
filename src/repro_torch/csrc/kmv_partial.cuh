// The KMV contraction shared by the resident KMV (kmv.cu) and the streamed
// pipe (kmv_stream.cu): each block of a (r tiles) x (m splits) grid loops
// over the 64-row tiles of its m range, builds each (BM x BR) kernel tile
// in registers (kernel_tile.cuh), stages it in shared memory and contracts
// it at once against the matching rows of X into the block's own (BR x c)
// slice of an f32 workspace (splits, r, c).  A second kernel sums the
// slices in split order.  Rows at or past m are masked and contribute
// exactly zero (K(0, b) != 0 for rbf and polynomial).
#pragma once

#include "kernel_tile.cuh"

namespace rt {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    kmv_partial_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       const float* __restrict__ X, float* __restrict__ ws,
                       int m, int r, int n, int c, int rows_per_split,
                       int accumulate, KernelParams p) {
  __shared__ TileSmem sm;
  __shared__ float Kt[BM][BR + 1];

  const int tid = threadIdx.x;
  const int tx = tid % COL_STRIDE;
  const int ty = tid / COL_STRIDE;
  const int col0 = blockIdx.x * BR;
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(m, m_begin + rows_per_split);
  const int npairs = min(BR, r - col0) * c;
  // this block's (BR x c) slice of the workspace; pair q = j*c + cc is
  // always owned by the same thread, so the read-modify-writes below
  // need no synchronisation.  With accumulate the slice keeps what an
  // earlier launch on the same stream left there (the streamed pipe's
  // sum over chunks, in chunk order).
  float* wsb = ws + (size_t)blockIdx.y * r * c + (size_t)col0 * c;
  if (!accumulate)
    for (int q = tid; q < npairs; q += THREADS) wsb[q] = 0.0f;

  for (int i0 = m_begin; i0 < m_end; i0 += BM) {
    float acc[TM][TN];
    tile_dots<T>(A, B, i0, m_end, col0, r, n, p.kind == KERNEL_RBF, sm, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty + ROW_STRIDE * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + COL_STRIDE * j;
        Kt[row][col] = (i0 + row < m_end)
                           ? epilogue(acc[i][j], sm.rs[row], sm.cs[col], p)
                           : 0.0f;
      }
    }
    __syncthreads();
    const int nrows = min(BM, m_end - i0);
    const float* Xt = X + (size_t)i0 * c;
    for (int q = tid; q < npairs; q += THREADS) {
      const int j = q / c, cc = q % c;
      float s = 0.0f;
      for (int rr = 0; rr < nrows; ++rr) s = fmaf(Kt[rr][j], Xt[(size_t)rr * c + cc], s);
      wsb[q] += s;
    }
    __syncthreads();
  }
}

// out[e] = sum over splits of ws[split, e], in split order.
__global__ void kmv_reduce_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int splits,
                                  long long rc) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rc) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[(size_t)k * rc + e];
  out[e] = s;
}

}  // namespace rt

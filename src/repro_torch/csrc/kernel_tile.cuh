// Shared building block of the KMV and gram kernels: one (BM x BR) tile of
// dot products a_i . b_j accumulated in FP32 registers over the whole
// feature axis through shared memory, with the RBF squared norms of the
// tile's rows and columns accumulated in the same loop, and the paper's
// Table-1 epilogue (linear / polynomial / rbf) applied in registers.
//
// This is the simple, correct first version: FP32 FMAs on CUDA cores
// (no tensor cores, since TF32 cannot meet the f32 parity bounds), plain
// global loads, a 4x4 register micro-tile per thread.  Inputs are f32 or
// bf16 (converted to f32 as they are loaded into shared memory).
#pragma once

#include <stddef.h>

#include "dtype.cuh"

namespace rt {

constexpr int KERNEL_LINEAR = 0;
constexpr int KERNEL_POLYNOMIAL = 1;
constexpr int KERNEL_RBF = 2;

constexpr int BM = 64;                 // tile rows (rows of A)
constexpr int BR = 64;                 // tile columns (rows of B)
constexpr int BK = 32;                 // feature chunk per shared-memory stage
constexpr int TM = 4;                  // micro-tile rows per thread
constexpr int TN = 4;                  // micro-tile columns per thread
constexpr int THREADS = (BM / TM) * (BR / TN);   // 256
constexpr int ROW_STRIDE = BM / TM;    // thread rows are ty + ROW_STRIDE*i
constexpr int COL_STRIDE = BR / TN;    // thread cols are tx + COL_STRIDE*j

struct KernelParams {
  int kind;
  int degree;
  float coef0;
  float sigma;
};

struct TileSmem {
  float As[BK][BM + 1];                // +1: conflict-free transposed stores
  float Bs[BK][BR + 1];
  float rs[BM];                        // squared norms of the tile's A rows
  float cs[BR];                        // squared norms of the tile's B rows
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

// acc[i][j] = a_{row0 + ty + ROW_STRIDE*i} . b_{col0 + tx + COL_STRIDE*j}
// for the calling thread (tx = tid % COL_STRIDE, ty = tid / COL_STRIDE).
// Rows at or past row_end and columns at or past r load as zero.  With
// want_norms, sm.rs / sm.cs hold the tile's squared norms on return.
// Every thread of the block must call it (it synchronises).
template <typename T>
__device__ __forceinline__ void tile_dots(const T* __restrict__ A,
                                          const T* __restrict__ B, int row0,
                                          int row_end, int col0, int r, int n,
                                          bool want_norms, TileSmem& sm,
                                          float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % COL_STRIDE;
  const int ty = tid / COL_STRIDE;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float nrm = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    // consecutive threads read consecutive features of one row: coalesced
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int rr = e / BK, kk = e % BK;
      const int gr = row0 + rr, gk = k0 + kk;
      float v = 0.0f;
      if (gr < row_end && gk < n) v = to_f32(A[(size_t)gr * n + gk]);
      sm.As[kk][rr] = v;
    }
    for (int e = tid; e < BR * BK; e += THREADS) {
      const int cc = e / BK, kk = e % BK;
      const int gc = col0 + cc, gk = k0 + kk;
      float v = 0.0f;
      if (gc < r && gk < n) v = to_f32(B[(size_t)gc * n + gk]);
      sm.Bs[kk][cc] = v;
    }
    __syncthreads();

    if (want_norms) {                  // warps 0-1 rows, warps 2-3 columns
      if (tid < BM) {
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) nrm = fmaf(sm.As[kk][tid], sm.As[kk][tid], nrm);
      } else if (tid < BM + BR) {
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk)
          nrm = fmaf(sm.Bs[kk][tid - BM], sm.Bs[kk][tid - BM], nrm);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.As[kk][ty + ROW_STRIDE * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.Bs[kk][tx + COL_STRIDE * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (want_norms) {
    if (tid < BM)
      sm.rs[tid] = nrm;
    else if (tid < BM + BR)
      sm.cs[tid - BM] = nrm;
  }
  __syncthreads();
}

}  // namespace rt

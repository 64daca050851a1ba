// Gram: out = K(A, B) = epilogue(A B^T), an (m, r) kernel slab in f32 or
// bf16, with f32 accumulation.
//
// Replaces: src/repro/kernels/gram.py, gram_pallas (body _gram_kernel), the
// TPU kernel behind every s-step and classical round's (sb x sb) cross
// block, the materialized-slab (slab_free=False) parity path and the
// Nystrom maps.
//
// What bounds it on an H100: 2*m*r*n FLOP against (m + r)*n input words
// and m*r output words.  The K-RR cross block (256 x 256 x 8192) is
// operation-bound at the card's FP32 rate (16 us); the K-SVM block (32 x
// 32) and the classical one (1 x 1) are a few hundred KB of reads, so
// what they pay is latency: the launch and one pass over n; the slab
// (19 996 x 32) is bytes-bound (0.197 ms for A's 655 MB).
//
// Design.  The TPU grid walks n serially for each output tile; on the card
// that serial walk over one tile is the whole time at the round shapes
// (one block for 32 x 32, 16 of 132 SMs for 256 x 256).  So the feature
// axis is split across blocks (kernels/gram.gram_splits picks the tile and
// the split from m, r, n and the SM count: output tiles x splits fill the
// SMs about four times over; each split is a whole number of 32-feature
// chunks; a large output takes one split):
//   gram_partial_kernel  one block per (output tile, split): a BM x BR
//                        tile (BM, BR in {32, 64}, so r = 32 does not
//                        mask half of a 64-wide tile) of 8 x 4 outputs a
//                        thread in FP32 FMAs, the chunks of A and B in a
//                        ring of 2 to 4 shared-memory stages filled by
//                        cp.async (16-byte copies for f32, 8 for bf16; a
//                        plain copy where n or a base is not aligned for
//                        them), so one to three chunks are in flight while
//                        one is summed (the 19 996 x 32 slab reads A once
//                        and is latency-bound without them); the RBF
//                        squared norms are summed from the same chunks;
//   gram_dot_kernel      m, r <= 4 (the classical round's 1 x 1): one warp
//                        a split, a lane a feature, so no output is masked
//                        and no work is spent on padding;
//   gram_reduce_kernel   with more than one split, the partial dots and
//                        norms (an f32 workspace of splits x (m r + m + r))
//                        summed in split order, then the epilogue, with sq
//                        = rs + cs - 2 dot as kernel_tile.cuh does, and the
//                        store in the output dtype.
// One split applies the epilogue in the tile's own registers.  No atomics:
// every sum runs in a fixed order, so the result repeats bit for bit.  The
// reduce is a second small kernel rather than the last block to arrive: a
// counter would need zeroed device state kept between calls (and a stream
// of its own), for a launch of a few microseconds.
//
// f32 stays on FP32 FMAs: TF32 tensor cores cannot meet the 1e-4 parity
// bound (tests/test_pallas_gram.py) or the solvers' 1e-5 iterate parity.
#include <stdint.h>

#include "kernel_tile.cuh"   // shared with KMV: epilogue, cp.async, ld4

namespace rt {

constexpr int G_BK = 32;          // features a chunk; a split is whole chunks
constexpr int G_TM = 8;           // rows a thread
constexpr int G_TN = 4;           // columns a thread
constexpr int G_VEC = 4;          // elements a cp.async (16 B f32, 8 B bf16)
constexpr int G_LD = G_BK + 4;    // shared row stride: conflict-free reads
constexpr int G_DOT_MAX = 4;      // the dot kernel's largest m and r
constexpr int G_RED_X = 32;       // reduce block: 32 columns x 8 rows of
constexpr int G_RED_Y = 8;        // outputs, and two warps for the norms

// Stages of the chunk ring: as many as 47 KB of static shared memory holds,
// 2 to 4 (f32 64 x 64: 2; f32 64 x 32 and 32 x 64: 3; the rest: 4).
template <typename T, int TBM, int TBR>
struct GramStages {
  static constexpr int BYTES = (TBM + TBR) * G_LD * (int)sizeof(T);
  static constexpr int FIT = (47 * 1024) / BYTES;
  static constexpr int value = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
};

// Chunk k0 .. k0 + G_BK of rows row0 .. row0 + ROWS of a row-major (nrows,
// n) matrix into dst[row][G_LD]; rows past nrows and features past n are 0.
// vec: n % G_VEC == 0 and the base aligned for G_VEC-element copies, so a
// vector is wholly inside or wholly outside the matrix.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void load_chunk(T* dst, const T* __restrict__ src,
                                           int row0, int nrows, int n, int k0,
                                           bool vec) {
  constexpr int PER_ROW = G_BK / G_VEC;
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * PER_ROW; e += NT) {
      const int rr = e / PER_ROW, kv = (e % PER_ROW) * G_VEC;
      const int gr = row0 + rr, gk = k0 + kv;
      const bool in = gr < nrows && gk < n;
      cp_async_zfill<G_VEC * sizeof(T)>(
          dst + rr * G_LD + kv, in ? src + (size_t)gr * n + gk : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * G_BK; e += NT) {
      const int rr = e / G_BK, kk = e % G_BK;
      const int gr = row0 + rr, gk = k0 + kk;
      dst[rr * G_LD + kk] = (gr < nrows && gk < n)
                                ? src[(size_t)gr * n + gk]
                                : from_f32<T>(0.0f);
    }
  }
}

// ---- the tiled partial kernel -----------------------------------------------

// Block (x, y, z) = (column tile, row tile, split): chunks split * per ..
// of the feature axis for output rows blockIdx.y * TBM .. and columns
// blockIdx.x * TBR ..  Thread (tx, ty) owns rows ty * 8 + i and columns tx
// + (TBR / 4) j.  One split: out = epilogue(dots); more: the dots go to
// ws[split] (m, r), the row norms (column tile 0) to ws[splits m r + split
// m ..] and the column norms (row tile 0) to ws[splits (m r + m) + split r
// ..].
template <typename T, typename O, int TBM, int TBR>
__global__ void __launch_bounds__((TBM / G_TM) * (TBR / G_TN))
    gram_partial_kernel(const T* __restrict__ A, const T* __restrict__ B,
                        O* __restrict__ out, float* __restrict__ ws, int m,
                        int r, int n, int per, int vec, KernelParams p) {
  constexpr int TX = TBR / G_TN, TY = TBM / G_TM, NT = TX * TY;
  constexpr int NU = (TBM + TBR + NT - 1) / NT;   // norm rows a thread
  constexpr int STAGES = GramStages<T, TBM, TBR>::value;
  __shared__ __align__(16) T As[STAGES][TBM * G_LD];
  __shared__ __align__(16) T Bs[STAGES][TBR * G_LD];
  __shared__ float rs_s[TBM], cs_s[TBR];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * TBM, col0 = blockIdx.x * TBR;
  const int split = blockIdx.z, splits = gridDim.z;
  const int c_begin = split * per;
  const int c_end = min((n + G_BK - 1) / G_BK, c_begin + per);
  const bool rbf = p.kind == KERNEL_RBF;

  float acc[G_TM][G_TN], nrm[NU];
#pragma unroll
  for (int i = 0; i < G_TM; ++i)
#pragma unroll
    for (int j = 0; j < G_TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int u = 0; u < NU; ++u) nrm[u] = 0.0f;

  // chunk c_begin + i goes to stage i % STAGES, one copy group a chunk
  // (empty groups past the end keep the count uniform)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (c_begin + i < c_end) {
      load_chunk<T, TBM, NT>(As[i], A, row0, m, n, (c_begin + i) * G_BK, vec);
      load_chunk<T, TBR, NT>(Bs[i], B, col0, r, n, (c_begin + i) * G_BK, vec);
    }
    cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();              // everyone's; and chunk c - 1 is summed
    const int ahead = c + STAGES - 1;
    if (ahead < c_end) {          // into chunk c - 1's stage
      const int sa = (ahead - c_begin) % STAGES;
      load_chunk<T, TBM, NT>(As[sa], A, row0, m, n, ahead * G_BK, vec);
      load_chunk<T, TBR, NT>(Bs[sa], B, col0, r, n, ahead * G_BK, vec);
    }
    cp_async_commit();
    const T* as = As[(c - c_begin) % STAGES];
    const T* bs = Bs[(c - c_begin) % STAGES];
    if (rbf) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int q = tid + NT * u;
        if (q < TBM + TBR) {
          const T* row = q < TBM ? as + q * G_LD : bs + (q - TBM) * G_LD;
#pragma unroll
          for (int kv = 0; kv < G_BK; kv += G_VEC) {
            const float4 x = ld4(row + kv);
            nrm[u] = dot4(x, x, nrm[u]);
          }
        }
      }
    }
#pragma unroll
    for (int kv = 0; kv < G_BK; kv += G_VEC) {
      float4 a[G_TM], b[G_TN];
#pragma unroll
      for (int i = 0; i < G_TM; ++i) a[i] = ld4(as + (ty * G_TM + i) * G_LD + kv);
#pragma unroll
      for (int j = 0; j < G_TN; ++j) b[j] = ld4(bs + (tx + TX * j) * G_LD + kv);
#pragma unroll
      for (int i = 0; i < G_TM; ++i)
#pragma unroll
        for (int j = 0; j < G_TN; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
    }
  }

  if (splits == 1) {
    if (rbf) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int q = tid + NT * u;
        if (q < TBM)
          rs_s[q] = nrm[u];
        else if (q < TBM + TBR)
          cs_s[q - TBM] = nrm[u];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < G_TM; ++i) {
      const int row = row0 + ty * G_TM + i;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < G_TN; ++j) {
        const int col = col0 + tx + TX * j;
        if (col >= r) continue;
        out[(size_t)row * r + col] = from_f32<O>(epilogue(
            acc[i][j], rbf ? rs_s[ty * G_TM + i] : 0.0f,
            rbf ? cs_s[tx + TX * j] : 0.0f, p));
      }
    }
    return;
  }
  float* wd = ws + (size_t)split * m * r;
#pragma unroll
  for (int i = 0; i < G_TM; ++i) {
    const int row = row0 + ty * G_TM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < G_TN; ++j) {
      const int col = col0 + tx + TX * j;
      if (col < r) wd[(size_t)row * r + col] = acc[i][j];
    }
  }
  if (rbf) {
    float* wr = ws + (size_t)splits * m * r + (size_t)split * m;
    float* wc = ws + (size_t)splits * ((size_t)m * r + m) + (size_t)split * r;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int q = tid + NT * u;
      if (q < TBM) {
        if (blockIdx.x == 0 && row0 + q < m) wr[row0 + q] = nrm[u];
      } else if (q < TBM + TBR) {
        if (blockIdx.y == 0 && col0 + q - TBM < r) wc[col0 + q - TBM] = nrm[u];
      }
    }
  }
}

// ---- m, r <= 4: one warp a split, a lane a feature --------------------------

template <typename T, typename O>
__global__ void __launch_bounds__(32)
    gram_dot_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    O* __restrict__ out, float* __restrict__ ws, int m,
                    int r, int n, int per, KernelParams p) {
  const int lane = threadIdx.x, split = blockIdx.z, splits = gridDim.z;
  const int k_end = min(n, (split + 1) * per * G_BK);
  float acc[G_DOT_MAX][G_DOT_MAX], ra[G_DOT_MAX], rb[G_DOT_MAX];
#pragma unroll
  for (int i = 0; i < G_DOT_MAX; ++i) {
    ra[i] = rb[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < G_DOT_MAX; ++j) acc[i][j] = 0.0f;
  }
  for (int k = split * per * G_BK + lane; k < k_end; k += 32) {
    float a[G_DOT_MAX], b[G_DOT_MAX];
#pragma unroll
    for (int i = 0; i < G_DOT_MAX; ++i) {
      a[i] = i < m ? to_f32(A[(size_t)i * n + k]) : 0.0f;
      b[i] = i < r ? to_f32(B[(size_t)i * n + k]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < G_DOT_MAX; ++i) {
      ra[i] = fmaf(a[i], a[i], ra[i]);
      rb[i] = fmaf(b[i], b[i], rb[i]);
#pragma unroll
      for (int j = 0; j < G_DOT_MAX; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < G_DOT_MAX; ++i) {
    ra[i] = warp_sum(ra[i]);
    rb[i] = warp_sum(rb[i]);
#pragma unroll
    for (int j = 0; j < G_DOT_MAX; ++j) acc[i][j] = warp_sum(acc[i][j]);
  }
  if (lane != 0) return;
  const bool rbf = p.kind == KERNEL_RBF;
  float* wd = ws + (size_t)split * m * r;
  float* wr = ws + (size_t)splits * m * r + (size_t)split * m;
  float* wc = ws + (size_t)splits * ((size_t)m * r + m) + (size_t)split * r;
#pragma unroll
  for (int i = 0; i < G_DOT_MAX; ++i) {
    if (i >= m) continue;
    if (splits > 1 && rbf) wr[i] = ra[i];
#pragma unroll
    for (int j = 0; j < G_DOT_MAX; ++j) {
      if (j >= r) continue;
      if (splits == 1)
        out[i * r + j] = from_f32<O>(epilogue(acc[i][j], ra[i], rb[j], p));
      else
        wd[i * r + j] = acc[i][j];
    }
  }
  if (splits > 1 && rbf)
#pragma unroll
    for (int j = 0; j < G_DOT_MAX; ++j)
      if (j < r) wc[j] = rb[j];
}

// ---- the reduce ------------------------------------------------------------

// sum_sp w[sp * stride], in split order, with 32 loads in flight (at 1 x 1
// and 32 x 32 the splits number 256, and the latency of the loads, not the
// adds, is the time).
__device__ __forceinline__ float split_sum(const float* __restrict__ w,
                                           size_t stride, int splits) {
  float s = 0.0f;
#pragma unroll 32
  for (int sp = 0; sp < splits; ++sp) s += w[sp * stride];
  return s;
}

// out[row, col] = epilogue(sum of the splits' dots, norms), each sum in
// split order.  Block: 32 columns x 8 rows of outputs, a thread
// each, and two more warps that sum the block's column and row norms into
// shared memory at the same time.
template <typename O>
__global__ void __launch_bounds__(G_RED_X*(G_RED_Y + 2))
    gram_reduce_kernel(const float* __restrict__ ws, O* __restrict__ out,
                       int m, int r, int splits, KernelParams p) {
  __shared__ float rs_s[G_RED_Y], cs_s[G_RED_X];
  const int tx = threadIdx.x % G_RED_X, ty = threadIdx.x / G_RED_X;
  const int col = blockIdx.x * G_RED_X + tx, row = blockIdx.y * G_RED_Y + ty;
  const size_t mr = (size_t)m * r;
  const bool rbf = p.kind == KERNEL_RBF;
  float dot = 0.0f;
  if (ty < G_RED_Y) {
    if (row < m && col < r) dot = split_sum(ws + (size_t)row * r + col, mr, splits);
  } else if (rbf) {
    const float* wr = ws + (size_t)splits * mr;
    const float* wc = wr + (size_t)splits * m;
    const int row_n = blockIdx.y * G_RED_Y + tx;
    if (ty == G_RED_Y && col < r)
      cs_s[tx] = split_sum(wc + col, r, splits);
    else if (ty == G_RED_Y + 1 && tx < G_RED_Y && row_n < m)
      rs_s[tx] = split_sum(wr + row_n, m, splits);
  }
  if (rbf) __syncthreads();
  if (ty >= G_RED_Y || row >= m || col >= r) return;
  out[(size_t)row * r + col] = from_f32<O>(
      epilogue(dot, rbf ? rs_s[ty] : 0.0f, rbf ? cs_s[tx] : 0.0f, p));
}

template <typename T, typename O>
int launch_gram(const void* A_, const void* B_, void* out_, float* ws, int m,
                int r, int n, int bm, int br, int splits, int per,
                const KernelParams& p, cudaStream_t st) {
  const T* A = static_cast<const T*>(A_);
  const T* B = static_cast<const T*>(B_);
  O* out = static_cast<O*>(out_);
  const size_t align = G_VEC * sizeof(T);
  const int vec = n % G_VEC == 0 &&
                  reinterpret_cast<uintptr_t>(A) % align == 0 &&
                  reinterpret_cast<uintptr_t>(B) % align == 0;
  const dim3 grid((r + br - 1) / br, (m + bm - 1) / bm, splits);
  if (bm == G_DOT_MAX && br == G_DOT_MAX)
    gram_dot_kernel<T, O><<<dim3(1, 1, splits), 32, 0, st>>>(A, B, out, ws, m,
                                                            r, n, per, p);
  else if (bm == 32 && br == 32)
    gram_partial_kernel<T, O, 32, 32><<<grid, 32, 0, st>>>(A, B, out, ws, m,
                                                           r, n, per, vec, p);
  else if (bm == 32 && br == 64)
    gram_partial_kernel<T, O, 32, 64><<<grid, 64, 0, st>>>(A, B, out, ws, m,
                                                           r, n, per, vec, p);
  else if (bm == 64 && br == 32)
    gram_partial_kernel<T, O, 64, 32><<<grid, 64, 0, st>>>(A, B, out, ws, m,
                                                           r, n, per, vec, p);
  else if (bm == 64 && br == 64)
    gram_partial_kernel<T, O, 64, 64><<<grid, 128, 0, st>>>(A, B, out, ws, m,
                                                            r, n, per, vec, p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const dim3 rgrid((r + G_RED_X - 1) / G_RED_X, (m + G_RED_Y - 1) / G_RED_Y);
  gram_reduce_kernel<O><<<rgrid, G_RED_X * (G_RED_Y + 2), 0, st>>>(
      ws, out, m, r, splits, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gram_out(const void* A, const void* B, void* out, float* ws, int m,
                    int r, int n, int out_dtype, int bm, int br, int splits,
                    int per, const KernelParams& p, cudaStream_t st) {
  if (out_dtype == DTYPE_BF16)
    return launch_gram<T, __nv_bfloat16>(A, B, out, ws, m, r, n, bm, br,
                                         splits, per, p, st);
  return launch_gram<T, float>(A, B, out, ws, m, r, n, bm, br, splits, per,
                               p, st);
}

}  // namespace rt

// A (m, n), B (r, n): row-major, in_dtype f32 (0) or bf16 (1) for both.
// out (m, r) row-major in out_dtype.  (bm, br) is the output tile ((4, 4):
// the dot kernel, m, r <= 4), `splits` the number of feature splits of
// `per` 32-feature chunks each (kernels/gram.gram_splits); with splits > 1,
// ws holds splits * (m r + m + r) f32 for the reduce.  Returns
// cudaGetLastError() of the launches.
extern "C" int gram_launch(const void* A, const void* B, void* out, void* ws,
                           int m, int r, int n, int in_dtype, int out_dtype,
                           int kind, int degree, float coef0, float sigma,
                           int bm, int br, int splits, int per,
                           void* stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (in_dtype == DTYPE_BF16)
    return launch_gram_out<__nv_bfloat16>(A, B, out, w, m, r, n, out_dtype,
                                          bm, br, splits, per, p, st);
  return launch_gram_out<float>(A, B, out, w, m, r, n, out_dtype, bm, br,
                                splits, per, p, st);
}

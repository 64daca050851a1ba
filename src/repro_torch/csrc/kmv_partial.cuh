// The KMV contraction shared by the resident KMV (kmv.cu) and the streamed
// pipe (kmv_stream.cu), one design per width r of the output (the plan,
// kernels/kmv.kmv_plan, picks it from m, r, c and the SM count):
//
//   rows    r <= 8 (r = 1 is the classical DCD round): the work is 2 m r n
//           FLOP on m n words of A, a few FLOP a byte, so the kernel must
//           read A once at HBM speed.  Each warp owns a group of 1, 2 or 4
//           rows of A (more rows as r grows, so each load of B feeds more
//           products) and reads them in 16-byte vectors (8 bytes for bf16)
//           with an evict-first hint; B's r rows come through L1, where
//           they stay (32 KB a row at n = 8192 f32).  The r dots and the
//           rbf norm accumulate in registers and finish in a fixed-order
//           warp butterfly; the epilogue and the product with X[i, :]
//           follow at once, into the warp's (r x c) partial in shared
//           memory, and the block sums its warps' partials in warp order.
//   narrow  8 < r <= 64 (r = 32 is the K-SVM s-step round): a 32-row tile
//           as wide as r rounds up to (32 or 64 columns), so no column is
//           masked at r = 32; 8 x 4 (8 x 8 at 64 columns) outputs a thread.
//           Four warps share a tile, each summing a quarter of every
//           feature chunk, and add their tiles in a fixed order at the end:
//           a tile is a small enough unit (625 at m = 19 996) that the SMs,
//           and the four schedulers of each, get the same work.  The
//           128-feature chunks of A and B come through a 2-stage ring of
//           16-byte cp.async copies (8 bytes for bf16).  At 16 FLOP a byte
//           of A this sits just under the card's FP32 ridge, so both the
//           copies and the FMAs must stay busy.
//   wide    r > 64 (K-RR's 256, a prediction block's 1024): an SGEMM-class
//           128 x 128 tile (128 x 64 where 128-wide tiles would leave the
//           card's last wave mostly empty), 8 x 8 outputs a thread, 64-
//           (32-) feature chunks in a 2-stage cp.async ring.
//   symmetric  B = A (the full matvec K(A, A)^T X of every convergence
//           check): K(A, A) is symmetric, so only the wide tiles on and
//           above the diagonal are computed, and an off-diagonal tile
//           (I, J) also stands for its mirror (J, I) = K_IJ^T, whose
//           product with X's rows of tile J goes where tile (J, I)'s
//           would: half the FMAs, and every slot of the workspace still
//           written once.
//   pairs   the streamed full matvec (kmv_stream.cu's symmetric pipe): A
//           arrives a chunk at a time, so the symmetric plan runs on
//           chunk pairs a <= b, two different row sets; a wide tile of
//           pair (a, b) serves its mirror too, into slots of a workspace
//           that launches add to in the pipe's fixed order.
//
// The tiles keep their chunks row-major in shared memory with a row stride
// of BK + 4 elements, so the float4 reads along the feature axis of a
// warp's 4-16 consecutive rows fall in distinct banks; each thread reads 8
// rows and 4-8 columns a step and does 4 FMAs a pair: 10-16 FMAs a
// shared-memory read.  The rbf norms of the tile's A rows are summed from
// the same chunks, B's once a call by kmv_bnorm_kernel.  The epilogue runs
// in registers; the product with X sums each thread's 8 rows in registers,
// then the tile's thread rows in shared memory in a fixed order, into the
// block's (BR x c) slice of an f32 workspace (splits, r, c).  A block of
// the tile grid (r tiles) x (m splits) loops over the tiles of its split.
//
// kmv_reduce_kernel sums the workspace over the splits in a fixed order:
// no atomics anywhere, so a second call gives the same bits.  Rows at or
// past m are masked and contribute exactly zero (K(0, b) != 0 for rbf and
// polynomial).  With `accumulate` a block adds to what an earlier launch on
// the same stream left in its slice (the streamed pipe's sum over chunks).
// FP32 FMAs throughout, for bf16 inputs too (widened as they are read):
// TF32 cannot meet the 2e-4 KMV bound or the solvers' 1e-5 iterate bound.
#pragma once

#include "kernel_tile.cuh"

namespace rt {

// plan regimes, as kernels/kmv.REGIME_CODES numbers them
constexpr int KMV_ROWS = 0;
constexpr int KMV_NARROW = 1;
constexpr int KMV_WIDE = 2;
constexpr int KMV_SYMMETRIC = 3;           // wide, B = A: half the tiles

constexpr int KMV_VEC = 4;                 // elements a vector load
constexpr int KMV_ROWS_MAX_RC = 1024;      // r * c of the warps' partials
constexpr int KMV_ROW_WARPS = 8;
constexpr int KMV_ROW_THREADS = 32 * KMV_ROW_WARPS;
constexpr int KMV_NORM_THREADS = 256;
constexpr int KMV_RED_THREADS = 256;

// rows of A a warp takes at a time in the rows regime
__host__ __device__ constexpr int kmv_row_group(int r) {
  return r <= 2 ? 1 : (r <= 4 ? 2 : 4);
}

// four elements from device memory: A's, read once (evict-first), and B's,
// kept in L1 for the next row
__device__ __forceinline__ float4 ld4_once(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4_once(const __nv_bfloat16* p) {
  return bf16x4_to_f32(__ldcs(reinterpret_cast<const uint2*>(p)));
}
__device__ __forceinline__ float4 ld4_kept(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4_kept(const __nv_bfloat16* p) {
  return bf16x4_to_f32(__ldg(reinterpret_cast<const uint2*>(p)));
}

// element q (a constant after unrolling) of a float4
__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// ---- |b_j|^2, once a call (rbf) ---------------------------------------------

// bn[j] = |b_j|^2, a block a row: each thread sums its strided features in
// order, then the warps' butterflies and the 8 warp sums in order.
template <typename T, bool VEC>
__global__ void __launch_bounds__(KMV_NORM_THREADS)
    kmv_bnorm_kernel(const T* __restrict__ B, float* __restrict__ bn, int n) {
  __shared__ float part[KMV_NORM_THREADS / 32];
  const T* b = B + (size_t)blockIdx.x * n;
  float s = 0.0f;
  if (VEC) {
    for (int k = threadIdx.x * KMV_VEC; k < n;
         k += KMV_NORM_THREADS * KMV_VEC) {
      const float4 x = ld4_kept(b + k);
      s = dot4(x, x, s);
    }
  } else {
    for (int k = threadIdx.x; k < n; k += KMV_NORM_THREADS) {
      const float x = to_f32(b[k]);
      s = fmaf(x, x, s);
    }
  }
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < KMV_NORM_THREADS / 32; ++w) t += part[w];
    bn[blockIdx.x] = t;
  }
}

// ---- rows: r <= 8 -----------------------------------------------------------

// dot[w][j] = a_w . b_j and an[w] = |a_w|^2 over the whole feature axis for
// the warp's RW rows (row pointers a[w]); every lane ends with the same
// bits.  VEC: n % 4 == 0 and A, B aligned for 4-element loads.
template <typename T, int R, int RW, bool VEC>
__device__ __forceinline__ void row_group_dots(const T* (&a)[RW],
                                               const T* __restrict__ B, int n,
                                               float (&dot)[RW][R],
                                               float (&an)[RW]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    an[w] = 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) dot[w][j] = 0.0f;
  }
  if (VEC) {
#pragma unroll 4
    for (int k = lane * KMV_VEC; k < n; k += 32 * KMV_VEC) {
      float4 x[RW];
#pragma unroll
      for (int w = 0; w < RW; ++w) x[w] = ld4_once(a[w] + k);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float4 b = ld4_kept(B + (size_t)j * n + k);
#pragma unroll
        for (int w = 0; w < RW; ++w) dot[w][j] = dot4(x[w], b, dot[w][j]);
      }
#pragma unroll
      for (int w = 0; w < RW; ++w) an[w] = dot4(x[w], x[w], an[w]);
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      float x[RW];
#pragma unroll
      for (int w = 0; w < RW; ++w) x[w] = to_f32(a[w][k]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float b = to_f32(B[(size_t)j * n + k]);
#pragma unroll
        for (int w = 0; w < RW; ++w) dot[w][j] = fmaf(x[w], b, dot[w][j]);
      }
#pragma unroll
      for (int w = 0; w < RW; ++w) an[w] = fmaf(x[w], x[w], an[w]);
    }
  }
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    an[w] = warp_sum(an[w]);
#pragma unroll
    for (int j = 0; j < R; ++j) dot[w][j] = warp_sum(dot[w][j]);
  }
}

// Block s (1-D grid) takes rows [s * rows_per_split, ...); warp w its row
// groups w, w + KMV_ROW_WARPS, ...; bn: |b_j|^2 (rbf only); dynamic shared
// memory KMV_ROW_WARPS * R * c floats.
template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(KMV_ROW_THREADS)
    kmv_rows_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    const float* __restrict__ bn, const float* __restrict__ X,
                    float* __restrict__ ws, int m, int n, int c,
                    int rows_per_split, int accumulate, KernelParams p) {
  constexpr int RW = kmv_row_group(R);
  extern __shared__ float wacc[];          // [warp][j * c + cc]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rc = R * c;
  const int m_begin = blockIdx.x * rows_per_split;
  const int m_end = min(m, m_begin + rows_per_split);
  float bnr[R];
#pragma unroll
  for (int j = 0; j < R; ++j) bnr[j] = p.kind == KERNEL_RBF ? bn[j] : 0.0f;
  // lane cc % 32 owns entries (j, cc) of its warp's partial
  float* mine = wacc + warp * rc;
  for (int q = lane; q < rc; q += 32) mine[q] = 0.0f;
  __syncwarp();
  for (int g = m_begin + warp * RW; g < m_end; g += KMV_ROW_WARPS * RW) {
    const T* a[RW];
#pragma unroll
    for (int w = 0; w < RW; ++w) a[w] = A + (size_t)min(g + w, m_end - 1) * n;
    float dot[RW][R], an[RW];
    row_group_dots<T, R, RW, VEC>(a, B, n, dot, an);
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const int row = g + w;
      if (row >= m_end) break;
      const float* xr = X + (size_t)row * c;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float kv = epilogue(dot[w][j], an[w], bnr[j], p);
        for (int cc = lane; cc < c; cc += 32)
          mine[j * c + cc] = fmaf(kv, xr[cc], mine[j * c + cc]);
      }
    }
  }
  __syncthreads();
  float* wsb = ws + (size_t)blockIdx.x * rc;
  for (int q = threadIdx.x; q < rc; q += KMV_ROW_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < KMV_ROW_WARPS; ++w) s += wacc[w * rc + q];
    wsb[q] = accumulate ? wsb[q] + s : s;
  }
}

// ---- tiles: narrow (8 < r <= 64) and wide (r > 64) ---------------------------

// A BM x BR output tile, TM x TN outputs a thread, KG groups of threads
// that each sum BK / KG features of every BK-feature chunk (the groups'
// tiles are added at the end), a ring of STAGES chunks.  A step of four
// features runs as dot products (each output's four FMAs in a row) or,
// with OUTER, as four outer products (each a value's TN FMAs in a row):
// the same FMAs in the same order for every output, so the same bits;
// which schedules faster depends on the tile.
template <typename T, int BM_, int BR_, int TM_, int TN_, int BK_, int STAGES_,
          int KG_, int MINB_, bool OUTER_>
struct KmvTile {
  static constexpr int BM = BM_, BR = BR_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int STAGES = STAGES_, KG = KG_;
  static constexpr int MINB = MINB_;       // blocks an SM must hold
  static constexpr bool OUTER = OUTER_;    // the order of a step's FMAs
  static constexpr int TX = BR / TN, TY = BM / TM, NTG = TX * TY;
  static constexpr int NT = NTG * KG;
  static constexpr int KS = BK / KG;       // features a group takes a chunk
  static constexpr int LD = BK + 4;        // row stride of a chunk, elements
  static constexpr int NU = (BM + NTG - 1) / NTG;   // A-norm rows a thread
  static constexpr size_t RING =
      (size_t)STAGES * (BM + BR) * LD * sizeof(T);
  // the groups' tiles, added at the end, take the drained ring's place
  static constexpr size_t KRED = (size_t)(KG - 1) * NTG * TM * TN * 4;
  static constexpr size_t FRONT = RING > KRED ? RING : KRED;
  static_assert(KS % KMV_VEC == 0 && BR <= NT, "tile shape");
  // the mirrored product (B = A) of a square tile of one thread group
  static constexpr bool SYM = BM == BR && KG == 1 && BM <= NT;
  // the ring, then nred[KG][BM] and red[TY][BR] in f32
  static constexpr size_t SMEM =
      FRONT + (size_t)(KG * BM + TY * BR) * sizeof(float);
};

// Chunk k0 .. k0 + BK of rows row0 .. row0 + ROWS of a row-major (nrows, n)
// matrix into dst[row * LD + k]; rows past nrows and features past n are 0.
// vec: n % KMV_VEC == 0 and the base aligned for KMV_VEC-element copies, so
// a vector is wholly inside or wholly outside the matrix.
template <typename T, int ROWS, int BK, int LD, int NT>
__device__ __forceinline__ void kmv_load_chunk(T* dst,
                                               const T* __restrict__ src,
                                               int row0, int nrows, int n,
                                               int k0, bool vec) {
  constexpr int PER_ROW = BK / KMV_VEC;
  constexpr int COPIES = ROWS * PER_ROW;
  if (vec) {
#pragma unroll
    for (int it = 0; it < (COPIES + NT - 1) / NT; ++it) {
      const int e = threadIdx.x + it * NT;
      if (COPIES % NT != 0 && e >= COPIES) break;
      const int rr = e / PER_ROW, kv = (e % PER_ROW) * KMV_VEC;
      const int gr = row0 + rr, gk = k0 + kv;
      const bool in = gr < nrows && gk < n;
      cp_async_zfill<KMV_VEC * sizeof(T)>(
          dst + rr * LD + kv, in ? src + (size_t)gr * n + gk : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BK; e += NT) {
      const int rr = e / BK, kk = e % BK;
      const int gr = row0 + rr, gk = k0 + kk;
      dst[rr * LD + kk] = (gr < nrows && gk < n) ? src[(size_t)gr * n + gk]
                                                 : from_f32<T>(0.0f);
    }
  }
}

// Where a block of the resident plan puts its shares: its columns' slice
// of split y; for B = A (sym, a tile a split) also the mirror's, into
// split x's slice of the tile's rows.
struct KmvSlices {
  static constexpr bool PAIR = false;
  float* ws;
  int r, c, sym;
  __device__ __forceinline__ float* main(int col0) const {
    return ws + (size_t)blockIdx.y * r * c + (size_t)col0 * c;
  }
  __device__ __forceinline__ bool mirrored() const {
    return sym && blockIdx.x != blockIdx.y;
  }
  __device__ __forceinline__ float* mirror(int i0) const {
    return ws + (size_t)blockIdx.x * r * c + (size_t)i0 * c;
  }
};

// A block's work: rows [m_begin, m_end) of A in BM-row tiles against the
// BR columns of B from col0 (those at or past r masked).  Thread tid is
// thread t = tid % NTG of group kg = tid / NTG; (tx, ty) = (t % TX, t /
// TX) owns tile rows ty + TY i and columns tx + TX j.  The tiles' product
// with X (A's rows) goes to o.main(col0), the block's (BR x c) slice of
// the workspace.  Where o.mirrored() (one tile a block), the tile also
// stands for its mirror K^T, whose product with XB (B's rows) goes to
// o.mirror(i0), a (BM x c) slice for A's rows, added to it for pairs.
// For pairs (O::PAIR) a null X or XB stands for zeros.  accumulate: add
// to what the main slice holds.  bn: |b_j|^2 (rbf only).  Dynamic shared
// memory G::SMEM bytes.
template <typename T, typename G, typename O>
__device__ __forceinline__ void kmv_tile_run(
    const T* __restrict__ A, const T* __restrict__ B,
    const float* __restrict__ bn, const float* __restrict__ X,
    const float* __restrict__ XB, int m_begin, int m_end, int col0, int r,
    int n, int c, int accumulate, int vec, const O& o,
    const KernelParams& p) {
  constexpr int BM = G::BM, BR = G::BR, TM = G::TM, TN = G::TN, KG = G::KG;
  constexpr int BK = G::BK, KS = G::KS, LD = G::LD, TX = G::TX, TY = G::TY;
  constexpr int NTG = G::NTG, NT = G::NT, STAGES = G::STAGES, NU = G::NU;
  constexpr int STAGE = (BM + BR) * LD;    // elements a stage: A rows, B rows
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* kred = reinterpret_cast<float*>(smem);     // aliases the ring
  float* nred = reinterpret_cast<float*>(smem + G::FRONT);
  float* red = nred + KG * BM;

  const int tid = threadIdx.x, kg = tid / NTG, t = tid % NTG;
  const int tx = t % TX, ty = t / TX;
  const int k_lo = kg * KS;                // this group's part of a chunk
  const int ncols = min(BR, r - col0);
  const int chunks = (n + BK - 1) / BK;
  const bool rbf = p.kind == KERNEL_RBF;
  // thread q < ncols owns entries (col0 + q, :) of the block's slice
  float* wsb = o.main(col0);
  bool fresh = !accumulate;

  for (int i0 = m_begin; i0 < m_end; i0 += BM) {
    float acc[TM][TN], nrm[NU];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int u = 0; u < NU; ++u) nrm[u] = 0.0f;

    // chunk ch goes to stage ch % STAGES, one copy group a chunk (empty
    // groups past the end keep the count uniform)
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < chunks) {
        kmv_load_chunk<T, BM, BK, LD, NT>(ring + s * STAGE, A, i0, m_end, n,
                                          s * BK, vec);
        kmv_load_chunk<T, BR, BK, LD, NT>(ring + s * STAGE + BM * LD, B,
                                          col0, r, n, s * BK, vec);
      }
      cp_async_commit();
    }
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait<STAGES - 2>();  // chunk ch has landed (this thread's part)
      __syncthreads();              // everyone's; and chunk ch - 1 is summed
      const int ahead = ch + STAGES - 1;
      if (ahead < chunks) {         // into chunk ch - 1's stage
        T* st = ring + (ahead % STAGES) * STAGE;
        kmv_load_chunk<T, BM, BK, LD, NT>(st, A, i0, m_end, n, ahead * BK,
                                          vec);
        kmv_load_chunk<T, BR, BK, LD, NT>(st + BM * LD, B, col0, r, n,
                                          ahead * BK, vec);
      }
      cp_async_commit();
      const T* as = ring + (ch % STAGES) * STAGE;
      const T* bs = as + BM * LD;
      if (rbf) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int q = t + NTG * u;
          if (NU * NTG == BM || q < BM) {
#pragma unroll
            for (int kv = 0; kv < KS; kv += KMV_VEC) {
              const float4 x = ld4(as + q * LD + k_lo + kv);
              nrm[u] = dot4(x, x, nrm[u]);
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; kk += KMV_VEC) {
        const int kv = k_lo + kk;
        float4 b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ld4(bs + (tx + TX * j) * LD + kv);
        if constexpr (G::OUTER) {
          float4 a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[i] = ld4(as + (ty + TY * i) * LD + kv);
#pragma unroll
          for (int q = 0; q < KMV_VEC; ++q)
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float av = component(a[i], q);
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fmaf(av, component(b[j], q), acc[i][j]);
            }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float4 a = ld4(as + (ty + TY * i) * LD + kv);
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = dot4(a, b[j], acc[i][j]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                // the ring is drained and free
    if (rbf) {
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int q = t + NTG * u;
        if (NU * NTG == BM || q < BM) nred[kg * BM + q] = nrm[u];
      }
    }
    if (KG > 1 && kg > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kred[((kg - 1) * TM * TN + i * TN + j) * NTG + t] = acc[i][j];
    }
    __syncthreads();
    if (kg == 0) {
      // the groups' tiles in group order, then the kernel tile in
      // registers; rows at or past m_end are 0
#pragma unroll
      for (int g = 1; g < KG; ++g)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += kred[((g - 1) * TM * TN + i * TN + j) * NTG + t];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = ty + TY * i;
        float rs = 0.0f;
        if (rbf)
#pragma unroll
          for (int g = 0; g < KG; ++g) rs += nred[g * BM + row];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = col0 + tx + TX * j;
          acc[i][j] = i0 + row < m_end
                          ? epilogue(acc[i][j], rs,
                                     rbf && col < r ? bn[col] : 0.0f, p)
                          : 0.0f;
        }
      }
    }
    // the tile's product with X, a column of X at a time: a thread's TM
    // rows in registers, then the TY thread rows in order
    for (int cc = 0; cc < c; ++cc) {
      if (kg == 0) {
        float xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = i0 + ty + TY * i;
          xv[i] = (!O::PAIR || X != nullptr) && row < m_end
                      ? X[(size_t)row * c + cc]
                      : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < TM; ++i) s = fmaf(acc[i][j], xv[i], s);
          red[ty * BR + tx + TX * j] = s;
        }
      }
      __syncthreads();
      if (tid < ncols) {
        float s = 0.0f;
#pragma unroll
        for (int y = 0; y < TY; ++y) s += red[y * BR + tid];
        float* w = wsb + (size_t)tid * c + cc;
        *w = fresh ? s : *w + s;
      }
      __syncthreads();
    }
    if (o.mirrored()) {
      // the mirror K^T: its product with XB's rows of the tile's columns,
      // a thread's TN columns in registers, then the TX thread columns in
      // order
      float* wsm = o.mirror(i0);
      for (int cc = 0; cc < c; ++cc) {
        float xc[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = col0 + tx + TX * j;
          xc[j] = (!O::PAIR || XB != nullptr) && col < r
                      ? XB[(size_t)col * c + cc]
                      : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < TN; ++j) s = fmaf(acc[i][j], xc[j], s);
          red[tx * BM + ty + TY * i] = s;
        }
        __syncthreads();
        if (tid < min(BM, m_end - i0)) {
          float s = 0.0f;
#pragma unroll
          for (int x = 0; x < TX; ++x) s += red[x * BM + tid];
          float* w = wsm + (size_t)tid * c + cc;
          *w = O::PAIR ? *w + s : s;
        }
        __syncthreads();
      }
    }
    fresh = false;
  }
  if (fresh && tid < ncols)         // no rows in this split: a zero slice
    for (int cc = 0; cc < c; ++cc) wsb[(size_t)tid * c + cc] = 0.0f;
}

// Block (x, y) = (column tile, m split): columns x * BR .., rows [y *
// rows_per_split, ...) in BM-row tiles.  sym (B = A, a tile a split): only
// the tiles on and above the diagonal run, an off-diagonal tile (y, x)
// also writing its mirror's product into split x's slice of rows y.
template <typename T, typename G>
__global__ void __launch_bounds__(G::NT, G::MINB)
    kmv_tile_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    const float* __restrict__ bn, const float* __restrict__ X,
                    float* __restrict__ ws, int m, int r, int n, int c,
                    int rows_per_split, int accumulate, int vec, int sym,
                    KernelParams p) {
  if (sym && blockIdx.y > blockIdx.x) return;   // the mirror of a tile
  const int m_begin = blockIdx.y * rows_per_split;
  kmv_tile_run<T, G>(A, B, bn, X, X, m_begin,
                     min(m, m_begin + rows_per_split), blockIdx.x * G::BR,
                     r, n, c, accumulate, vec, KmvSlices{ws, r, c, sym}, p);
}

// ---- pairs of chunks: the symmetric streamed pipe (kmv_stream.cu) ----------

// The full matvec K(A, A)^T X over A in chunks computes each chunk pair
// (a, b), a <= b, once, in 128 x 128 tiles of the wide plan: a's rows are
// the tile rows, b's the columns.  A tile's product with a's rows of X is
// b's rows' share of the output, and its mirror's product with b's rows
// of X is a's rows' share; on the diagonal (a = b) only the tiles on and
// above it run, as in the resident symmetric plan.  Every share goes to
// its own slot of an f32 workspace of 2 x tiles-a-chunk slots, each an
// (m x c) array over A's rows: the product of tile (y, x) to slot y at
// b's rows of tile x, the mirror's to slot x (diagonal) or slot tiles-a-
// chunk + x (a < b) at a's rows of tile y.  No two blocks of a launch
// write one entry; launches on one stream add to the slots in the pipe's
// fixed order, and kmv_reduce sums the slots in a fixed order: no
// atomics, the same bits every call.
constexpr int KMV_PAIR_BM = 128;
template <typename T>
using KmvPairTile = KmvTile<T, KMV_PAIR_BM, KMV_PAIR_BM, 8, 8, 64, 2, 1, 1,
                            false>;

// One chunk pair of a launch.  A = B on the diagonal.
struct KmvPairSeg {
  const void* A;          // chunk a's rows, (rows_a, n)
  const void* B;          // chunk b's rows, (rows_b, n)
  const float* bn;        // |b_j|^2 of b's rows (rbf only)
  const float* xa;        // X's rows of chunk a, (rows_a, c); null: zeros
  const float* xb;        // X's rows of chunk b; null: zeros
  float* wb;              // slot 0 at b's first row: the products' base
  float* wa;              // the mirrors' slot base at a's first row
  int rows_a, rows_b;     // rows before m
  int tiles_a, tiles_b;   // 128-row tiles of them
  int upper;              // a = b: the tiles on and above the diagonal
  int blocks;             // tiles this pair launches
};

// Where tile (y, x) of a pair puts its shares (kmv_pair_kernel).
struct KmvPairSlices {
  static constexpr bool PAIR = true;
  float* wb;
  float* wa;
  long long stride;
  int y, x, c, upper;
  __device__ __forceinline__ float* main(int col0) const {
    return wb + (size_t)y * stride + (size_t)col0 * c;
  }
  __device__ __forceinline__ bool mirrored() const {
    return !(upper && x == y);
  }
  __device__ __forceinline__ float* mirror(int i0) const {
    return wa + (size_t)x * stride + (size_t)i0 * c;
  }
};

// Blocks [0, s0.blocks) take pair s0's tiles, the rest s1's: a diagonal
// and an off-diagonal pair share one launch, so the diagonal's 136 tiles
// of a 2048-row chunk do not end in a wave of their own.  stride: floats
// a slot.
template <typename T, typename G>
__global__ void __launch_bounds__(G::NT, G::MINB)
    kmv_pair_kernel(KmvPairSeg s0, KmvPairSeg s1, long long stride, int n,
                    int c, int vec, KernelParams p) {
  const bool second = (int)blockIdx.x >= s0.blocks;
  const KmvPairSeg s = second ? s1 : s0;
  int k = second ? (int)blockIdx.x - s0.blocks : (int)blockIdx.x;
  int y = 0, x;
  if (s.upper) {                    // row y holds tiles y .. tiles_b - 1
    while (k >= s.tiles_b - y) {
      k -= s.tiles_b - y;
      ++y;
    }
    x = y + k;
  } else {
    y = k / s.tiles_b;
    x = k % s.tiles_b;
  }
  const int m_begin = y * G::BM;
  kmv_tile_run<T, G>(static_cast<const T*>(s.A), static_cast<const T*>(s.B),
                     s.bn, s.xa, s.xb, m_begin,
                     min(s.rows_a, m_begin + G::BM), x * G::BR, s.rows_b, n,
                     c, 1, vec,
                     KmvPairSlices{s.wb, s.wa, stride, y, x, c, s.upper}, p);
}

// One launch of up to two pairs (s1.blocks = 0: one).
template <typename T>
cudaError_t launch_kmv_pair(const KmvPairSeg& s0, const KmvPairSeg& s1,
                            long long stride, int n, int c, int vec,
                            const KernelParams& p, cudaStream_t st) {
  using G = KmvPairTile<T>;
  static_assert(G::SYM, "the pair tile serves its mirror");
  if (G::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kmv_pair_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::SMEM);
    if (err != cudaSuccess) return err;
  }
  rt::launch(kmv_pair_kernel<T, G>, s0.blocks + s1.blocks, G::NT, G::SMEM, st,
      s0, s1, stride, n, c, vec, p);
  return cudaGetLastError();
}

// ---- the reduce -------------------------------------------------------------

// out[e] = the sum over splits of ws[split, e] in a fixed order.  A block
// takes ex consecutive outputs (32, or the least power of two >= rc) and
// KMV_RED_THREADS / ex groups of splits; group g sums splits g, g + groups,
// ... in order, and a fixed pairwise tree adds the groups.
__global__ void __launch_bounds__(KMV_RED_THREADS)
    kmv_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                      int splits, long long rc, int ex) {
  __shared__ float part[KMV_RED_THREADS];
  const int groups = KMV_RED_THREADS / ex;
  const int tx = threadIdx.x % ex, g = threadIdx.x / ex;
  const long long e = (long long)blockIdx.x * ex + tx;
  float s = 0.0f;
  if (e < rc) {
#pragma unroll 4
    for (int sp = g; sp < splits; sp += groups) s += ws[(size_t)sp * rc + e];
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = groups / 2; h > 0; h /= 2) {
    if (g < h) part[threadIdx.x] += part[threadIdx.x + h * ex];
    __syncthreads();
  }
  if (g == 0 && e < rc) out[e] = part[tx];
}

// ---- launches ---------------------------------------------------------------

template <typename T>
bool vec_ok(const T* A, const T* B, int n) {
  const size_t align = KMV_VEC * sizeof(T);
  return n % KMV_VEC == 0 && reinterpret_cast<uintptr_t>(A) % align == 0 &&
         reinterpret_cast<uintptr_t>(B) % align == 0;
}

// bn[j] = |b_j|^2 for the r rows of B (only rbf reads them).
template <typename T>
cudaError_t kmv_bnorms(const void* B_, float* bn, int r, int n,
                       cudaStream_t st) {
  const T* B = static_cast<const T*>(B_);
  if (vec_ok(B, B, n))
    rt::launch(kmv_bnorm_kernel<T, true>, r, KMV_NORM_THREADS, 0, st, B, bn,
        n);
  else
    rt::launch(kmv_bnorm_kernel<T, false>, r, KMV_NORM_THREADS, 0, st, B, bn,
        n);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_kmv_tile(const T* A, const T* B, const float* bn,
                            const float* X, float* ws, int rows, int r, int n,
                            int c, int splits, int rows_per_split,
                            int accumulate, int vec, int sym,
                            const KernelParams& p, cudaStream_t st) {
  // the mirrored product needs B = A tiled as A is, a tile a split, and
  // a fresh workspace
  if (sym && (!G::SYM || rows != r || rows_per_split != G::BM || accumulate))
    return cudaErrorInvalidValue;
  if (G::SMEM > 48 * 1024) {        // above 48 KB it must be asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kmv_tile_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((r + G::BR - 1) / G::BR, splits);
  rt::launch(kmv_tile_kernel<T, G>, grid, G::NT, G::SMEM, st, A, B, bn, X, ws,
      rows, r, n, c, rows_per_split, accumulate, vec, sym, p);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_kmv_rows(const T* A, const T* B, const float* bn,
                            const float* X, float* ws, int rows, int n, int c,
                            int splits, int rows_per_split, int accumulate,
                            int vec, const KernelParams& p, cudaStream_t st) {
  const size_t smem = (size_t)KMV_ROW_WARPS * R * c * sizeof(float);
  if (vec)
    rt::launch(kmv_rows_kernel<T, R, true>, splits, KMV_ROW_THREADS, smem, st,
        A, B, bn, X, ws, rows, n, c, rows_per_split, accumulate, p);
  else
    rt::launch(kmv_rows_kernel<T, R, false>, splits, KMV_ROW_THREADS, smem, st,
        A, B, bn, X, ws, rows, n, c, rows_per_split, accumulate, p);
  return cudaGetLastError();
}

// One launch of the partial contraction of the plan (regime, bm, br, splits,
// rows_per_split) over `rows` rows of A into ws (splits, r, c); bn holds
// kmv_bnorms' |b_j|^2 when the kernel is rbf.  Returns
// cudaErrorInvalidValue for a plan it has no kernel for.
template <typename T>
cudaError_t kmv_partial(const void* A_, const void* B_, const float* bn,
                        const float* X, float* ws, int rows, int r, int n,
                        int c, int regime, int bm, int br, int splits,
                        int rows_per_split, int accumulate,
                        const KernelParams& p, cudaStream_t st) {
  const T* A = static_cast<const T*>(A_);
  const T* B = static_cast<const T*>(B_);
  const int vec = vec_ok(A, B, n);
  if (regime == KMV_ROWS) {
    if (r * c > KMV_ROWS_MAX_RC || bm != kmv_row_group(r))
      return cudaErrorInvalidValue;
#define RT_ROWS(R_)                                                          \
  case R_:                                                                   \
    return launch_kmv_rows<T, R_>(A, B, bn, X, ws, rows, n, c, splits,       \
                                  rows_per_split, accumulate, vec, p, st);
    switch (r) {
      RT_ROWS(1) RT_ROWS(2) RT_ROWS(3) RT_ROWS(4)
      RT_ROWS(5) RT_ROWS(6) RT_ROWS(7) RT_ROWS(8)
    }
#undef RT_ROWS
    return cudaErrorInvalidValue;
  }
#define RT_TILE(REGIME, BM_, BR_, TM_, TN_, BK_, ST_, KG_, MINB_, OUTER_)     \
  if ((regime == REGIME ||                                                    \
       (regime == KMV_SYMMETRIC && REGIME == KMV_WIDE)) &&                    \
      bm == BM_ && br == BR_)                                                 \
    return launch_kmv_tile<                                                   \
        T, KmvTile<T, BM_, BR_, TM_, TN_, BK_, ST_, KG_, MINB_, OUTER_>>(     \
        A, B, bn, X, ws, rows, r, n, c, splits, rows_per_split, accumulate,   \
        vec, regime == KMV_SYMMETRIC, p, st);
  // feature chunks of 32-128 (fewer barriers a FMA), rings of 2-3 stages;
  // the 128 x 64 tile held to 170 registers, so three blocks share an SM.
  // Each the fastest of the variants timed at r = 32, 256, 1024 and m on
  // an H100 (PERF.md)
  RT_TILE(KMV_NARROW, 32, 32, 8, 4, 128, 2, 4, 1, false)
  RT_TILE(KMV_NARROW, 32, 64, 8, 8, 64, 3, 4, 1, false)
  RT_TILE(KMV_WIDE, 128, 64, 8, 8, 32, 2, 1, 3, true)
  RT_TILE(KMV_WIDE, 128, 128, 8, 8, 64, 2, 1, 1, false)
#undef RT_TILE
  return cudaErrorInvalidValue;
}

inline cudaError_t kmv_reduce(const float* ws, float* out, int splits,
                              long long rc, cudaStream_t st) {
  int ex = 32;
  while (ex > 1 && ex / 2 >= rc) ex /= 2;
  rt::launch(kmv_reduce_kernel, (unsigned)((rc + ex - 1) / ex),
      KMV_RED_THREADS, 0, st, ws, out, splits, rc, ex);
  return cudaGetLastError();
}

}  // namespace rt

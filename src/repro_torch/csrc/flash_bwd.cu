// Flash attention, backward: dq, dk and dv of o = softmax(q k^T * scale
// [causal mask]) v, over (BH, S, hd) q, (BH, T, hd) k, (BH, T, hdv) v and
// (BH, S, hdv) do, f32 or bf16, from the forward's row log-sum-exp lse and
// delta = sum(do * o, -1) (both (BH, S) f32), without writing the (S, T)
// probabilities anywhere.  Two kernels, as on the TPU:
//
//   dq kernel:  dq = sum_k ds k,            one block per (bh, q tile)
//   dkv kernel: dv = p^T do, dk = ds^T q,   one block per (bh, k/v tile)
//
// with p = exp(q k^T * scale - lse) (0 where masked) and
// ds = p * (do v^T - delta) * scale.  Each output has one owner block, so
// there are no atomics: dq, dk and dv repeat bit for bit.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_bwd, bodies
// _dq_kernel (pallas_call at :220) and _dkv_kernel (pallas_call at :240),
// which the LM's training step reaches through FlashAttention.backward
// when attn_impl="flash": 28 launches of each per Qwen3-1.7B backward.
//
// What bounds it on an H100: at the training path's shape (BH = 32, S = T
// = 2048, hd = hdv = 128, bf16, causal) the five products q k^T, do v^T,
// p^T do, ds k and ds^T q are 2 BH hd S^2 / 2 each, 85.9 GFLOP in all,
// against 134 MB of q, k, v, do, dq, dk, dv, lse and delta: operation-
// bound, 87 us at the bf16 tensor-core rate and 1.28 ms at the FP32 rate.
// Two kernels that each recompute q k^T and do v^T do seven products.
//
// Design (simple and exact first, like flash_fwd.cu): FP32 FMAs on the
// CUDA cores for both input types (bf16 widened as it is loaded; no TF32,
// no tensor cores).  256 threads; a thread owns a 4 x 4 block of a 64 x 64
// score tile and a 4 x 8 block of the 64-row output tile (columns
// tx*4.. and 64 + tx*4.., so 128 wide).  Operands of the score products
// sit transposed in shared memory (d-major: one 16-byte load gives four
// rows' values); operands of the accumulating products sit row-major, so
// a tile that plays both roles is loaded twice (the second read comes
// from L2).  dq: q^T, do^T, k^T, v^T|k and ds^T, 153 KB; dkv: k^T, v^T,
// q^T|q, do^T|do, p and ds, 170 KB: one block per SM.  Causal: the dq
// kernel stops at the diagonal tile, the dkv kernel starts at the first
// q tile that reaches its k tile; masked entries get the fill -1e30, as
// in the forward, so exp(s - lse) is 0 there.  Rows and columns past S
// and T load as 0 and are masked; nothing past them is written.
#include "dtype.cuh"

namespace rt {

constexpr int FB_B = 64;               // q rows and k/v rows per tile
constexpr int FB_HD_MAX = 128;         // largest hd and hdv taken
constexpr int FB_THREADS = 256;        // 16 row groups x 16 column groups
constexpr int FB_LD = FB_B + 4;        // row stride of the transposed tiles
constexpr int FB_T_FLOATS = FB_HD_MAX * FB_LD;   // one transposed tile
static_assert(FB_T_FLOATS >= FB_B * FB_HD_MAX, "row-major tile must fit");
constexpr int FB_DQ_SMEM_BYTES =
    (4 * FB_T_FLOATS + FB_B * FB_LD) * (int)sizeof(float);
constexpr int FB_DKV_SMEM_BYTES =
    (4 * FB_T_FLOATS + 2 * FB_B * FB_LD) * (int)sizeof(float);
constexpr float FB_NEG = -1e30f;

// Rows r0.. of a (n, dim) row-major matrix into the transposed tile
// dst[d * FB_LD + r]; rows past n and columns past dim are 0.
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int r0, int n, int dim) {
  for (int e = threadIdx.x; e < FB_B * dim; e += FB_THREADS) {
    const int r = e / dim, d = e % dim;
    dst[d * FB_LD + r] =
        r0 + r < n ? to_f32(src[(size_t)(r0 + r) * dim + d]) : 0.0f;
  }
}

// Rows r0.. of a (n, dim) row-major matrix into dst[r * FB_HD_MAX + d];
// rows past n are 0 (columns past dim are never read into an output).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n, int dim) {
  for (int e = threadIdx.x; e < FB_B * dim; e += FB_THREADS) {
    const int r = e / dim, d = e % dim;
    dst[r * FB_HD_MAX + d] =
        r0 + r < n ? to_f32(src[(size_t)(r0 + r) * dim + d]) : 0.0f;
  }
}

// acc[i][j] += sum_d a[d * FB_LD + ra + i] * b[d * FB_LD + rb + j] over
// d < dim: one 4 x 4 block of a product of two transposed tiles.
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* a,
                                          const float* b, int ra, int rb,
                                          int dim) {
#pragma unroll 4
  for (int d = 0; d < dim; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * FB_LD + ra);
    const float4 y = *reinterpret_cast<const float4*>(b + d * FB_LD + rb);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j w[j * FB_LD + ra + i] * m[j * FB_HD_MAX + col(c)] over
// the FB_B rows j, col(c) = tx*4 + c for c < 4 and 64 + tx*4 + c - 4 after:
// a 4 x 8 block of (a transposed 64 x 64 weight tile) x (a row-major tile).
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][8],
                                                const float* w,
                                                const float* m, int ra,
                                                int tx) {
#pragma unroll 4
  for (int j = 0; j < FB_B; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(w + j * FB_LD + ra);
    const float4 m0 =
        *reinterpret_cast<const float4*>(m + j * FB_HD_MAX + tx * 4);
    const float4 m1 =
        *reinterpret_cast<const float4*>(m + j * FB_HD_MAX + 64 + tx * 4);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], mv[c], acc[i][c]);
  }
}

// The thread's 4 x 8 block of a 64-row output tile, rows r0 + ty*4 + i,
// columns < dim.
template <typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][8],
                                           int r0, int n, int dim, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + tx * 4 + (c % 4);
      if (col < dim) out[(size_t)row * dim + col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int Tk, int hd, int hdv, float scale,
                        int causal) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [hd][FB_LD]
  float* dOt = Qt + FB_T_FLOATS;                 // [hdv][FB_LD]
  float* Kt = dOt + FB_T_FLOATS;                 // [hd][FB_LD]
  float* VK = Kt + FB_T_FLOATS;                  // Vt [hdv][LD] | K [B][128]
  float* dSt = VK + FB_T_FLOATS;                 // [FB_B (k)][FB_LD (q)]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nq = (S + FB_B - 1) / FB_B;
  const int q0 = (nq - 1 - (int)blockIdx.x) * FB_B;   // longest tiles first
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * S * hd;
  const T* dob = dout + bh * S * hdv;
  const T* kb = k + bh * Tk * hd;
  const T* vb = v + bh * Tk * hdv;

  load_transposed(Qt, qb, q0, S, hd);
  load_transposed(dOt, dob, q0, S, hdv);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < S ? lse[bh * S + row] : 0.0f;
    delta_r[i] = row < S ? delta[bh * S + row] : 0.0f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  const int k_end = causal ? min(Tk, q0 + FB_B) : Tk;   // stop at diagonal
  for (int k0 = 0; k0 < k_end; k0 += FB_B) {
    __syncthreads();            // the last tile's dq product is done
    load_transposed(Kt, kb, k0, Tk, hd);
    load_transposed(VK, vb, k0, Tk, hdv);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dots(s, Qt, Kt, ty * 4, tx * 4, hd);
    tile_dots(dp, dOt, VK, ty * 4, tx * 4, hdv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool keep = row < S && col < Tk && (!causal || col <= row);
        const float p = expf((keep ? s[i][j] * scale : FB_NEG) - lse_r[i]);
        s[i][j] = p * (dp[i][j] - delta_r[i]) * scale;   // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dSt + (tx * 4 + j) * FB_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();            // every read of v^T is done
    load_rows(VK, kb, k0, Tk, hd);
    __syncthreads();
    tile_accumulate(acc, dSt, VK, ty * 4, tx);
  }
  store_rows(dq + bh * S * hd, acc, q0, S, hd, ty, tx);
}

template <typename T>
__global__ void __launch_bounds__(FB_THREADS, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S,
                         int Tk, int hd, int hdv, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [hd][FB_LD]
  float* Vt = Kt + FB_T_FLOATS;                  // [hdv][FB_LD]
  float* QQ = Vt + FB_T_FLOATS;                  // Qt [hd][LD] | Q [B][128]
  float* OO = QQ + FB_T_FLOATS;                  // dOt | dO [B][128]
  float* Pt = OO + FB_T_FLOATS;                  // [FB_B (q)][FB_LD (k)]
  float* dSt = Pt + FB_B * FB_LD;                // [FB_B (q)][FB_LD (k)]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // ty: k rows, tx: q columns
  const int nk = (Tk + FB_B - 1) / FB_B;
  const int k0 = (causal ? (int)blockIdx.x : nk - 1 - (int)blockIdx.x) *
                 FB_B;          // causal: the longest q loops (low k) first
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * S * hd;
  const T* dob = dout + bh * S * hdv;
  const T* kb = k + bh * Tk * hd;
  const T* vb = v + bh * Tk * hdv;

  load_transposed(Kt, kb, k0, Tk, hd);
  load_transposed(Vt, vb, k0, Tk, hdv);
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  // the first q tile with a row at or past k0 (causal); every row > k0
  // of later tiles reaches this k tile
  const int q_begin = causal ? (k0 / FB_B) * FB_B : 0;
  for (int q0 = q_begin; q0 < S; q0 += FB_B) {
    __syncthreads();            // the last tile's dk / dv products are done
    load_transposed(QQ, qb, q0, S, hd);
    load_transposed(OO, dob, q0, S, hdv);
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx * 4 + j;
      lse_c[j] = row < S ? lse[bh * S + row] : 0.0f;
      delta_c[j] = row < S ? delta[bh * S + row] : 0.0f;
    }
    __syncthreads();

    // transposed score tile: s[i][j] = (q k^T)[q0 + tx*4 + j][k0 + ty*4 + i]
    float s[4][4] = {}, dp[4][4] = {};
    tile_dots(s, Kt, QQ, ty * 4, tx * 4, hd);
    tile_dots(dp, Vt, OO, ty * 4, tx * 4, hdv);
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx * 4 + j;
        const bool keep = row < S && col < Tk && (!causal || col <= row);
        p[i][j] = expf((keep ? s[i][j] * scale : FB_NEG) - lse_c[j]);
        s[i][j] = p[i][j] * (dp[i][j] - delta_c[j]) * scale;   // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * FB_LD + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
      *reinterpret_cast<float4*>(dSt + (tx * 4 + j) * FB_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();            // every read of q^T and do^T is done
    load_rows(QQ, qb, q0, S, hd);
    load_rows(OO, dob, q0, S, hdv);
    __syncthreads();
    tile_accumulate(dv_acc, Pt, OO, ty * 4, tx);
    tile_accumulate(dk_acc, dSt, QQ, ty * 4, tx);
  }
  store_rows(dk + bh * Tk * hd, dk_acc, k0, Tk, hd, ty, tx);
  store_rows(dv + bh * Tk * hdv, dv_acc, k0, Tk, hdv, ty, tx);
}

template <typename T>
int launch_flash_bwd(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, int BH, int S, int Tk,
                     int hd, int hdv, int causal, float scale, int which,
                     cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FB_DQ_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + FB_B - 1) / FB_B, BH);
    rt::launch(flash_bwd_dq_kernel<T>, grid, FB_THREADS, FB_DQ_SMEM_BYTES, st,
        q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), S, Tk, hd, hdv,
        scale, causal);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FB_DKV_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Tk + FB_B - 1) / FB_B, BH);
    rt::launch(flash_bwd_dkv_kernel<T>, grid, FB_THREADS, FB_DKV_SMEM_BYTES,
        st, q_, k_, v_, do_, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), S, Tk, hd, hdv, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// q (BH, S, hd), k (BH, T, hd), v (BH, T, hdv), do (BH, S, hdv), dq like
// q, dk like k, dv like v: row-major, all in dtype f32 (0) or bf16 (1);
// lse and delta (BH, S) f32.  hd, hdv <= 128.  which = 0 launches the dq
// kernel (dk, dv unused), 1 the dkv kernel (dq unused).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk,
                                void* dv, int BH, int S, int Tk, int hd,
                                int hdv, int dtype, int causal, float scale,
                                int which, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == DTYPE_BF16)
    return launch_flash_bwd<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk, dv,
                                           BH, S, Tk, hd, hdv, causal, scale,
                                           which, st);
  return launch_flash_bwd<float>(q, k, v, dout, l, dl, dq, dk, dv, BH, S, Tk,
                                 hd, hdv, causal, scale, which, st);
}

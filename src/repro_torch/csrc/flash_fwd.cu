// Flash attention, forward: o = softmax(q k^T * scale [causal mask]) v and
// the row log-sum-exp lse, over (BH, S, hd) q and (BH, T, hd) / (BH, T,
// hdv) k and v, f32 or bf16, without writing the (S, T) scores anywhere.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_fwd (body
// _fwd_kernel), which the LM's forward reaches through ops.sdpa_flash
// when attn_impl="flash": 28 launches per Qwen3-1.7B forward.
//
// What bounds it on an H100: at the prefill's shape (BH = 64, S = T =
// 2048, hd = 128, causal) the work is 4 * BH * hd * S^2 / 2 = 68.7 GFLOP
// against 134.7 MB of q, k, v and o: operation-bound, 69 us at the bf16
// tensor-core rate (989 TFLOP/s) and 1.03 ms at the FP32 rate.
//
// Design (simple and exact first): products are FP32 FMAs on the CUDA
// cores for both input types (bf16 is widened to f32 as it is loaded; no
// TF32, no tensor cores), so this kernel is bound by the FP32 rate, not
// the bf16 one.  One 256-thread block per (bh, 64-row q tile); a loop over
// 64-row k/v tiles takes the place of the TPU grid's sequential kv axis.
// The q tile and each k tile sit transposed in shared memory (d-major, so
// a thread reads four rows' values with one 16-byte load); each thread
// owns a 4 x 4 block of the score tile and a 4 x 8 block of the output
// rows it shares with its 15 neighbours of the same half-warp.  The
// online-softmax state m, l and the f32 accumulator live in registers;
// row maxima and sums over the 16 lanes of a row are butterflies of warp
// shuffles (every lane ends with the same bits).  p stays f32 for the PV
// product (the TPU kernel rounds it to the input type first).  The k
// tile's buffer is reused for the v tile, so a block needs 85 KB of
// shared memory and two blocks fit on an SM.  Causal tiles wholly above
// the diagonal are skipped; q tiles are taken longest first.  The causal
// mask is col <= row with the fill -1e30, as in the TPU kernel; rows and
// columns past S and T are masked (q and v rows past the end load as 0).
#include "dtype.cuh"

namespace rt {

constexpr int FA_BQ = 64;              // q rows per block
constexpr int FA_BK = 64;              // k/v rows per tile
constexpr int FA_HD_MAX = 128;         // largest hd and hdv taken
constexpr int FA_THREADS = 256;        // 16 row groups x 16 column groups
constexpr int FA_LD = FA_BQ + 4;       // row stride of the transposed tiles
constexpr int FA_KV_FLOATS =
    FA_HD_MAX * FA_LD > FA_BK * FA_HD_MAX ? FA_HD_MAX * FA_LD
                                          : FA_BK * FA_HD_MAX;
constexpr int FA_SMEM_BYTES =
    (FA_HD_MAX * FA_LD + FA_KV_FLOATS + FA_BK * FA_LD) * (int)sizeof(float);
constexpr float FA_NEG = -1e30f;

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int Tk, int hd, int hdv,
                     float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [FA_HD_MAX][FA_LD]
  float* KV = Qt + FA_HD_MAX * FA_LD;            // Kt [hd][FA_LD] | V [BK][128]
  float* Pt = KV + FA_KV_FLOATS;                 // [FA_BK][FA_LD]

  const int tid = threadIdx.x;
  const int tx = tid % 16;             // score columns tx*4.., output columns
  const int ty = tid / 16;             // rows ty*4 .. ty*4+3 of the tile
  const int nq = (S + FA_BQ - 1) / FA_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * FA_BQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * S * hd;
  const T* kb = k + bh * Tk * hd;
  const T* vb = v + bh * Tk * hdv;

  for (int e = tid; e < FA_BQ * hd; e += FA_THREADS) {
    const int r = e / hd, d = e % hd;
    Qt[d * FA_LD + r] =
        q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * hd + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(Tk, q0 + FA_BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();                   // the last tile's PV is done with KV, Pt
    for (int e = tid; e < FA_BK * hd; e += FA_THREADS) {
      const int j = e / hd, d = e % hd;
      KV[d * FA_LD + j] =
          k0 + j < Tk ? to_f32(kb[(size_t)(k0 + j) * hd + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * FA_LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(KV + d * FA_LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool keep = col < Tk && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : FA_NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * FA_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();                   // every read of the k tile is done

    for (int e = tid; e < FA_BK * hdv; e += FA_THREADS) {
      const int j = e / hdv, c = e % hdv;
      KV[j * FA_HD_MAX + c] =
          k0 + j < Tk ? to_f32(vb[(size_t)(k0 + j) * hdv + c]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + j * FA_LD + ty * 4);
      const float4 v0 =
          *reinterpret_cast<const float4*>(KV + j * FA_HD_MAX + tx * 4);
      const float4 v1 =
          *reinterpret_cast<const float4*>(KV + j * FA_HD_MAX + 64 + tx * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + row) * hdv;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + tx * 4 + (c % 4);
      if (col < hdv) orow[col] = from_f32<T>(acc[i][c] / lf);
    }
    if (tx == 0) lse[bh * S + row] = m[i] + logf(lf);
  }
}

template <typename T>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     float* lse, int BH, int S, int Tk, int hd, int hdv,
                     int causal, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FA_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, BH);
  rt::launch(flash_fwd_kernel<T>, grid, FA_THREADS, FA_SMEM_BYTES, st,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, hd, hdv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// q (BH, S, hd), k (BH, T, hd), v (BH, T, hdv), o (BH, S, hdv): row-major,
// all in dtype f32 (0) or bf16 (1); lse (BH, S) f32.  hd, hdv <= 128.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int S, int Tk,
                                int hd, int hdv, int dtype, int causal,
                                float scale, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_BF16)
    return launch_flash_fwd<__nv_bfloat16>(q, k, v, o, l, BH, S, Tk, hd, hdv,
                                           causal, scale, st);
  return launch_flash_fwd<float>(q, k, v, o, l, BH, S, Tk, hd, hdv, causal,
                                 scale, st);
}

// Flash attention forward on the tensor cores: o = softmax(q k^T * scale
// [causal mask]) v and the row log-sum-exp lse over (BH, S, hd) q and
// (BH, T, hd) k and v, bf16 with hd = hdv in {64, 128}; the other dtypes
// and head dims take flash_fwd.cu (kernels/flash_attention.flash_route).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_fwd (pallas_call
// at :95, body _fwd_kernel :36-78), which the LM's forward reaches
// through ops.sdpa_flash when attn_impl="flash": 28 launches a Qwen3-1.7B
// prefill, 112 a training step (forward and recompute).
//
// What bounds it on an H100: at the prefill's shape (BH = 64, S = T =
// 2048, hd = 128, causal) the two products are 4 BH hd S (S + 1) / 2 =
// 68.7 GFLOP against 134 MB of q, k, v and o: operation-bound, 69 us at
// the bf16 tensor-core rate (989 TFLOP/s).
//
// Design.  One CTA of three warpgroups per (bh, 128-row q tile), the
// longest causal tiles first.  Warpgroup 0 is the producer: after
// setmaxnreg.dec one thread loads the q tile once and then the k and v
// tiles (128 rows) by TMA through a ring of two stages, each with a full
// barrier for k, one for v and an empty barrier.  Warpgroups 1 and 2 are
// the consumers, 64 q rows each, after setmaxnreg.inc:
//   S = Q K^T        wgmma m64n128k16, Q and K both K-major in shared
//                    memory (the TMA's 128-byte swizzle), f32 accumulate;
//   softmax          in registers: the row max and sum over the four
//                    lanes of a quad of the accumulator layout, alpha
//                    rescales the O accumulator, l sums the f32 p (the TPU
//                    kernel's order, flash_attention.py:64-66);
//   O += P V         wgmma m64nHDk16 with P rounded to bf16 in registers
//                    as the A operand (the TPU kernel's p.astype(v.dtype),
//                    :68) and V as the shared-memory B operand through an
//                    MN-major descriptor: V is never transposed.
// Masks: -1e30 for columns past T and, causal, col > row; only tiles that
// cross the diagonal or the end of T are masked, tiles wholly above the
// diagonal are not loaded.  The 3-D tensor maps read rows past S or T as
// 0, so a ragged tile never reads the next head.  Epilogue: o = acc /
// max(l, 1e-30) rounded to bf16, lse = m + log l in f32.  Scores run in
// the log2 domain (exp2 of s * scale * log2 e), which changes nothing
// beyond f32 rounding.
#include "wgmma_tile.cuh"

namespace rt {

constexpr int FW_BQ = 128;             // q rows a CTA (64 a consumer)
constexpr int FW_BK = 128;             // k/v rows a tile
constexpr int FW_STAGES = 2;
constexpr int FW_THREADS = 384;        // producer + two consumer warpgroups
constexpr float FW_NEG = -1e30f;

template <int HD>
struct FwdSmem {
  static constexpr int TILE = 128 * HD * 2;      // a q, k or v tile
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + FW_STAGES * TILE;
  static constexpr int BARS = V + FW_STAGES * TILE;
  static constexpr int BYTES = BARS + 8 * (1 + 3 * FW_STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int S, int Tk,
                           float scale_log2, int causal) {
  using L = FwdSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FW_STAGES;
  uint64_t* empty = v_full + FW_STAGES;

  const int nq = (S + FW_BQ - 1) / FW_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * FW_BQ;
  const int bh = blockIdx.y;
  const int k_end = causal ? min(Tk, q0 + FW_BQ) : Tk;
  const int n_k = (k_end + FW_BK - 1) / FW_BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----------------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
      tma_tile<HD>(smem + L::Q, &tq, q_full, FW_BQ, q0, bh);
      for (int it = 0; it < n_k; ++it) {
        const int s = it % FW_STAGES;
        mbar_wait(empty + s, ((it / FW_STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, L::TILE);
        tma_tile<HD>(smem + L::K + s * L::TILE, &tk, k_full + s, FW_BK,
                     it * FW_BK, bh);
        mbar_expect_tx(v_full + s, L::TILE);
        tma_tile<HD>(smem + L::V + s * L::TILE, &tv, v_full + s, FW_BK,
                     it * FW_BK, bh);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    // accumulator element 4i + j sits at row row0 + 8 (j >> 1) of the
    // warpgroup's 64 and column 8i + 2 (lane % 4) + (j & 1)
    const int row0 = 64 * wg + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(smem + L::Q);

    float acc[HD / 2], m[2] = {FW_NEG, FW_NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_k; ++it) {
      const int s = it % FW_STAGES, parity = (it / FW_STAGES) & 1;
      const int k0 = it * FW_BK;
      const uint32_t k_addr = smem_u32(smem + L::K + s * L::TILE);
      const uint32_t v_addr = smem_u32(smem + L::V + s * L::TILE);
      float sc[FW_BK / 2];
      mbar_wait(k_full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n128(sc, desc_kmajor(q_addr, FW_BQ, 64 * wg, kk),
                      desc_kmajor(k_addr, FW_BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // mask only where the tile crosses the diagonal or the end of T
      const bool mask =
          (causal && k0 + FW_BK - 1 > q0 + 64 * wg) || k0 + FW_BK > Tk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < FW_BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[4 * i + j] * scale_log2;
          if (mask) {
            const int col = k0 + 8 * i + col0 + (j & 1);
            const int row = q0 + row0 + 8 * (j >> 1);
            if (col >= Tk || (causal && col > row)) x = FW_NEG;
          }
          sc[4 * i + j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
      float alpha[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < FW_BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(sc[4 * i + j] - m[j >> 1]);
          sc[4 * i + j] = p;
          ls[j >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * i + j] *= alpha[j >> 1];

      // p in bf16 as wgmma A fragments, written before the fence
      uint32_t pa[FW_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < FW_BK / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
      mbar_wait(v_full + s, parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FW_BK / 16; ++kk)
        wgmma_rs<HD>(acc, pa[kk], desc_mnmajor(v_addr, FW_BK, kk), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(empty + s);
    }

    // ---- epilogue: o = acc / l in bf16, lse = m + log l ---------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      const float lf = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row >= S) continue;
      const float inv = 1.0f / lf;
      __nv_bfloat16* orow = o + ((size_t)bh * S + row) * HD + col0;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(acc[4 * i + 2 * r] * inv,
                      acc[4 * i + 2 * r + 1] * inv);
      if (lane % 4 == 0)
        lse[(size_t)bh * S + row] = (m[r] + log2f(lf)) * WG_LN2;
    }
  }
}

template <int HD>
int launch_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                           void* o, float* lse, int BH, int S, int Tk,
                           int causal, float scale, cudaStream_t st) {
  using L = FwdSmem<HD>;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, BH, S, HD, FW_BQ);
  if (e == 0) e = make_map(&tk, k, BH, Tk, HD, FW_BK);
  if (e == 0) e = make_map(&tv, v, BH, Tk, HD, FW_BK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + FW_BQ - 1) / FW_BQ, BH);
  rt::launch(flash_fwd_wgmma_kernel<HD>, grid, FW_THREADS, L::BYTES, st, tq,
      tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, Tk, scale * WG_LOG2E,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// q (BH, S, hd), k and v (BH, T, hd), o (BH, S, hd): row-major bf16, base
// addresses 16-byte aligned; lse (BH, S) f32; hd 64 or 128.  Returns the
// CUDA error of the launch (0 on success), or WG_ERR_* when the tensor
// maps cannot be made.
extern "C" int flash_fwd_wgmma_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int BH, int S, int Tk, int hd,
                                      int causal, float scale,
                                      void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 128)
    return launch_flash_fwd_wgmma<128>(q, k, v, o, l, BH, S, Tk, causal,
                                       scale, st);
  if (hd == 64)
    return launch_flash_fwd_wgmma<64>(q, k, v, o, l, BH, S, Tk, causal,
                                      scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

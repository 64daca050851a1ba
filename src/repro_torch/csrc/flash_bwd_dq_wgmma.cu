// Flash attention backward, dq, on the tensor cores: dq = sum_j ds_ij k_j
// with p = exp(q k^T * scale - lse) (0 where masked) and ds = p * (do v^T -
// delta) * scale, over (BH, S, hd) q and do and (BH, T, hd) k and v, bf16
// with hd = hdv in {64, 128}, from the forward's lse and delta = sum(do *
// o, -1) (both (BH, S) f32).  dk and dv are flash_bwd_wgmma.cu's; the other
// dtypes and head dims take flash_bwd.cu's dq kernel
// (kernels/flash_attention.flash_route).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_bwd, body
// _dq_kernel (:124-160, pallas_call at :220): 28 launches a Qwen3-1.7B
// backward, 56 a training step.
//
// What bounds it on an H100: at the training path's shape (BH = 32, S = T
// = 2048, hd = 128, bf16, causal) its three products q k^T, do v^T and ds k
// are 2 BH hd S (S + 1) / 2 each, 51.5 GFLOP in all, against 84 MB of q,
// k, v, do, lse, delta and dq: operation-bound, 52 us at the bf16
// tensor-core rate.
//
// Design.  One CTA of three warpgroups per (bh, 128-row q tile), the
// longest causal tiles first.  Warpgroup 0 is the producer: after
// setmaxnreg.dec one thread loads the q and do tiles once by TMA and then
// streams 64-row k and v tiles through a ring of four stages (one full and
// one empty barrier a stage).  Warpgroups 1 and 2 own 64 q rows each and
// keep their rows' lse (times log2 e) and delta in registers:
//   S  = Q K^T, dP = dO V^T   wgmma m64n64k16, all four operands K-major
//                             in shared memory, committed as two groups;
//   P  = exp2(S scale log2e - lse), in registers while dP is still on the
//                             tensor cores (wait_group 1, then 0);
//   dS = P (dP - delta) scale, rounded to bf16 as wgmma A fragments;
//   dQ += dS K                wgmma m64nHDk16 with the same k stage as an
//                             MN-major B operand, so each k tile serves
//                             both of its roles from one load.
// The dQ product is not waited on: the next tile's S and dP are issued
// behind it, and the stage it reads goes back to the producer only after
// the next wait_group has covered it.  dQ accumulates in f32 registers (64
// a thread at hd 128).  Causal: each warpgroup stops at its own diagonal
// tile; only tiles that cross the diagonal or the end of T are masked.
// Ragged S and T: the 3-D tensor maps read rows past the end of a head as
// 0, so a ragged tile never reads the next head.  One owner CTA an output
// and no atomics: dq repeats bit for bit.
//
// A deliberate difference from the reference (ROADMAP C7): the TPU's
// _dq_kernel multiplies the f32 ds by k (flash_attention.py:156-158); here
// ds is rounded to bf16 for the tensor cores, as FlashAttention-2 and -3
// do: a relative 2^-9 per entry, summed over a row of k
// (ref.flash_dq_bf16_tolerance).
#include "wgmma_tile.cuh"

namespace rt {

constexpr int DQ_BQ = 128;             // q rows a CTA (64 a consumer)
constexpr int DQ_BK = 64;              // k/v rows a stage
constexpr int DQ_STAGES = 4;
constexpr int DQ_THREADS = 384;

template <int HD>
struct DqSmem {
  static constexpr int Q_TILE = DQ_BQ * HD * 2;
  static constexpr int KV_TILE = DQ_BK * HD * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_TILE;
  static constexpr int K = DO + Q_TILE;                   // per stage
  static constexpr int V = K + DQ_STAGES * KV_TILE;       // per stage
  static constexpr int BARS = V + DQ_STAGES * KV_TILE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * DQ_STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int S, int Tk,
                              float scale, int causal) {
  using L = DqSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int nq = (S + DQ_BQ - 1) / DQ_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * DQ_BQ;   // longest tiles first
  const int bh = blockIdx.y;
  const int k_end = causal ? min(Tk, q0 + DQ_BQ) : Tk;
  const int n_k = (k_end + DQ_BK - 1) / DQ_BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----------------------------------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::Q_TILE);
      tma_tile<HD>(smem + L::Q, &tq, q_full, DQ_BQ, q0, bh);
      tma_tile<HD>(smem + L::DO, &tdo, q_full, DQ_BQ, q0, bh);
      for (int it = 0; it < n_k; ++it) {
        const int s = it % DQ_STAGES;
        mbar_wait(empty + s, ((it / DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::KV_TILE);
        tma_tile<HD>(smem + L::K + s * L::KV_TILE, &tk, full + s, DQ_BK,
                     it * DQ_BK, bh);
        tma_tile<HD>(smem + L::V + s * L::KV_TILE, &tv, full + s, DQ_BK,
                     it * DQ_BK, bh);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    // accumulator element 4i + j sits at row row0 + 8 (j >> 1) of the CTA's
    // 128 and column 8i + col0 + (j & 1) (k for S and dP, hd for dQ)
    const int row0 = 64 * wg + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(smem + L::Q);
    const uint32_t do_addr = smem_u32(smem + L::DO);
    const float scale_log2 = scale * WG_LOG2E;
    float lse2[2], dl[2];            // rows past S: 0, so ds is 0 there
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      const size_t at = (size_t)bh * S + row;
      lse2[r] = row < S ? lse[at] * WG_LOG2E : 0.0f;
      dl[r] = row < S ? delta[at] : 0.0f;
    }
    // causal: the k tiles this warpgroup's 64 rows reach (one fewer than
    // the CTA's for the first warpgroup, never more than one)
    const int n_kw =
        causal ? (min(Tk, q0 + 64 * wg + 64) + DQ_BK - 1) / DQ_BK : n_k;

    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.0f;
    uint32_t dsa[DQ_BK / 16][4];
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_kw; ++it) {
      const int s = it % DQ_STAGES, parity = (it / DQ_STAGES) & 1;
      const int k0 = it * DQ_BK;
      const uint32_t k_addr = smem_u32(smem + L::K + s * L::KV_TILE);
      const uint32_t v_addr = smem_u32(smem + L::V + s * L::KV_TILE);
      float sc[DQ_BK / 2], dp[DQ_BK / 2];
      mbar_wait(full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc, desc_kmajor(q_addr, DQ_BQ, 64 * wg, kk),
                     desc_kmajor(k_addr, DQ_BK, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor(do_addr, DQ_BQ, 64 * wg, kk),
                     desc_kmajor(v_addr, DQ_BK, 0, kk), kk > 0);
      wgmma_commit();
      // the last tile's dQ product and this tile's S are done; dP may run on
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dq_acc);
      if (it > 0) mbar_arrive(empty + (it - 1) % DQ_STAGES);

      // mask only where the tile crosses the diagonal or the end of T
      const bool mask =
          (causal && k0 + DQ_BK - 1 > q0 + 64 * wg) || k0 + DQ_BK > Tk;
#pragma unroll
      for (int i = 0; i < DQ_BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2f(sc[4 * i + j] * scale_log2 - lse2[j >> 1]);
          if (mask) {
            const int col = k0 + 8 * i + col0 + (j & 1);
            const int row = q0 + row0 + 8 * (j >> 1);
            if (col >= Tk || (causal && col > row)) p = 0.0f;
          }
          sc[4 * i + j] = p;
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < DQ_BK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dp[4 * i + j] =
              sc[4 * i + j] * (dp[4 * i + j] - dl[j >> 1]) * scale;

      // ds in bf16 as wgmma A fragments, written before the fence
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk) acc_to_a(dp, kk, dsa[kk]);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        wgmma_rs<HD>(dq_acc, dsa[kk], desc_mnmajor(k_addr, DQ_BK, kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq_acc);
    if (n_kw > 0) mbar_arrive(empty + (n_kw - 1) % DQ_STAGES);

    // ---- epilogue: dq rounded once to bf16 ----------------------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* drow = dq + ((size_t)bh * S + row) * HD + col0;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(drow + 8 * i) =
            pack_bf16(dq_acc[4 * i + 2 * r], dq_acc[4 * i + 2 * r + 1]);
    }
  }
}

template <int HD>
int launch_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, int BH, int S,
                              int Tk, int causal, float scale,
                              cudaStream_t st) {
  using L = DqSmem<HD>;
  CUtensorMap tq, tk, tv, tdo;
  int e = make_map(&tq, q, BH, S, HD, DQ_BQ);
  if (e == 0) e = make_map(&tdo, dout, BH, S, HD, DQ_BQ);
  if (e == 0) e = make_map(&tk, k, BH, Tk, HD, DQ_BK);
  if (e == 0) e = make_map(&tv, v, BH, Tk, HD, DQ_BK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + DQ_BQ - 1) / DQ_BQ, BH);
  rt::launch(flash_bwd_dq_wgmma_kernel<HD>, grid, DQ_THREADS, L::BYTES, st, tq,
      tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S, Tk, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// q, do and dq (BH, S, hd), k and v (BH, T, hd): row-major bf16, base
// addresses 16-byte aligned; lse and delta (BH, S) f32; hd 64 or 128.
// Returns the CUDA error of the launch (0 on success), or WG_ERR_* when
// the tensor maps cannot be made.
extern "C" int flash_bwd_dq_wgmma_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int BH, int S, int Tk,
                                         int hd, int causal, float scale,
                                         void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (hd == 128)
    return launch_flash_bwd_dq_wgmma<128>(q, k, v, dout, l, dl, dq, BH, S,
                                          Tk, causal, scale, st);
  if (hd == 64)
    return launch_flash_bwd_dq_wgmma<64>(q, k, v, dout, l, dl, dq, BH, S, Tk,
                                         causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash attention backward, dk and dv, on the tensor cores: dv = p^T do and
// dk = ds^T q with p = exp(q k^T * scale - lse) (0 where masked) and ds =
// p * (do v^T - delta) * scale, over (BH, S, hd) q and do and (BH, T, hd)
// k and v, bf16 with hd = hdv in {64, 128}, from the forward's lse and
// delta = sum(do * o, -1) (both (BH, S) f32).  dq stays with flash_bwd.cu;
// the other dtypes and head dims take flash_bwd.cu's dkv kernel
// (kernels/flash_attention.flash_route).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_bwd, body
// _dkv_kernel (:163-206, pallas_call at :240): 28 launches a Qwen3-1.7B
// backward, 56 a training step.
//
// What bounds it on an H100: at the training path's shape (BH = 32, S = T
// = 2048, hd = 128, bf16, causal) its four products are 2 BH hd S (S + 1)
// / 2 each, 68.7 GFLOP in all, against 101 MB of q, k, v, do, lse,
// delta, dk and dv: operation-bound, 69 us at the bf16 tensor-core rate.
//
// Design.  One CTA of three warpgroups per (bh, 128-row k/v tile), the
// tiles with the most q tiles first.  Warpgroup 0 is the producer: after
// setmaxnreg.dec one thread loads the k and v tiles once by TMA, and warp
// 0 streams 64-row q and do tiles through a ring of three stages (TMA)
// with the q tile's lse (times log2 e) and delta (plain loads into shared
// memory before the stage's full barrier is armed).  Warpgroups 1 and 2
// own 64 k/v rows each and compute the transposed scores directly, so
// every q and do tile is loaded once and serves both of its roles:
//   S^T  = K Q^T, dP^T = V dO^T     wgmma m64n64k16, all four operands
//                                   K-major in shared memory;
//   P^T  = exp(S^T scale - lse[q]),  in registers, lse and delta broadcast
//   dS^T = P^T (dP^T - delta[q]) scale      along the columns (q);
//   dV  += P^T dO, dK += dS^T Q      wgmma m64nHDk16 with P^T and dS^T
//                                   rounded to bf16 in registers as the A
//                                   operands and the same q and do stage
//                                   as the B operands through MN-major
//                                   descriptors.
// Neither the S tile nor the dS tile goes through shared memory.  dK and
// dV accumulate in f32 registers (64 + 64 a thread at hd 128).  Causal:
// the q loop starts at the first q tile that reaches the k/v tile; only
// tiles that cross the diagonal or the end of S are masked.  Each output
// has one owner CTA and no atomics, so dk and dv repeat bit for bit.
//
// A deliberate difference from the reference (ROADMAP C5): the TPU's
// _dkv_kernel multiplies f32 p and ds (flash_attention.py:186-197); here
// they are rounded to bf16 for the tensor cores, as FlashAttention-2 and
// -3 do: a relative 2^-9 per entry, summed over a column of q.
#include "wgmma_tile.cuh"

namespace rt {

constexpr int DKV_BK = 128;            // k/v rows a CTA (64 a consumer)
constexpr int DKV_BQ = 64;             // q rows a stage
constexpr int DKV_STAGES = 3;
constexpr int DKV_THREADS = 384;

template <int HD>
struct DkvSmem {
  static constexpr int KV_TILE = DKV_BK * HD * 2;
  static constexpr int Q_TILE = DKV_BQ * HD * 2;
  static constexpr int K = 0;
  static constexpr int V = K + KV_TILE;
  static constexpr int Q = V + KV_TILE;                 // per stage
  static constexpr int DO = Q + DKV_STAGES * Q_TILE;    // per stage
  static constexpr int LSE = DO + DKV_STAGES * Q_TILE;  // [stage][64] f32
  static constexpr int DELTA = LSE + DKV_STAGES * DKV_BQ * 4;
  static constexpr int BARS = DELTA + DKV_STAGES * DKV_BQ * 4;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * DKV_STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int S, int Tk,
                               float scale, int causal) {
  using L = DkvSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int nk = (Tk + DKV_BK - 1) / DKV_BK;
  const int k0 = (causal ? (int)blockIdx.x : nk - 1 - (int)blockIdx.x) *
                 DKV_BK;       // causal: the longest q loops (low k) first
  const int bh = blockIdx.y;
  // the first q tile with a row at or past k0 (causal)
  const int q_begin = causal ? k0 : 0;
  const int n_q = q_begin < S ? (S - q_begin + DKV_BQ - 1) / DKV_BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----------------------------------------------------------
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::KV_TILE);
        tma_tile<HD>(smem + L::K, &tk, kv_full, DKV_BK, k0, bh);
        tma_tile<HD>(smem + L::V, &tv, kv_full, DKV_BK, k0, bh);
      }
      for (int it = 0; it < n_q; ++it) {
        const int s = it % DKV_STAGES;
        const int q0 = q_begin + it * DKV_BQ;
        mbar_wait(empty + s, ((it / DKV_STAGES) & 1) ^ 1);
        for (int j = lane; j < DKV_BQ; j += 32) {
          const bool in = q0 + j < S;
          const size_t at = (size_t)bh * S + q0 + j;
          lse_s[s * DKV_BQ + j] = in ? lse[at] * WG_LOG2E : 0.0f;
          delta_s[s * DKV_BQ + j] = in ? delta[at] : 0.0f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * L::Q_TILE);
          tma_tile<HD>(smem + L::Q + s * L::Q_TILE, &tq, full + s, DKV_BQ,
                       q0, bh);
          tma_tile<HD>(smem + L::DO + s * L::Q_TILE, &tdo, full + s, DKV_BQ,
                       q0, bh);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    // element 4i + j of a 64-row accumulator: k/v row row0 + 8 (j >> 1) of
    // the CTA's 128, column 8i + col0 + (j & 1) (q for S^T, hd for dK)
    const int row0 = 64 * wg + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t k_addr = smem_u32(smem + L::K);
    const uint32_t v_addr = smem_u32(smem + L::V);
    const float scale_log2 = scale * WG_LOG2E;

    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_q; ++it) {
      const int s = it % DKV_STAGES, parity = (it / DKV_STAGES) & 1;
      const int q0 = q_begin + it * DKV_BQ;
      const uint32_t q_addr = smem_u32(smem + L::Q + s * L::Q_TILE);
      const uint32_t do_addr = smem_u32(smem + L::DO + s * L::Q_TILE);
      float st[DKV_BQ / 2], dpt[DKV_BQ / 2];
      mbar_wait(full + s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(st, desc_kmajor(k_addr, DKV_BK, 64 * wg, kk),
                     desc_kmajor(q_addr, DKV_BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(dpt, desc_kmajor(v_addr, DKV_BK, 64 * wg, kk),
                     desc_kmajor(do_addr, DKV_BQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      const bool mask =
          (causal && q0 < k0 + 64 * wg + 63) || q0 + DKV_BQ > S;
      const float* ls = lse_s + s * DKV_BQ;
      const float* dl = delta_s + s * DKV_BQ;
#pragma unroll
      for (int i = 0; i < DKV_BQ / 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * i + col0);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * i + col0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float l = (j & 1) ? l2.y : l2.x;
          float p = exp2f(st[4 * i + j] * scale_log2 - l);
          if (mask) {
            const int q = q0 + 8 * i + col0 + (j & 1);
            const int kv = k0 + row0 + 8 * (j >> 1);
            if (q >= S || (causal && kv > q)) p = 0.0f;
          }
          st[4 * i + j] = p;
          dpt[4 * i + j] = p * (dpt[4 * i + j] - ((j & 1) ? d2.y : d2.x)) *
                           scale;
        }
      }

      // p^T and ds^T in bf16 as wgmma A fragments, written before the fence
      uint32_t pa[DKV_BQ / 16][4], dsa[DKV_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
        acc_to_a(st, kk, pa[kk]);
        acc_to_a(dpt, kk, dsa[kk]);
      }
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs<HD>(dv_acc, pa[kk], desc_mnmajor(do_addr, DKV_BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs<HD>(dk_acc, dsa[kk], desc_mnmajor(q_addr, DKV_BQ, kk), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(empty + s);
    }

    // ---- epilogue: dk, dv rounded once to bf16 ------------------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0 + row0 + 8 * r;
      if (row >= Tk) continue;
      const size_t at = ((size_t)bh * Tk + row) * HD + col0;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * i) =
            pack_bf16(dk_acc[4 * i + 2 * r], dk_acc[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * i) =
            pack_bf16(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <int HD>
int launch_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dk, void* dv,
                               int BH, int S, int Tk, int causal, float scale,
                               cudaStream_t st) {
  using L = DkvSmem<HD>;
  CUtensorMap tq, tk, tv, tdo;
  int e = make_map(&tq, q, BH, S, HD, DKV_BQ);
  if (e == 0) e = make_map(&tdo, dout, BH, S, HD, DKV_BQ);
  if (e == 0) e = make_map(&tk, k, BH, Tk, HD, DKV_BK);
  if (e == 0) e = make_map(&tv, v, BH, Tk, HD, DKV_BK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tk + DKV_BK - 1) / DKV_BK, BH);
  rt::launch(flash_bwd_dkv_wgmma_kernel<HD>, grid, DKV_THREADS, L::BYTES, st,
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

// q and do (BH, S, hd), k, v, dk and dv (BH, T, hd): row-major bf16, base
// addresses 16-byte aligned; lse and delta (BH, S) f32; hd 64 or 128.
// Returns the CUDA error of the launch (0 on success), or WG_ERR_* when
// the tensor maps cannot be made.
extern "C" int flash_bwd_dkv_wgmma_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int BH, int S,
                                          int Tk, int hd, int causal,
                                          float scale, void* stream) {
  using namespace rt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (hd == 128)
    return launch_flash_bwd_dkv_wgmma<128>(q, k, v, dout, l, dl, dk, dv, BH,
                                           S, Tk, causal, scale, st);
  if (hd == 64)
    return launch_flash_bwd_dkv_wgmma<64>(q, k, v, dout, l, dl, dk, dv, BH,
                                          S, Tk, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Streamed KMV: out = K(A, B)^T X for an A that lives in page-locked host
// memory, chunked as Xc (nc, cr, n) with a zero-padded tail, and the
// gather of sampled rows from that host buffer.
//
// Replaces: src/repro/kernels/kmv_stream.py, kmv_stream_pallas (body
// _kmv_stream_kernel), the TPU kernel that double-buffers chunks of A from
// HBM into two VMEM slots with make_async_copy / DMA semaphores while the
// previous chunk contracts on the MXU.
//
// What bounds it on an H100: every call moves all of Xc over PCIe (Gen5
// x16, 64 GB/s a direction at best), against 2*m*r*n FLOP of contraction
// at 67 TFLOP/s FP32.  For a K-SVM round (r = 32) that is ~10 ms of link
// against well under 1 ms of FP32 work: link-bound, so the pipe must keep
// the copy engine busy.  For a full-matvec piece (r = chunk_rows = 2048)
// the two are level at the bound.
//
// Design: the card's form of the TPU kernel's HBM -> VMEM double buffer is
// pinned host -> two device slots.  One C call runs the whole pipe, so no
// Python runs per chunk:
//   warm-up:  copy chunk 0 into slot 0 on the copy stream, record filled[0]
//   chunk i:  copy stream:    wait freed[(i+1)%2], copy chunk i+1 into that
//                             slot, record filled[(i+1)%2]
//             compute stream: wait filled[i%2], contract slot i%2 against B
//                             and X's rows of chunk i, record freed[i%2]
// Every copy is waited on before its slot is read, and prefetch and
// consume never share a slot (the discipline CHK-DMA checks statically for
// the TPU kernel).  The copy stream first waits on the compute stream's
// earlier work, since the slots were allocated on it.  The contraction is
// the resident KMV's (kmv_partial.cuh), planned for one chunk's rows: f32
// accumulation, B's rbf norms once before the first chunk, each chunk's in
// its feature loop, rows at or past m masked.  Each block adds chunk after
// chunk into its own workspace slice, launches ordered on one stream, and
// one reduce sums the slices in a fixed order: no atomics, results repeat
// from run to run.
#include <algorithm>
#include <cassert>
#include <cstdint>

#include "kmv_partial.cuh"

#define RT_TRY(expr)                                    \
  do {                                                  \
    const cudaError_t rt_err_ = (expr);                 \
    if (rt_err_ != cudaSuccess) return static_cast<int>(rt_err_); \
  } while (0)

namespace rt {

// out[j, :] = rows[idx[j], :], one block a row, copying W-sized words.
// src is the device-side address of the mapped pinned host buffer, so
// each load crosses the link; only the sampled rows move.
template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ src,
                                   const long long* __restrict__ idx,
                                   W* __restrict__ out, int words_per_row,
                                   long long rows_total) {
  const long long row = idx[blockIdx.x];
  assert(row >= 0 && row < rows_total);
  const W* s = src + row * words_per_row;
  W* d = out + (size_t)blockIdx.x * words_per_row;
  for (int k = threadIdx.x; k < words_per_row; k += blockDim.x) d[k] = s[k];
}

struct Events {                       // destroyed on every return path
  cudaEvent_t e[5] = {};
  ~Events() {
    for (cudaEvent_t x : e)
      if (x) cudaEventDestroy(x);     // safe while still pending
  }
};

}  // namespace rt

// Xc: (nc, cr, n) row-major, f32 (0) or bf16 (1); page-locked host memory,
// or, with resident != 0, device memory (the compute-only yardstick: no
// copies, the same contractions).  slot0, slot1: (cr, n) device buffers of
// the same dtype (unused when resident).  B (r, n) in that dtype, Xv
// (nc * cr, c) f32, ws (splits * r * c + r floats: the blocks' slices,
// then |b_j|^2) and out (r, c) f32 on the device.  The plan (regime, bm,
// br, splits, rows_per_split) is kmv_launch's for one chunk of cr rows.
// Rows at or past m are masked.  Returns the first CUDA error, or 0.
extern "C" int kmv_stream_launch(const void* Xc, void* slot0, void* slot1,
                                 const void* B, const void* Xv, void* ws,
                                 void* out, int nc, int cr, int n, int r,
                                 int c, int m, int regime, int bm, int br,
                                 int splits, int rows_per_split, int dtype,
                                 int resident, int kind, int degree,
                                 float coef0, float sigma,
                                 void* compute_stream, void* copy_stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  cudaStream_t cs = static_cast<cudaStream_t>(compute_stream);
  cudaStream_t ps = static_cast<cudaStream_t>(copy_stream);
  const size_t elt = dtype == DTYPE_BF16 ? sizeof(__nv_bfloat16)
                                         : sizeof(float);
  const size_t chunk_bytes = (size_t)cr * n * elt;
  const char* src = static_cast<const char*>(Xc);
  char* slot[2] = {static_cast<char*>(slot0), static_cast<char*>(slot1)};
  float* wsf = static_cast<float*>(ws);
  float* bn = wsf + (size_t)splits * r * c;

  auto contract = [&](const void* A, int i) {
    const float* X = static_cast<const float*>(Xv) + (size_t)i * cr * c;
    const int rows = std::min(cr, m - i * cr);
    return dtype == DTYPE_BF16
               ? kmv_partial<__nv_bfloat16>(A, B, bn, X, wsf, rows, r, n, c,
                                            regime, bm, br, splits,
                                            rows_per_split, i > 0, p, cs)
               : kmv_partial<float>(A, B, bn, X, wsf, rows, r, n, c, regime,
                                    bm, br, splits, rows_per_split, i > 0, p,
                                    cs);
  };

  if (kind == KERNEL_RBF)
    RT_TRY(dtype == DTYPE_BF16 ? kmv_bnorms<__nv_bfloat16>(B, bn, r, n, cs)
                               : kmv_bnorms<float>(B, bn, r, n, cs));
  Events ev;
  if (resident) {
    for (int i = 0; i < nc; ++i) RT_TRY(contract(src + i * chunk_bytes, i));
  } else {
    for (cudaEvent_t& e : ev.e)
      RT_TRY(cudaEventCreateWithFlags(&e, cudaEventDisableTiming));
    cudaEvent_t ready = ev.e[0];
    cudaEvent_t filled[2] = {ev.e[1], ev.e[2]};
    cudaEvent_t freed[2] = {ev.e[3], ev.e[4]};
    RT_TRY(cudaEventRecord(ready, cs));
    RT_TRY(cudaStreamWaitEvent(ps, ready, 0));
    RT_TRY(cudaMemcpyAsync(slot[0], src, chunk_bytes, cudaMemcpyHostToDevice,
                           ps));
    RT_TRY(cudaEventRecord(filled[0], ps));
    for (int i = 0; i < nc; ++i) {
      const int cur = i & 1, nxt = cur ^ 1;
      if (i + 1 < nc) {              // prefetch chunk i+1 into the other slot
        if (i >= 1) RT_TRY(cudaStreamWaitEvent(ps, freed[nxt], 0));
        RT_TRY(cudaMemcpyAsync(slot[nxt], src + (size_t)(i + 1) * chunk_bytes,
                               chunk_bytes, cudaMemcpyHostToDevice, ps));
        RT_TRY(cudaEventRecord(filled[nxt], ps));
      }
      RT_TRY(cudaStreamWaitEvent(cs, filled[cur], 0));   // consume chunk i
      RT_TRY(contract(slot[cur], i));
      RT_TRY(cudaEventRecord(freed[cur], cs));
    }
  }
  return static_cast<int>(
      kmv_reduce(wsf, static_cast<float*>(out), splits, (long long)r * c, cs));
}

// Xc: page-locked host buffer of rows_total rows of n elements (f32 (0) or
// bf16 (1)); idx (k,) int64 and out (k, n) on the device.  The kernel reads
// the host buffer through its mapped device address.  Returns the first
// CUDA error, or 0 (cudaErrorInvalidValue if Xc is not mapped host memory).
extern "C" int gather_rows_launch(const void* Xc, const void* idx, void* out,
                                  int k, int n, int rows_total, int dtype,
                                  void* stream) {
  using namespace rt;
  cudaPointerAttributes attr;
  RT_TRY(cudaPointerGetAttributes(&attr, Xc));
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t elt =
      dtype == DTYPE_BF16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t row_bytes = (size_t)n * elt;
  const long long* ix = static_cast<const long long*>(idx);
  const int threads = 256;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(attr.devicePointer) |
      reinterpret_cast<uintptr_t>(out) | row_bytes;
  if (align % sizeof(uint4) == 0) {               // 16-byte words
    gather_rows_kernel<uint4><<<k, threads, 0, st>>>(
        static_cast<const uint4*>(attr.devicePointer), ix,
        static_cast<uint4*>(out), (int)(row_bytes / sizeof(uint4)),
        rows_total);
  } else if (align % sizeof(unsigned) == 0) {
    gather_rows_kernel<unsigned><<<k, threads, 0, st>>>(
        static_cast<const unsigned*>(attr.devicePointer), ix,
        static_cast<unsigned*>(out), (int)(row_bytes / sizeof(unsigned)),
        rows_total);
  } else {
    gather_rows_kernel<unsigned short><<<k, threads, 0, st>>>(
        static_cast<const unsigned short*>(attr.devicePointer), ix,
        static_cast<unsigned short*>(out),
        (int)(row_bytes / sizeof(unsigned short)), rows_total);
  }
  return static_cast<int>(cudaGetLastError());
}

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
//
// The symmetric pipe (kmv_stream_sym_launch) is the full matvec K(A, A) X
// of every convergence check.  Run as nc pieces K(A, chunk_j)^T X, it
// would stream all of A nc times and compute every chunk pair twice, as
// K is symmetric.  Instead it keeps an anchor chunk i on the device in a
// third slot while chunks j > i stream through the two others, and
// computes each pair (i, j) once, its tiles serving their mirrors
// (kmv_partial.cuh, pairs): half the FMAs of the pieces.  Chunks j stream
// in descending order, so the last of anchor i's pass is chunk i + 1, the
// next anchor, which stays where it is: 1 + nc (nc - 1) / 2 chunk copies
// (46 at nc = 10), against nc (nc + 1) / 2 if every anchor were copied
// and nc^2 + nc as pieces.  Each anchor's diagonal pair shares a launch
// with its first off-diagonal pair, so its half-wave of tiles fills out.
// Every copy waits for the last read of its slot and every launch for
// the copies of its slots, through events, as above.
//
// The streamed apply_at (kmv_stream_apply_launch) is the guarded rounds'
// residual update K(A, A[idx]) w: the two-slot pipe again, each chunk's
// rows of the output contracted while the chunk sits in its slot (the
// resident KMV tile with its operands swapped), so a round streams A once,
// as the unguarded round's KMV does.  f64 data (the guarded fits' last
// fallback rung) takes the same pipes with f64_tile.cuh's contraction.
#include <algorithm>
#include <cassert>
#include <cstdint>
#include <vector>

#include "f64_tile.cuh"
#include "kmv_partial.cuh"

#define RT_RET(expr)                                    \
  do {                                                  \
    const cudaError_t rt_err_ = (expr);                 \
    if (rt_err_ != cudaSuccess) return rt_err_;         \
  } while (0)

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

template <int N>
struct Events {                       // destroyed on every return path
  cudaEvent_t e[N] = {};
  ~Events() {
    for (cudaEvent_t x : e)
      if (x) cudaEventDestroy(x);     // safe while still pending
  }
};

// The symmetric pipe for element type T (kmv_stream_sym_launch).
template <typename T>
int stream_sym(const char* src, char* slots, const float* Xv,
                       float* ws, float* out, int nc, int cr, int n, int c,
                       int m, bool resident, int drop, const KernelParams& p,
                       cudaStream_t cs, cudaStream_t ps) {
  constexpr int BM = KMV_PAIR_BM;
  const size_t chunk_bytes = (size_t)cr * n * sizeof(T);
  const int tpc = (cr + BM - 1) / BM;               // tiles a chunk
  const long long stride = (long long)m * c;        // floats a slot
  float* bn = ws + 2 * tpc * stride;                // |a_i|^2, (nc * cr)
  auto rows = [&](int k) { return std::min(cr, m - k * cr); };
  auto tiles = [&](int k) { return (rows(k) + BM - 1) / BM; };
  const char* base = resident ? src : slots;
  const int vec = n % KMV_VEC == 0 &&
                  reinterpret_cast<uintptr_t>(base) % (KMV_VEC * sizeof(T)) ==
                      0;
  if (drop != 0 && nc < 2) return static_cast<int>(cudaErrorInvalidValue);

  // The schedule: anchor i's pass is steps (i, j) for j = nc - 1 down to
  // i + 1, its diagonal in the first (or alone, for the last anchor).
  // Slots: the anchor's, and two that take the streamed chunks in turn;
  // after the pass the slot holding chunk i + 1 becomes the anchor's, and
  // the other two, the one freed first leading, the streaming pair.
  struct Step { int a, aslot, b, bslot, diag; };
  struct Load { int chunk, slot, after; };   // after: its slot's last read
  std::vector<Step> steps;
  std::vector<Load> loads{{0, 0, -1}};
  int as = 0, ss[2] = {1, 2}, last[3] = {-1, -1, -1};
  for (int i = 0; i < nc; ++i) {
    const int L = nc - 1 - i;
    if (L == 0) steps.push_back({i, as, -1, -1, 1});
    for (int q = 0; q < L; ++q) {
      const int j = nc - 1 - q, slot = ss[q & 1];
      loads.push_back({j, slot, last[slot]});
      last[as] = last[slot] = (int)steps.size();
      steps.push_back({i, as, j, slot, q == 0});
    }
    if (L > 0) {
      const int old = as;
      as = ss[(L - 1) & 1];
      ss[0] = ss[L & 1];
      ss[1] = old;
    }
  }

  auto at = [&](int chunk, int slot) -> const T* {
    return reinterpret_cast<const T*>(
        resident ? src + (size_t)chunk * chunk_bytes
                 : slots + (size_t)slot * chunk_bytes);
  };
  auto pair_of = [&](int a, const T* A, int b, const T* B) {
    KmvPairSeg s{};
    s.A = A;
    s.B = B;
    s.bn = bn + (size_t)b * cr;
    s.xa = Xv + (size_t)a * cr * c;
    s.xb = Xv + (size_t)b * cr * c;
    s.wb = ws + (size_t)b * cr * c;
    s.wa = ws + (a == b ? 0 : tpc * stride) + (size_t)a * cr * c;
    s.rows_a = rows(a);
    s.rows_b = rows(b);
    s.tiles_a = tiles(a);
    s.tiles_b = tiles(b);
    s.upper = a == b;
    s.blocks = a == b ? s.tiles_a * (s.tiles_a + 1) / 2
                      : s.tiles_a * s.tiles_b;
    if ((drop == 1 && a == 0 && b == 1) || (drop == 2 && a == 0 &&
                                            b == nc - 1)) {
      s.xb = nullptr;                   // the mirror's product left out
      if (drop == 2) s.xa = nullptr;    // and the pair's
    }
    return s;
  };

  RT_TRY(cudaMemsetAsync(ws, 0, sizeof(float) * 2 * tpc * stride, cs));
  Events<7> ev;
  if (!resident) {
    for (cudaEvent_t& e : ev.e)
      RT_TRY(cudaEventCreateWithFlags(&e, cudaEventDisableTiming));
    RT_TRY(cudaEventRecord(ev.e[0], cs));   // the slots were allocated on cs
    RT_TRY(cudaStreamWaitEvent(ps, ev.e[0], 0));
  }
  const cudaEvent_t* filled = ev.e + 1;     // a slot's copy has landed
  const cudaEvent_t* freed = ev.e + 4;      // a slot's last read is done
  size_t next = 0;
  for (int t = 0; t < (int)steps.size(); ++t) {
    const Step& st = steps[t];
    if (!resident) {
      // every copy whose slot has been read for the last time is queued
      // before step t, so the copy engine runs ahead of the contractions
      for (; next < loads.size() && loads[next].after < t; ++next) {
        const Load& l = loads[next];
        if (l.after >= 0) RT_TRY(cudaStreamWaitEvent(ps, freed[l.slot], 0));
        RT_TRY(cudaMemcpyAsync(slots + (size_t)l.slot * chunk_bytes,
                               src + (size_t)l.chunk * chunk_bytes,
                               chunk_bytes, cudaMemcpyHostToDevice, ps));
        RT_TRY(cudaEventRecord(filled[l.slot], ps));
      }
      RT_TRY(cudaStreamWaitEvent(cs, filled[st.aslot], 0));
      if (st.b >= 0) RT_TRY(cudaStreamWaitEvent(cs, filled[st.bslot], 0));
    }
    const T* A = at(st.a, st.aslot);
    const T* B = st.b >= 0 ? at(st.b, st.bslot) : nullptr;
    if (p.kind == KERNEL_RBF && st.a == 0) {  // anchor 0's pass sees every
      if (t == 0)                              // chunk: the norms, once
        RT_TRY(kmv_bnorms<T>(A, bn, rows(0), n, cs));
      if (B) RT_TRY(kmv_bnorms<T>(B, bn + (size_t)st.b * cr, rows(st.b), n,
                                  cs));
    }
    KmvPairSeg seg[2] = {};
    int k = 0;
    if (st.diag) seg[k++] = pair_of(st.a, A, st.a, A);
    if (B) seg[k++] = pair_of(st.a, A, st.b, B);
    RT_TRY(launch_kmv_pair<T>(seg[0], seg[1], stride, n, c, vec, p, cs));
    if (!resident) {
      RT_TRY(cudaEventRecord(freed[st.aslot], cs));
      if (B) RT_TRY(cudaEventRecord(freed[st.bslot], cs));
    }
  }
  return static_cast<int>(kmv_reduce(ws, out, 2 * tpc, stride, cs));
}

}  // namespace rt

namespace rt {

// The two-slot pipe of a streamed pass (the module comment): chunk i + 1 is
// copied into one slot on the copy stream ps while `consume(slot, i)`
// queues chunk i's work on the compute stream cs; with `resident`, src is
// already on the device and consume reads it in place.
template <typename Consume>
cudaError_t pipe(const char* src, char* slot0, char* slot1, int nc,
                 size_t chunk_bytes, bool resident, cudaStream_t cs,
                 cudaStream_t ps, Consume consume) {
  if (resident) {
    for (int i = 0; i < nc; ++i)
      RT_RET(consume(src + (size_t)i * chunk_bytes, i));
    return cudaSuccess;
  }
  char* slot[2] = {slot0, slot1};
  Events<5> ev;
  for (cudaEvent_t& e : ev.e)
    RT_RET(cudaEventCreateWithFlags(&e, cudaEventDisableTiming));
  cudaEvent_t ready = ev.e[0];
  cudaEvent_t filled[2] = {ev.e[1], ev.e[2]};
  cudaEvent_t freed[2] = {ev.e[3], ev.e[4]};
  RT_RET(cudaEventRecord(ready, cs));
  RT_RET(cudaStreamWaitEvent(ps, ready, 0));
  RT_RET(cudaMemcpyAsync(slot[0], src, chunk_bytes, cudaMemcpyHostToDevice,
                         ps));
  RT_RET(cudaEventRecord(filled[0], ps));
  for (int i = 0; i < nc; ++i) {
    const int cur = i & 1, nxt = cur ^ 1;
    if (i + 1 < nc) {              // prefetch chunk i+1 into the other slot
      if (i >= 1) RT_RET(cudaStreamWaitEvent(ps, freed[nxt], 0));
      RT_RET(cudaMemcpyAsync(slot[nxt], src + (size_t)(i + 1) * chunk_bytes,
                             chunk_bytes, cudaMemcpyHostToDevice, ps));
      RT_RET(cudaEventRecord(filled[nxt], ps));
    }
    RT_RET(cudaStreamWaitEvent(cs, filled[cur], 0));   // consume chunk i
    RT_RET(consume(slot[cur], i));
    RT_RET(cudaEventRecord(freed[cur], cs));
  }
  return cudaSuccess;
}

inline size_t elt_bytes(int dtype) {
  return dtype == DTYPE_F64 ? sizeof(double)
                            : (dtype == DTYPE_BF16 ? sizeof(__nv_bfloat16)
                                                   : sizeof(float));
}

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
  RT_TRY(pipe(static_cast<const char*>(Xc), static_cast<char*>(slot0),
              static_cast<char*>(slot1), nc, (size_t)cr * n * elt_bytes(dtype),
              resident != 0, cs, ps, contract));
  return static_cast<int>(
      kmv_reduce(wsf, static_cast<float*>(out), splits, (long long)r * c, cs));
}

// The f64 route of kmv_stream_launch (f64_tile.cuh): Xc (nc, cr, n) f64,
// B (r, n) f64, Xv (nc * cr, c) f64, ws (splits * r * c doubles), out (r,
// c) f64; the plan (kernels/kmv.kmv_f64_plan for cr rows) splits each
// chunk's rows.  Returns the first CUDA error, or 0.
extern "C" int kmv_stream_f64_launch(const void* Xc, void* slot0,
                                     void* slot1, const void* B,
                                     const void* Xv, void* ws, void* out,
                                     int nc, int cr, int n, int r, int c,
                                     int m, int splits, int rows_per_split,
                                     int kind, int degree, double coef0,
                                     double sigma, void* compute_stream,
                                     void* copy_stream) {
  using namespace rt;
  const KernelParamsF64 p{kind, degree, coef0, sigma};
  cudaStream_t cs = static_cast<cudaStream_t>(compute_stream);
  cudaStream_t ps = static_cast<cudaStream_t>(copy_stream);
  double* w = static_cast<double*>(ws);
  auto contract = [&](const void* A, int i) {
    const double* X = static_cast<const double*>(Xv) + (size_t)i * cr * c;
    return kmv_f64_partial(static_cast<const double*>(A),
                           static_cast<const double*>(B), X, w,
                           std::min(cr, m - i * cr), r, n, c, splits,
                           rows_per_split, i > 0, p, cs);
  };
  RT_TRY(pipe(static_cast<const char*>(Xc), static_cast<char*>(slot0),
              static_cast<char*>(slot1), nc, (size_t)cr * n * sizeof(double),
              false, cs, ps, contract));
  return static_cast<int>(
      kmv_f64_reduce(w, static_cast<double*>(out), splits, (long long)r * c,
                     cs));
}

// The streamed apply_at, out = K(A, Bs) W for the A of Xc (nc, cr, n): the
// guarded rounds' residual update K[:, idx] w, Bs = A[idx] (sb, n) on the
// device.  K(A_i, Bs) W = K(Bs, A_i)^T W, so while chunk i sits in its slot
// the resident KMV contraction runs with its operands swapped (kmv_partial
// over the sb rows of Bs against the chunk's true rows as the output axis,
// plan kernels/kmv_stream.apply_launch's), and its reduce writes the
// chunk's rows of out (nc * cr, c); the workspace's slices are as wide as
// the chunk's true rows, which the reduce reads with the same stride.
// dtype f32 (0) or bf16 (1) sums in f32 (W (sb, c) f32, ws splits * cr *
// c + cr floats, out f32).  Returns the first CUDA error, or 0.
extern "C" int kmv_stream_apply_launch(const void* Xc, void* slot0,
                                       void* slot1, const void* Bs,
                                       const void* W, void* ws, void* out,
                                       int nc, int cr, int n, int sb, int c,
                                       int m, int regime, int bm, int br,
                                       int splits, int rows_per_split,
                                       int dtype, int kind, int degree,
                                       float coef0, float sigma,
                                       void* compute_stream,
                                       void* copy_stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  cudaStream_t cs = static_cast<cudaStream_t>(compute_stream);
  cudaStream_t ps = static_cast<cudaStream_t>(copy_stream);
  float* wsf = static_cast<float*>(ws);
  float* bn = wsf + (size_t)splits * cr * c;
  const float* Wf = static_cast<const float*>(W);
  float* o = static_cast<float*>(out);
  const bool bf16 = dtype == DTYPE_BF16;
  auto contract = [&](const void* chunk, int i) {
    const int rows = std::min(cr, m - i * cr);   // the chunk's true rows
    cudaError_t err = cudaSuccess;
    if (kind == KERNEL_RBF)
      err = bf16 ? kmv_bnorms<__nv_bfloat16>(chunk, bn, rows, n, cs)
                 : kmv_bnorms<float>(chunk, bn, rows, n, cs);
    if (err == cudaSuccess)
      err = bf16 ? kmv_partial<__nv_bfloat16>(Bs, chunk, bn, Wf, wsf, sb,
                                              rows, n, c, regime, bm, br,
                                              splits, rows_per_split, 0, p,
                                              cs)
                 : kmv_partial<float>(Bs, chunk, bn, Wf, wsf, sb, rows, n, c,
                                      regime, bm, br, splits, rows_per_split,
                                      0, p, cs);
    if (err == cudaSuccess)
      err = kmv_reduce(wsf, o + (size_t)i * cr * c, splits,
                       (long long)rows * c, cs);
    return err;
  };
  RT_TRY(pipe(static_cast<const char*>(Xc), static_cast<char*>(slot0),
              static_cast<char*>(slot1), nc, (size_t)cr * n * elt_bytes(dtype),
              false, cs, ps, contract));
  return 0;
}

// The f64 route of kmv_stream_apply_launch (f64_tile.cuh): Xc, Bs, W and
// out f64, ws splits * cr * c doubles, the plan kernels/kmv.kmv_f64_plan(sb,
// cr, c).  Returns the first CUDA error, or 0.
extern "C" int kmv_stream_apply_f64_launch(
    const void* Xc, void* slot0, void* slot1, const void* Bs, const void* W,
    void* ws, void* out, int nc, int cr, int n, int sb, int c, int m,
    int splits, int rows_per_split, int kind, int degree, double coef0,
    double sigma, void* compute_stream, void* copy_stream) {
  using namespace rt;
  const KernelParamsF64 p{kind, degree, coef0, sigma};
  cudaStream_t cs = static_cast<cudaStream_t>(compute_stream);
  cudaStream_t ps = static_cast<cudaStream_t>(copy_stream);
  double* w = static_cast<double*>(ws);
  double* o = static_cast<double*>(out);
  auto contract = [&](const void* chunk, int i) {
    const int rows = std::min(cr, m - i * cr);
    cudaError_t err = kmv_f64_partial(
        static_cast<const double*>(Bs), static_cast<const double*>(chunk),
        static_cast<const double*>(W), w, sb, rows, n, c, splits,
        rows_per_split, 0, p, cs);
    if (err == cudaSuccess)
      err = kmv_f64_reduce(w, o + (size_t)i * cr * c, splits,
                           (long long)rows * c, cs);
    return err;
  };
  RT_TRY(pipe(static_cast<const char*>(Xc), static_cast<char*>(slot0),
              static_cast<char*>(slot1), nc, (size_t)cr * n * sizeof(double),
              false, cs, ps, contract));
  return 0;
}

// out = K(A, A) X, (m, c) f32, for the A of Xc (nc, cr, n) row-major, f32
// (0) or bf16 (1), in page-locked host memory with a zero-padded tail
// (rows at or past m masked), or, with resident != 0, device memory (the
// compute-only yardstick: no copies, the same launches).  slots: three
// (cr, n) device buffers of that dtype, one after the other (unused when
// resident); Xv (nc * cr, c) f32, ws (2 * ceil(cr / 128) * m * c + nc * cr
// floats: the slots of kmv_partial.cuh's pairs, then |a_i|^2) and out on
// the device.  drop, for the wrong variants a parity check must fail: 1
// leaves the mirror's product of pair (0, 1) out, 2 the whole pair (0,
// nc - 1); 0 computes the function.  Returns the first CUDA error, or 0.
extern "C" int kmv_stream_sym_launch(const void* Xc, void* slots,
                                     const void* Xv, void* ws, void* out,
                                     int nc, int cr, int n, int c, int m,
                                     int dtype, int resident, int drop,
                                     int kind, int degree, float coef0,
                                     float sigma, void* compute_stream,
                                     void* copy_stream) {
  using namespace rt;
  const KernelParams p{kind, degree, coef0, sigma};
  const char* src = static_cast<const char*>(Xc);
  char* sl = static_cast<char*>(slots);
  const float* X = static_cast<const float*>(Xv);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(compute_stream);
  cudaStream_t ps = static_cast<cudaStream_t>(copy_stream);
  return dtype == DTYPE_BF16
             ? stream_sym<__nv_bfloat16>(src, sl, X, w, o, nc, cr, n, c, m,
                                         resident != 0, drop, p, cs, ps)
             : stream_sym<float>(src, sl, X, w, o, nc, cr, n, c, m,
                                 resident != 0, drop, p, cs, ps);
}

// Xc: page-locked host buffer of rows_total rows of n elements (f32 (0),
// bf16 (1) or f64 (2)); idx (k,) int64 and out (k, n) on the device.  The kernel reads
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
  const size_t row_bytes = (size_t)n * elt_bytes(dtype);
  const long long* ix = static_cast<const long long*>(idx);
  const int threads = 256;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(attr.devicePointer) |
      reinterpret_cast<uintptr_t>(out) | row_bytes;
  if (align % sizeof(uint4) == 0) {               // 16-byte words
    rt::launch(gather_rows_kernel<uint4>, k, threads, 0, st,
        static_cast<const uint4*>(attr.devicePointer), ix,
        static_cast<uint4*>(out), (int)(row_bytes / sizeof(uint4)),
        rows_total);
  } else if (align % sizeof(unsigned) == 0) {
    rt::launch(gather_rows_kernel<unsigned>, k, threads, 0, st,
        static_cast<const unsigned*>(attr.devicePointer), ix,
        static_cast<unsigned*>(out), (int)(row_bytes / sizeof(unsigned)),
        rows_total);
  } else {
    rt::launch(gather_rows_kernel<unsigned short>, k, threads, 0, st,
        static_cast<const unsigned short*>(attr.devicePointer), ix,
        static_cast<unsigned short*>(out),
        (int)(row_bytes / sizeof(unsigned short)), rows_total);
  }
  return static_cast<int>(cudaGetLastError());
}

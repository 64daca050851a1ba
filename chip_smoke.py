#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: the quickest proof that the port builds and runs its main path.

    python3 chip_smoke.py [--seed 0] [--svm-iters 4096] [--krr-iters 2048]

Phases (each one fails the run with a non-zero exit):

  1. build    compile every csrc/*.cu (one nvcc each, in parallel)
  2. parity   KMV and gram kernels against their plain PyTorch versions
              at the main path's shapes, f32 and bf16
  3. K-SVM    KernelSVM(C=1, rbf) at the news20-like shape (m = 19996,
              n = 8192): s-step DCD (s = 32) and classical DCD on one
              schedule, the duality gap (one full KMV), prediction of
              2048 held-out queries through support-vector compaction
  4. K-RR     KernelRidge(lam=1, rbf), s-step BDCD (s = 8, b = 32) on
              the tolerance path, the relative-residual history, 2048
              predictions
  5. stream + Nystrom, on the same data
       a. the streamed KMV pipe (A chunked in pinned host memory) and
          the row gather against their plain versions and the resident
          KMV, f32 and bf16, vector and (m, 4) X, r = 32, 256 and the
          full-matvec piece r = chunk_rows, at chunk_rows = 2048 (ragged
          tail) and 6000 (four chunks)
       b. KernelRidge(stream=2048) replaying phase 4's schedule at full
          depth, its residual history from the streamed full KMV; its
          device-memory growth must stay below A's bytes
       c. KernelSVM(s=32, stream=2048) replaying phase 3's schedule at
          full depth with one streamed duality gap (a check only at the
          last round: the depth cut is in checks, not iterations), and
          2048 predictions through BatchedPredictor(stream=1024)
       d. KernelRidge(approx="nystrom", landmarks=1024, uniform): the
          factor product on 512 rows against the plain build (and what a
          TF32 build reads against the same tolerance), the kernel error
          on a 2048-row subsample
       e. pipelined, copy-only and compute-only times of the streamed
          KMV, the streamed full KMV against the resident one
  6. report   launch counts of phases 3-4, kernel times against their
              plain versions, bounds and library calls, the inner-phase
              share of a round, the card's name and power limit

The last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it is the ``{"kernels": [...]}`` record.  Without a CUDA
device, or without the port's sources beside this file, it exits
non-zero and prints no result.  TF32 is off throughout: the plain
versions and the kernels are compared in full f32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 outside the
# tensor cores, the rate the kernels' f32 FMAs run at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Host-to-device link of the streamed KMV: PCIe Gen5 x16, 128 GB/s both
# directions together in the H100 data sheet, so 64 GB/s one way (32 GT/s
# x 16 lanes, 128b/130b encoding: 63 GB/s of payload at best).
PCIE_H2D_BYTES_PER_S = 64e9

# Parity tolerances and their reasons.
TOL_KMV_F32 = 2e-4     # tests/test_kmv.py: f32 summation-order differences
TOL_GRAM_F32 = 1e-4    # tests/test_pallas_gram.py
TOL_BF16 = 2e-2        # bf16 inputs (both sides see the same bf16 values)
# s-step vs classical DCD on one schedule: each of the H = 4096 coordinate
# solves reads u^T alpha, an f32 sum over m ~ 2e4 terms of size up to
# ~1e2 (error ~1e-5), and the two methods round it differently; the
# difference compounds through the clipped updates, alpha in [0, C = 1].
TOL_SSTEP_VS_CLASSICAL = 1e-3
TOL_ORACLE = 1e-4      # facade predictions vs the dense oracle, relative
                       # to the largest decision value
# Rows per pinned chunk of the streamed phase: 64 MB of f32 at n = 8192,
# so ten chunks with a ragged tail at m = 19 996.
STREAM_CHUNK_ROWS = 2048
# Streamed vs resident metric histories on one schedule: the same f32
# full-KMV sums taken chunk by chunk in another order (~1e-6 relative).
TOL_STREAM_METRIC = 1e-4
# Nystrom factor product Phi Phi^T, kernels against the plain build, in
# units of f32 eps x kappa(K_LL) x max|Phi Phi^T|: the gram kernel and
# its plain version sum the same f32 products in another order, so their
# entries of K (at most 1 for rbf) agree within a few eps (phase 2 reads
# ~6.5 eps at 256 x 256), and K_LL^{-1/2} amplifies a relative error in
# K_LL by up to kappa.
TOL_NYSTROM_EPS_KAPPA = 8.0
F32_EPS = 2.0 ** -23


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def allclose_ratio(got, want, tol, magnitude_relative=False):
    """max |got - want| / (atol + tol |want|) — at most 1 passes.  atol is
    tol, or tol * max|want| where the tolerance is magnitude-relative
    (the polynomial kernel, ROADMAP C2)."""
    got, want = got.double(), want.double()
    atol = tol * max(1.0, float(want.abs().max())) if magnitude_relative \
        else tol
    err = (got - want).abs()
    return float((err / (atol + tol * want.abs())).max()), float(err.max())


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_split(kernel_phase, local_phase, rounds):
    """Mean host milliseconds of a round's kernel phase and local phase,
    synchronised after each."""
    import torch
    t_kernel = t_local = 0.0
    for k in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = kernel_phase(k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        local_phase(k, data)
        torch.cuda.synchronize()
        t_kernel += t1 - t0
        t_local += time.perf_counter() - t1
    return t_kernel / rounds * 1e3, t_local / rounds * 1e3


def stream_phase(c, args, failures):
    """Phase 5 (module docstring).  ``c`` holds phases 3-4's data and
    fits; returns the ``kmv_stream`` entry of the kernels record."""
    import torch
    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (BatchedPredictor, StreamingGramOperator,
                                  ksvm_predict, nystrom, pad_rounds,
                                  sstep_dcd_inner)
    from repro_torch.core.kernels import _chunk
    from repro_torch.kernels.gram import gram_cuda, gram_plain
    from repro_torch.kernels.kmv import kmv_cuda
    from repro_torch.kernels.kmv_stream import (gather_rows_cuda,
                                                kmv_stream_cuda,
                                                kmv_stream_plain,
                                                kmv_stream_resident)

    dev, m, n, rbf = c.dev, c.m, c.n, c.kernels["rbf"]
    CR = STREAM_CHUNK_ROWS
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- a. parity ---------------------------------------------------
    t0 = time.perf_counter()
    A_h = c.A.cpu()
    A_d = {f32: c.A, bf16: c.A.to(bf16)}
    Xc_of = {(dt, cr): _chunk(A_h.to(dt), cr, pin=True)
             for dt in (f32, bf16) for cr in (CR, 6000)}
    print(f"[stream] pinned chunks of A built in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{str(dt)[6:]} {cr} rows x {Xc.shape[0]}"
                      for (dt, cr), Xc in Xc_of.items()))
    err_at = {}
    t0 = time.perf_counter()
    cases = [(cfg_name, dt, cr, bname, xname)
             for dt in (f32, bf16) for cr in (CR, 6000)
             for bname in ("r32", "r256", "piece")
             for xname in ("vec", "mat4") for cfg_name in ("rbf",)]
    cases += [(k, f32, CR, "r256", "vec") for k in ("linear", "polynomial")]
    for kname, dt, cr, bname, xname in cases:
        cfg = c.kernels[kname]
        tol = TOL_KMV_F32 if dt == f32 else TOL_BF16
        Xc = Xc_of[(dt, cr)]
        B = (A_d[dt][:cr] if bname == "piece"
             else c.B_of[bname].to(dt)).contiguous()
        X = c.Xv if xname == "vec" else c.Xm
        Xvc = _chunk(X.reshape(m, -1), cr)
        got = kmv_stream_cuda(Xc, B, Xvc, cfg, m=m)
        want = kmv_stream_plain(Xc, B, Xvc, cfg, m=m)
        resident = kmv_cuda(A_d[dt], B, X, cfg).reshape(got.shape)
        poly = kname == "polynomial"
        for ref_name, ref in (("plain", want), ("resident kmv", resident)):
            ratio, err = allclose_ratio(got, ref, tol, poly)
            err_at[(kname, str(dt), cr, bname, xname, ref_name)] = err
            if not ratio <= 1.0 or got.shape != ref.shape:
                failures.append(f"kmv_stream {kname} {dt} cr={cr} {bname} "
                                f"{xname} vs {ref_name}: max abs err "
                                f"{err:.3e} ({ratio:.2f}x tolerance)")
    sel = torch.cat([c.pick[:256], c.pick[:7]])       # with repeats
    for dt in (f32, bf16):
        got = gather_rows_cuda(Xc_of[(dt, CR)], sel)
        if not torch.equal(got, A_d[dt][sel]):
            failures.append(f"gather_rows {dt}: rows differ")
    torch.cuda.synchronize()
    print(f"[stream] {len(err_at)} kmv_stream comparisons and 2 gathers in "
          f"{time.perf_counter() - t0:.1f} s; tolerances: f32 {TOL_KMV_F32}"
          f", bf16 {TOL_BF16}, polynomial relative to max |output|; gather "
          f"exact")
    for key in (("rbf", "torch.float32", CR, "r32", "vec", "plain"),
                ("rbf", "torch.float32", CR, "r32", "vec", "resident kmv"),
                ("rbf", "torch.float32", CR, "piece", "mat4", "plain"),
                ("rbf", "torch.float32", 6000, "r256", "vec",
                 "resident kmv"),
                ("rbf", "torch.bfloat16", CR, "r256", "mat4", "plain"),
                ("polynomial", "torch.float32", CR, "r256", "vec",
                 "plain")):
        print(f"[stream] parity {' '.join(map(str, key))}: max abs err "
              f"{err_at[key]:.3e}")
    del A_d[bf16]
    for key in [k for k in Xc_of if k != (f32, CR)]:
        del Xc_of[key]
    if failures:
        return None

    # ---- b-d. the streamed and Nystrom paths ------------------------------
    for fn in (kmv_cuda, gram_cuda, kmv_stream_cuda, gather_rows_cuda):
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    krr_s = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                        options=SolverOptions(
                            method="sstep", s=8, b=32, stream=CR,
                            record=True, check_every=16,
                            max_iters=args.krr_iters, seed=args.seed))
    r_ks = krr_s.fit(c.Ar.cpu(), c.yr, schedule=c.r_k.schedule)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    a_bytes = c.Ar.numel() * c.Ar.element_size()
    d_krr = float((r_ks.alpha - c.r_k.alpha).abs().max())
    h_s, h_r = r_ks.history, c.r_k.history
    d_hist = (float(abs(h_s - h_r).max() / abs(h_r).max())
              if h_s.shape == h_r.shape else float("inf"))
    print(f"[stream-krr] s=8 b=32 stream={CR}: {r_ks.iters_run} iters, "
          f"{r_ks.rounds_run} rounds, {len(h_s)} streamed residual checks,"
          f" {r_ks.wall_time_s:.2f} s (resident fit {c.r_k.wall_time_s:.2f}"
          f" s)")
    print(f"[stream-krr] max|a_stream - a_resident| = {d_krr:.3e} (bound "
          f"{TOL_SSTEP_VS_CLASSICAL}); residual history max rel diff "
          f"{d_hist:.3e} (bound {TOL_STREAM_METRIC}); last "
          f"{float(h_s[-1]):.4e}")
    print(f"[stream-krr] device memory growth during the fit: "
          f"{growth / 1e6:.1f} MB (A itself: {a_bytes / 1e6:.1f} MB)")
    if not d_krr <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"streamed vs resident K-RR alpha {d_krr:.3e}")
    if not d_hist <= TOL_STREAM_METRIC:
        failures.append(f"streamed vs resident K-RR residuals {d_hist:.3e}")
    if not growth < a_bytes:
        failures.append(f"the streamed K-RR fit grew device memory by "
                        f"{growth} bytes, not below A's {a_bytes}")

    rounds = -(-c.r_s.iters_run // 32)
    svm_s = KernelSVM(C=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(
                          method="sstep", s=32, stream=CR, record=True,
                          check_every=rounds, max_iters=args.svm_iters,
                          seed=args.seed))
    r_ss = svm_s.fit(c.A.cpu(), c.y, schedule=c.r_s.schedule)
    d_svm = float((r_ss.alpha - c.r_s.alpha).abs().max())
    gap_s = float(r_ss.history[-1])
    d_gap = abs(gap_s - c.gap) / max(1.0, abs(c.gap))
    t0 = time.perf_counter()
    pred = BatchedPredictor(svm_s.op_, svm_s.alpha_ * svm_s.y_, batch=1024,
                            compact=True, stream=1024)
    f_qs = pred(c.Aq.cpu())
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    f_ref = ksvm_predict(c.A, c.y, r_ss.alpha, c.Aq[:64], svm_s.cfg)
    ratio, err = allclose_ratio(f_qs[:64], f_ref, TOL_ORACLE, True)
    print(f"[stream-ksvm] s=32 stream={CR}: {r_ss.iters_run} iters, "
          f"{r_ss.rounds_run} rounds, {r_ss.wall_time_s:.2f} s (resident "
          f"{c.r_s.wall_time_s:.2f} s)")
    print(f"[stream-ksvm] max|a_stream - a_resident| = {d_svm:.3e}; "
          f"streamed duality gap {gap_s:.6e} vs resident {c.gap:.6e} "
          f"(rel diff {d_gap:.3e})")
    print(f"[stream-ksvm] predict {f_qs.shape[0]} host queries in chunks of"
          f" 1024 on {pred.op.n_samples} support vectors: "
          f"{t_pred * 1e3:.1f} ms; vs dense oracle max abs err {err:.3e}")
    if not d_svm <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"streamed vs resident K-SVM alpha {d_svm:.3e}")
    if not d_gap <= TOL_STREAM_METRIC:
        failures.append(f"streamed vs resident duality gap {d_gap:.3e}")
    if not (f_qs.shape == (c.q,) and bool(torch.isfinite(f_qs).all())
            and ratio <= 1.0):
        failures.append(f"streamed K-SVM predictions vs dense oracle "
                        f"{err:.3e}")

    nys = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(
                          method="sstep", s=8, b=32, approx="nystrom",
                          landmarks=1024, landmark_method="uniform",
                          tol=1e-4, check_every=16, max_iters=args.krr_iters,
                          seed=args.seed))
    r_n = nys.fit(c.Ar, c.yr)
    p_n = nys.predict(c.Arq)
    torch.cuda.synchronize()
    launches = {"kmv_stream": kmv_stream_cuda.launches,
                "gather_rows": gather_rows_cuda.launches,
                "gram": gram_cuda.launches, "kmv": kmv_cuda.launches}
    print(f"[stream path] launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    if min(launches.values()) < 1:
        failures.append(f"a kernel of the stream/Nystrom path was never "
                        f"launched: {launches}")

    # the factor product against the same build through the plain versions
    fmap, jitter = nys.op_.fmap, 1e-6
    L = fmap.landmarks
    sidx = c.pick[:512]
    A_s = c.Ar[sidx].contiguous()

    def plain_map():
        lam, V = torch.linalg.eigh(gram_plain(L, L, rbf))
        T = (V * torch.clamp(lam, min=jitter) ** -0.5) @ V.T
        return lam, T, gram_plain(A_s, L, rbf) @ T

    lam, T_p, Phi_p = plain_map()
    # a relative error d in K_LL moves K_LL^{-1} by up to kappa * d
    kappa = float(lam.max() / torch.clamp(lam.min(), min=jitter))
    tol_phi = TOL_NYSTROM_EPS_KAPPA * F32_EPS * kappa
    Phi_k = nys.op_.Phi[sidx]
    P_p = Phi_p @ Phi_p.T
    ratio, err = allclose_ratio(Phi_k @ Phi_k.T, P_p, tol_phi, True)
    # what a build with TF32 products would read against the same check
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Phi_t = plain_map()[2]
        P_t = Phi_t @ Phi_t.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratio_t, err_t = allclose_ratio(P_t, P_p, tol_phi, True)
    w_p = (gram_plain(c.Ar, L, rbf) @ T_p).T @ r_n.alpha
    f_ref = (gram_plain(c.Arq[:64].contiguous(), L, rbf) @ T_p) @ w_p
    ratio_f, err_f = allclose_ratio(p_n[:64], f_ref / nys.cfg.lam, tol_phi,
                                    True)
    k_err = nystrom.nystrom_kernel_error(c.Ar[:2048].contiguous(), L, rbf)
    hist = [float(v) for v in r_n.history]
    print(f"[nystrom] l=1024 uniform: {r_n.iters_run} iters, "
          f"{r_n.rounds_run} rounds, converged={r_n.converged}, "
          f"{r_n.wall_time_s:.2f} s; residual history "
          + " ".join(f"{v:.4e}" for v in hist))
    print(f"[nystrom] K_LL eigenvalues {float(lam.min()):.4e} .. "
          f"{float(lam.max()):.4e} (floor {jitter}), kappa {kappa:.1f}: "
          f"Phi Phi^T on 512 rows vs plain build max abs err {err:.3e} "
          f"({ratio:.3f} x tolerance {tol_phi:.2e} = "
          f"{TOL_NYSTROM_EPS_KAPPA:g} x f32 eps x kappa); a TF32 build "
          f"reads {err_t:.3e} ({ratio_t:.3f} x tolerance); predictions vs "
          f"plain map max abs err {err_f:.3e}")
    print(f"[nystrom] kernel error ||K - Phi Phi^T||_F / ||K||_F on 2048 "
          f"rows: {k_err:.4e}")
    if not ratio <= 1.0:
        failures.append(f"Nystrom factor product vs plain build {err:.3e}")
    if not (ratio_f <= 1.0 and p_n.shape == (c.q,)
            and bool(torch.isfinite(p_n).all())):
        failures.append(f"Nystrom predictions vs plain map {err_f:.3e}")
    if not (hist and all(v == v for v in hist) and hist[-1] < hist[0]):
        failures.append(f"Nystrom residual history does not fall: {hist}")
    if not 0.0 <= k_err < 1.0:
        failures.append(f"Nystrom kernel error {k_err}")
    if failures:
        return None

    # ---- e. pipelined, copy-only and compute-only times -------------------
    Xc = Xc_of[(f32, CR)]
    nc = Xc.shape[0]
    Xc_dev = Xc.to(dev)
    slots = torch.empty((2, CR, n), device=dev)

    def copy_only():                      # the library yardstick: the
        for i in range(nc):               # same chunks, one stream
            slots[i % 2].copy_(Xc[i], non_blocking=True)

    Xvc = _chunk(c.Xv[:, None], CR)
    x_bytes = Xc.numel() * Xc.element_size()       # copied, padded tail too
    a_bytes = m * n * Xc.element_size()            # what K(A,B)^T X must move
    copy_ms = time_cuda(copy_only, 10)
    rows = {}
    for label, B, iters in (("r32", c.B_of["r32"], 10),
                            ("r256", c.B_of["r256"], 5),
                            ("piece", c.A[:CR].contiguous(), 3)):
        r = B.shape[0]
        ms = time_cuda(lambda: kmv_stream_cuda(Xc, B, Xvc, rbf, m=m), iters)
        comp = time_cuda(lambda: kmv_stream_resident(Xc_dev, B, Xvc, rbf,
                                                     m=m), iters)
        plain = time_cuda(lambda: kmv_stream_plain(Xc, B, Xvc, rbf, m=m),
                          iters)
        flops = 2 * m * r * n + 2 * m * r + 2 * (m + r) * n + 6 * m * r
        t_link, t_ops = a_bytes / PCIE_H2D_BYTES_PER_S, flops / FP32_FLOP_PER_S
        b_ms = max(t_link, t_ops) * 1e3
        b_by = "bytes" if t_link >= t_ops else "operations"
        rows[label] = dict(ms=ms, copy=copy_ms, comp=comp, plain=plain,
                           bound=b_ms, by=b_by, r=r)
        print(f"[stream-time] kmv_stream rbf ({m}, {r}, {n}) c=1 in {nc} "
              f"chunks of {CR}: pipelined {ms:.4f} ms | copy-only "
              f"{copy_ms:.4f} ms ({x_bytes / copy_ms / 1e6:.1f} GB/s) | "
              f"compute-only {comp:.4f} ms | plain {plain:.4f} ms | bound "
              f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it) | overlap: "
              f"pipelined / max(copy, compute) = "
              f"{ms / max(copy_ms, comp):.3f}")
    for k in (32, 256):                   # the rows a round gathers
        g_ms = time_cuda(lambda: gather_rows_cuda(Xc, c.pick[:k]), 20)
        print(f"[stream-time] gather_rows of {k} sampled rows "
              f"({k * n * 4 / 1e6:.2f} MB read from the mapped host "
              f"buffer): {g_ms:.4f} ms")
    t0 = time.perf_counter()
    op = StreamingGramOperator.from_dense(c.A, rbf, CR, device=dev)
    t1 = time.perf_counter()
    op.scale_rows(c.y)
    t2 = time.perf_counter()
    print(f"[stream-time] streamed representation build, A (on the card "
          f"here) to pinned chunks: {(t1 - t0) * 1e3:.1f} ms; K-SVM "
          f"scale_rows on the host into new pinned chunks: "
          f"{(t2 - t1) * 1e3:.1f} ms")
    op_svm = svm_s.op_.scale_rows(c.y)
    idx_s, valid_s = pad_rounds(r_ss.schedule, 32)
    a_s, cfg_svm = r_ss.alpha, svm_s.cfg
    sk, sl = phase_split(
        lambda k: op_svm.round_data(idx_s[k], a_s),
        lambda k, d: sstep_dcd_inner(d[0], d[1], a_s[idx_s[k]], idx_s[k],
                                     cfg_svm.nu, cfg_svm.omega, 32,
                                     valid_s[k]), min(16, len(idx_s)))
    print(f"[rounds] streamed K-SVM s=32: kernel phase {sk:.3f} ms "
          f"(gather, gram, kmv_stream), local phase {sl:.3f} ms, local "
          f"share {sl / (sk + sl):.1%}")
    del op_svm
    full_s = time_cuda(lambda: op.full_matvec(c.Xv), 2, warmup=1)
    full_r = time_cuda(lambda: kmv_cuda(c.A, c.A, c.Xv, rbf), 2, warmup=1)
    full_c = time_cuda(lambda: [kmv_stream_resident(
        Xc_dev, Xc_dev[j], Xvc, rbf, m=m) for j in range(nc)], 1, warmup=0)
    full_copy = nc * copy_ms
    print(f"[stream-time] full K @ x ({m}^2 x {n}) streamed: {full_s:.1f} ms"
          f" | resident kmv {full_r:.1f} ms (streamed / resident "
          f"{full_s / full_r:.3f}) | copy-only {full_copy:.1f} ms + "
          f"compute-only {full_c:.1f} ms = {full_copy + full_c:.1f} ms")
    print(f"[stream-time] launches on the streamed fits: kmv_stream "
          f"{launches['kmv_stream']}, gather_rows {launches['gather_rows']}")
    if not full_s < full_copy + full_c:
        failures.append(f"the pipe does not overlap: streamed full KMV "
                        f"{full_s:.1f} ms >= copy-only {full_copy:.1f} + "
                        f"compute-only {full_c:.1f} ms")
    del Xc_dev, slots
    r32 = rows["r32"]
    return {"name": "kmv_stream", "route": "cuda",
            "source": "src/repro_torch/csrc/kmv_stream.cu",
            "replaces": "src/repro/kernels/kmv_stream.py:111",
            "shape": f"rbf (m, r, n, c) = ({m}, 32, {n}, 1) in {nc} pinned "
                     f"chunks of {CR}",
            "launches": launches["kmv_stream"],
            "max_abs_err": err_at[("rbf", "torch.float32", CR, "r32", "vec",
                                   "plain")],
            "ms": r32["ms"], "plain_ms": r32["plain"],
            "bound_ms": r32["bound"], "bound_by": r32["by"],
            "library_ms": None, "copy_only_ms": r32["copy"],
            "compute_only_ms": r32["comp"],
            "gather_rows_launches": launches["gather_rows"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--svm-iters", type=int, default=4096)
    ap.add_argument("--krr-iters", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available; this script runs only "
                    "on the card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"the port's sources are not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))

    from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
    from repro_torch.core import (ExactGramOperator, KernelConfig,
                                  krr_predict, ksvm_duality_gap,
                                  ksvm_predict, pad_rounds,
                                  sstep_bdcd_inner, sstep_dcd_inner)
    from repro_torch.data.synthetic import (PAPER_DATASETS,
                                            classification_dataset,
                                            regression_dataset)
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import gram_cuda, gram_plain
    from repro_torch.kernels.kmv import kmv_cuda, kmv_plain

    # full-f32 products everywhere the plain versions meet the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures = []
    print(f"device: {torch.cuda.get_device_name(0)}  torch "
          f"{torch.__version__}  cuda {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    info = build.build_all()
    for entry in build.SIGNATURES:
        build.launcher(entry)
    print(f"[build] {time.perf_counter() - t0:.1f} s total")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s -> {rec['path']}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # ---- data at the news20-like shape ------------------------------------
    spec = PAPER_DATASETS["news20-like"]
    m, n, q = spec["m"], spec["n"], 2048
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    A_all, y_all = classification_dataset(gen, m + q, n, device=dev)
    A, y = A_all[:m].contiguous(), y_all[:m].contiguous()
    Aq, yq = A_all[m:].contiguous(), y_all[m:].contiguous()
    del A_all, y_all
    print(f"[data] K-SVM: A {tuple(A.shape)} f32 "
          f"({A.numel() * 4 / 1e6:.0f} MB), {q} held-out queries")

    # ---- 2. kernel parity -------------------------------------------------
    kernels = {"linear": KernelConfig("linear"),
               "polynomial": KernelConfig("polynomial", degree=3,
                                          coef0=1.0),
               "rbf": KernelConfig("rbf", sigma=1.0)}
    pick = torch.randperm(m, generator=gen, device=dev)
    B_of = {"r32": A[pick[:32]].contiguous(),
            "r256": A[pick[:256]].contiguous(),
            "B=A": A, "q1024": Aq[:1024].contiguous()}
    Xv = torch.randn(m, generator=gen, device=dev)
    Xm = torch.randn((m, 4), generator=gen, device=dev)
    A16 = A.to(torch.bfloat16)
    err_at = {}
    t0 = time.perf_counter()
    for kname, cfg in kernels.items():
        poly = kname == "polynomial"
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL_KMV_F32 if dtype == torch.float32 else TOL_BF16
            Ad = A if dtype == torch.float32 else A16
            for bname, B in B_of.items():
                Bd = Ad if bname == "B=A" else B.to(dtype)
                for xname, X in (("vec", Xv), ("mat4", Xm)):
                    got = kmv_cuda(Ad, Bd, X, cfg)
                    want = kmv_plain(Ad, Bd, X, cfg)
                    ratio, err = allclose_ratio(got, want, tol, poly)
                    err_at[("kmv", kname, str(dtype), bname, xname)] = err
                    if not ratio <= 1.0 or got.shape != want.shape:
                        failures.append(
                            f"kmv {kname} {dtype} {bname} {xname}: max "
                            f"abs err {err:.3e} ({ratio:.2f}x tolerance)")
            tol = TOL_GRAM_F32 if dtype == torch.float32 else TOL_BF16
            for gname, (G1, G2) in {"256x256": (B_of["r256"], B_of["r256"]),
                                    "mx32": (A, B_of["r32"])}.items():
                G1d, G2d = G1.to(dtype), G2.to(dtype)
                got = gram_cuda(G1d, G2d, cfg)
                want = gram_plain(G1d, G2d, cfg)
                ratio, err = allclose_ratio(got, want, tol, poly)
                err_at[("gram", kname, str(dtype), gname)] = err
                if not ratio <= 1.0:
                    failures.append(f"gram {kname} {dtype} {gname}: max "
                                    f"abs err {err:.3e} ({ratio:.2f}x "
                                    f"tolerance)")
    torch.cuda.synchronize()
    del A16
    n_cmp = len(err_at)
    print(f"[parity] {n_cmp} comparisons in "
          f"{time.perf_counter() - t0:.1f} s; tolerances: KMV f32 "
          f"{TOL_KMV_F32}, gram f32 {TOL_GRAM_F32}, bf16 {TOL_BF16}, "
          f"polynomial relative to max |output|")
    for key in (("kmv", "rbf", "torch.float32", "r32", "vec"),
                ("kmv", "rbf", "torch.float32", "B=A", "vec"),
                ("kmv", "polynomial", "torch.float32", "B=A", "mat4"),
                ("kmv", "rbf", "torch.bfloat16", "q1024", "mat4"),
                ("gram", "rbf", "torch.float32", "256x256"),
                ("gram", "linear", "torch.float32", "mx32")):
        print(f"[parity] {' '.join(key)}: max abs err {err_at[key]:.3e}")
    if failures:
        for f in failures:
            print(f"[parity] FAIL {f}")
        return fail(f"{len(failures)} kernel parity failures")
    print("[parity] all kernels agree with their plain versions")

    # ---- 3. K-SVM main path -----------------------------------------------
    kmv_cuda.launches = 0
    gram_cuda.launches = 0
    svm_opts = dict(max_iters=args.svm_iters, seed=args.seed)
    svm = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="sstep", s=32, **svm_opts))
    r_s = svm.fit(A, y)
    dcd = KernelSVM(C=1.0, kernel="rbf", device=dev, options=SolverOptions(
        method="classical", **svm_opts))
    r_c = dcd.fit(A, y, schedule=r_s.schedule)
    agree = float((r_s.alpha - r_c.alpha).abs().max())
    gap = float(ksvm_duality_gap(A, y, r_s.alpha, svm.cfg))
    t0 = time.perf_counter()
    f_q = svm.decision_function(Aq)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    acc = float((torch.sign(f_q) == yq).float().mean())
    n_sv = svm._predictor.op.n_samples
    f_ref = ksvm_predict(A, y, r_s.alpha, Aq[:64], svm.cfg)
    ratio_svm, err_svm = allclose_ratio(f_q[:64], f_ref, TOL_ORACLE, True)
    svm_counts = (kmv_cuda.launches, gram_cuda.launches)
    print(f"[ksvm] s-step s=32: {r_s.iters_run} iters, {r_s.rounds_run} "
          f"rounds, {r_s.wall_time_s:.2f} s | classical: "
          f"{r_c.rounds_run} rounds, {r_c.wall_time_s:.2f} s")
    print(f"[ksvm] max|a_s - a_dcd| = {agree:.3e} (bound "
          f"{TOL_SSTEP_VS_CLASSICAL}) | duality gap {gap:.6e} | "
          f"nonzero alpha {int((r_s.alpha != 0).sum())}")
    print(f"[ksvm] predict {q} queries on {n_sv} support vectors: "
          f"{t_pred * 1e3:.1f} ms, accuracy {acc:.4f}; vs dense oracle "
          f"max abs err {err_svm:.3e}")
    print(f"[ksvm] launches: kmv {svm_counts[0]}, gram {svm_counts[1]}")
    if not agree <= TOL_SSTEP_VS_CLASSICAL:
        failures.append(f"s-step vs classical {agree:.3e}")
    if not (torch.isfinite(r_s.alpha).all() and
            float(r_s.alpha.min()) >= 0.0 and
            float(r_s.alpha.max()) <= 1.0 + 1e-6):
        failures.append("K-SVM alpha outside [0, C]")
    if not (f_q.shape == (q,) and bool(torch.isfinite(f_q).all())):
        failures.append("K-SVM decision values not finite")
    if not ratio_svm <= 1.0:
        failures.append(f"K-SVM predictions vs dense oracle {err_svm:.3e}")
    if not (gap == gap and abs(gap) < float("inf")):
        failures.append("K-SVM duality gap not finite")

    # ---- 4. K-RR main path ------------------------------------------------
    R_all, t_all = regression_dataset(gen, m + q, n, device=dev)
    Ar, yr = R_all[:m].contiguous(), t_all[:m].contiguous()
    Arq, yrq = R_all[m:].contiguous(), t_all[m:].contiguous()
    del R_all, t_all
    krr = KernelRidge(lam=1.0, kernel="rbf", device=dev,
                      options=SolverOptions(method="sstep", s=8, b=32,
                                            tol=1e-4, check_every=16,
                                            max_iters=args.krr_iters,
                                            seed=args.seed))
    r_k = krr.fit(Ar, yr)
    t0 = time.perf_counter()
    p_q = krr.predict(Arq)
    torch.cuda.synchronize()
    t_pred_k = time.perf_counter() - t0
    p_ref = krr_predict(Ar, r_k.alpha, Arq[:64], krr.cfg)
    ratio_krr, err_krr = allclose_ratio(p_q[:64], p_ref, TOL_ORACLE, True)
    rmse = float(((p_q - yrq) ** 2).mean().sqrt())
    hist = [float(v) for v in r_k.history]
    counts = (kmv_cuda.launches, gram_cuda.launches)   # the main path's
    print(f"[krr] s-step s=8 b=32: {r_k.iters_run} iters, "
          f"{r_k.rounds_run} rounds, converged={r_k.converged}, "
          f"{r_k.wall_time_s:.2f} s")
    print(f"[krr] rel residual history: "
          + " ".join(f"{v:.4e}" for v in hist))
    print(f"[krr] predict {q} queries: {t_pred_k * 1e3:.1f} ms, rmse "
          f"{rmse:.4f} (target std {float(yrq.std()):.4f}); vs dense "
          f"oracle max abs err {err_krr:.3e}")
    print(f"[krr] launches: kmv {counts[0] - svm_counts[0]}, gram "
          f"{counts[1] - svm_counts[1]}")
    if not (hist and all(v == v and v < float("inf") for v in hist)
            and hist[-1] < hist[0]):
        failures.append(f"K-RR residual history does not fall: {hist}")
    if not (p_q.shape == (q,) and bool(torch.isfinite(p_q).all())):
        failures.append("K-RR predictions not finite")
    if not ratio_krr <= 1.0:
        failures.append(f"K-RR predictions vs dense oracle {err_krr:.3e}")

    print(f"[main path] launches: kmv {counts[0]}, gram {counts[1]}")
    if counts[0] < 1 or counts[1] < 1:
        failures.append(f"a kernel was never launched on the main path "
                        f"(kmv {counts[0]}, gram {counts[1]})")
    if failures:
        for f in failures:
            print(f"[check] FAIL {f}")
        return fail(f"{len(failures)} main-path check(s) failed")

    # ---- 5. stream and Nystrom --------------------------------------------
    stream_entry = stream_phase(SimpleNamespace(
        dev=dev, m=m, n=n, q=q, kernels=kernels, A=A, y=y, Aq=Aq,
        B_of=B_of, pick=pick, Xv=Xv, Xm=Xm, r_s=r_s, gap=gap, Ar=Ar, yr=yr,
        Arq=Arq, r_k=r_k), args, failures)
    if failures:
        for f in failures:
            print(f"[stream] FAIL {f}")
        return fail(f"{len(failures)} stream/Nystrom check(s) failed")

    # ---- 6. counts, times, bounds -----------------------------------------

    rbf, lin = kernels["rbf"], kernels["linear"]
    rows = []

    def kmv_row(label, B, c, iters):
        X = Xv if c == 1 else Xm
        r = B.shape[0]
        ms = time_cuda(lambda: kmv_cuda(A, B, X, rbf), iters)
        plain = time_cuda(lambda: kmv_plain(A, B, X, rbf), iters)
        nbytes = 4 * (m * n + r * n + m * c + r * c)
        flops = 2 * m * r * n + 2 * m * r * c + 2 * (m + r) * n + 6 * m * r
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(("kmv", label, ms, plain, b_ms, b_by, None))
        return ms, plain, b_ms, b_by

    def gram_row(label, G1, G2, cfg, iters, library):
        r1, r2 = G1.shape[0], G2.shape[0]
        ms = time_cuda(lambda: gram_cuda(G1, G2, cfg), iters)
        plain = time_cuda(lambda: gram_plain(G1, G2, cfg), iters)
        lib = (time_cuda(lambda: torch.mm(G1, G2.T), iters) if library
               else None)
        nbytes = 4 * ((r1 + r2) * n + r1 * r2)
        flops = 2 * r1 * r2 * n + (2 * (r1 + r2) * n + 6 * r1 * r2
                                   if cfg.name == "rbf" else 0)
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(("gram", label, ms, plain, b_ms, b_by, lib))
        return ms, plain, b_ms, b_by, lib

    k32 = kmv_row(f"rbf ({m}, 32, {n}) c=1 [K-SVM round]", B_of["r32"],
                  1, 20)
    kmv_row(f"rbf ({m}, 1, {n}) c=1 [classical DCD round]",
            B_of["r32"][:1].contiguous(), 1, 20)
    kmv_row(f"rbf ({m}, 256, {n}) c=1 [K-RR round]", B_of["r256"], 1, 10)
    kmv_row(f"rbf ({m}, 1024, {n}) c=1 [prediction block]",
            B_of["q1024"], 1, 5)
    kmv_row(f"rbf ({m}, {m}, {n}) c=1 [full matvec]", A, 1, 2)
    g256 = gram_row(f"rbf (256, 256, {n}) [K-RR cross block]",
                    B_of["r256"], B_of["r256"], rbf, 50, False)
    gram_row(f"rbf (32, 32, {n}) [K-SVM cross block]", B_of["r32"],
             B_of["r32"], rbf, 50, False)
    gram_row(f"rbf ({m}, 32, {n}) [slab_free=False slab]", A, B_of["r32"],
             rbf, 10, False)
    gram_row(f"linear (256, 256, {n}) vs torch.mm", B_of["r256"],
             B_of["r256"], lin, 50, True)
    gram_row(f"linear ({m}, 32, {n}) vs torch.mm", A, B_of["r32"], lin,
             10, True)
    for kind, label, ms, plain, b_ms, b_by, lib in rows:
        lib_s = f"{lib:.4f} ms" if lib is not None else "none"
        print(f"[time] {kind} {label}: {ms:.4f} ms | plain {plain:.4f} ms "
              f"| bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it) | "
              f"library {lib_s}")

    # inner (local) phase share of an s-step round, synchronised per phase
    op_svm = ExactGramOperator(A, rbf).scale_rows(y)
    idx_s, valid_s = pad_rounds(r_s.schedule, 32)
    a_s = r_s.alpha
    cfg_svm = svm.cfg
    sk, sl = phase_split(
        lambda k: op_svm.round_data(idx_s[k], a_s),
        lambda k, d: sstep_dcd_inner(d[0], d[1], a_s[idx_s[k]], idx_s[k],
                                     cfg_svm.nu, cfg_svm.omega, 32,
                                     valid_s[k]), 16)
    op_krr = ExactGramOperator(Ar, rbf)
    idx_k, valid_k = pad_rounds(r_k.schedule, 8)
    a_k = r_k.alpha
    kk, kl = phase_split(
        lambda k: op_krr.round_data(idx_k[k].reshape(-1), a_k),
        lambda k, d: sstep_bdcd_inner(d[0], d[1], a_k[idx_k[k]],
                                      yr[idx_k[k]], idx_k[k].reshape(-1), m,
                                      1.0, 8, 32, valid_k[k]), 16)
    print(f"[rounds] K-SVM s=32: kernel phase {sk:.3f} ms, local phase "
          f"{sl:.3f} ms, local share {sl / (sk + sl):.1%}")
    print(f"[rounds] K-RR s=8 b=32: kernel phase {kk:.3f} ms, local phase "
          f"{kl:.3f} ms, local share {kl / (kk + kl):.1%}")

    if failures:
        for f in failures:
            print(f"[check] FAIL {f}")
        return fail(f"{len(failures)} main-path check(s) failed")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])                            # the card's name, power limit
    record = {"kernels": [
        {"name": "kmv", "route": "cuda", "source":
            "src/repro_torch/csrc/kmv.cu",
         "replaces": "src/repro/kernels/kmv.py:93",
         "shape": f"rbf (m, r, n, c) = ({m}, 32, {n}, 1)",
         "launches": counts[0],
         "max_abs_err": err_at[("kmv", "rbf", "torch.float32", "r32",
                                "vec")],
         "ms": k32[0], "plain_ms": k32[1], "bound_ms": k32[2],
         "bound_by": k32[3], "library_ms": None},
        {"name": "gram", "route": "cuda", "source":
            "src/repro_torch/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:82",
         "shape": f"rbf (m, r, n) = (256, 256, {n})",
         "launches": counts[1],
         "max_abs_err": err_at[("gram", "rbf", "torch.float32",
                                "256x256")],
         "ms": g256[0], "plain_ms": g256[1], "bound_ms": g256[2],
         "bound_by": g256[3], "library_ms": g256[4]},
        stream_entry,
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

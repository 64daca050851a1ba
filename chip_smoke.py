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
  5. report   launch counts of phases 3-4, kernel times against their
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and FP32 outside the
# tensor cores, the rate the kernels' f32 FMAs run at.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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
    build.launcher("kmv"), build.launcher("gram")
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

    # ---- 5. counts, times, bounds -----------------------------------------
    print(f"[main path] launches: kmv {counts[0]}, gram {counts[1]}")
    if counts[0] < 1 or counts[1] < 1:
        failures.append(f"a kernel was never launched on the main path "
                        f"(kmv {counts[0]}, gram {counts[1]})")

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
    def phase_split(kernel_phase, local_phase, rounds):
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
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

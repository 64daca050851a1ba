"""End-to-end kernel-method driver on the ``repro_torch.api`` facade —
the counterpart of ``repro/launch/solve.py``; runs on the CUDA card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.solve --problem ksvm \
        --dataset duke --s 32 --H 2048
    PYTHONPATH=src python -m repro_torch.launch.solve --problem krr \
        --dataset abalone --b 64 --s 16 --H 1024 --tol 1e-4

Solves K-SVM (DCD / s-step DCD) or K-RR (BDCD / s-step BDCD) on a
synthetic dataset at the paper's Table 2 scales and reports the duality
gap / relative error, training accuracy and the classical-vs-s-step
agreement (both fits replay one schedule).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import KernelRidge, KernelSVM, SolverOptions
from repro_torch.core import (KernelConfig, krr_closed_form,
                              ksvm_duality_gap, relative_solution_error)
from repro_torch.data import synthetic
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=("ksvm", "krr"), default="ksvm")
    ap.add_argument("--dataset", default="duke",
                    choices=list(synthetic.PAPER_DATASETS))
    ap.add_argument("--kernel", default="rbf",
                    choices=("linear", "polynomial", "rbf"))
    ap.add_argument("--loss", default="l1", choices=("l1", "l2"))
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--H", type=int, default=1024)
    ap.add_argument("--s", type=int, default=32)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--tol", type=float, default=0.0,
                    help="early-stop tolerance (0 = run the full budget)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    kern = KernelConfig(args.kernel, degree=3, coef0=0.0, sigma=1.0)
    A, y = synthetic.load(args.dataset,
                          torch.Generator().manual_seed(args.seed),
                          device=device)
    m = A.shape[0]
    print(f"{args.problem} on {args.dataset}: m={m} n={A.shape[1]} "
          f"kernel={args.kernel} H={args.H} s={args.s} tol={args.tol} "
          f"device={device}")

    def opts(method, s=1):
        return SolverOptions(method=method, s=s, b=max(args.b, 1),
                             tol=args.tol, max_iters=args.H,
                             seed=args.seed + 1)

    if args.problem == "ksvm":
        est = KernelSVM(C=args.C, loss=args.loss, kernel=kern,
                        options=opts("sstep", args.s), device=device)
        r_s = est.fit(A, y)
        ref = KernelSVM(C=args.C, loss=args.loss, kernel=kern,
                        options=opts("classical"), device=device)
        r_ref = ref.fit(A, y, schedule=r_s.schedule)
        gap = float(ksvm_duality_gap(A, y, r_s.alpha, est.cfg))
        acc = float((est.predict(A) == y).float().mean())
        print(f"DCD {r_ref.wall_time_s:.2f}s | s-step "
              f"{r_s.wall_time_s:.2f}s")
        print(f"duality gap {gap:.3e} | train acc {acc:.3f} | "
              f"max|a_s - a_dcd| = "
              f"{float((r_s.alpha - r_ref.alpha).abs().max()):.3e}")
    else:
        reg = KernelRidge(lam=args.lam, kernel=kern,
                          options=opts("sstep", args.s), device=device)
        r_s = reg.fit(A, y)
        reg_ref = KernelRidge(lam=args.lam, kernel=kern,
                              options=opts("classical"), device=device)
        r_ref = reg_ref.fit(A, y, schedule=r_s.schedule)
        astar = krr_closed_form(A, y, reg.cfg)
        print(f"BDCD {r_ref.wall_time_s:.2f}s | s-step "
              f"{r_s.wall_time_s:.2f}s")
        print(f"rel err vs closed form: bdcd="
              f"{float(relative_solution_error(r_ref.alpha, astar)):.3e} "
              f"sstep={float(relative_solution_error(r_s.alpha, astar)):.3e}")

    for name, r in (("classical", r_ref), ("sstep", r_s)):
        stop = (f"converged@{r.iters_run}" if r.converged
                else f"budget({r.iters_run})")
        print(f"{name:9s}: {stop} rounds={r.rounds_run}")


if __name__ == "__main__":
    main()

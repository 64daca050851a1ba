"""A short call of the KMV and RMSNorm kernels on the card: build them,
show the compiler's register and spill report, hold KMV against its plain
version at the solver path's full width (m = 19 996, n = 8192) in every
regime of ``kmv_plan``, with a second call's bits and the kernel with its
last m split left out, and the streamed full matvec (the symmetric
``kmv_stream`` pipe over 2048-row pinned chunks) against its plain pair
loop, with its wrong variants; then time KMV, RMSNorm and the streamed
full matvec (``StreamingGramOperator.full_matvec``) at the main path's
shapes.

    PYTHONPATH=src python -m repro_torch.launch.kmv_probe [--src DIR ...]

Each ``--src`` names another checkout's ``src`` directory (a parent commit
unpacked under the git-ignored ``build/``): its kernels are timed at the
same shapes in the same call, in the order given, so two versions are
compared on one card.  Each stage runs in a child process with a time
limit; the exit code is non-zero if a stage failed.  Needs a CUDA card;
``chip_smoke.py`` is the full check of the same kernels on their paths.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
STAGE_SECONDS = 300
M, N = 19996, 8192
# (label, r) of the main path's KMV shapes, c = 1; the full matvec's B is
# A (the symmetric plan), and a copy of A gives the wide plan at r = m
SHAPES = [("classical round", 1), ("K-SVM round", 32), ("K-RR round", 256),
          ("prediction block", 1024), ("full matvec", M),
          ("B a copy of A", -M)]
RMS_SHAPES = [(8192, 2048), (131072, 128)]
STREAM_CHUNK_ROWS = 2048


def _data(torch, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((M, N), generator=gen, device="cuda") / N ** 0.5
    return gen, A, torch.randn((M, 4), generator=gen, device="cuda")


def _b(A, r):
    """The B of a SHAPES entry: A's last r rows, A itself, or its copy."""
    return A if r == M else (A.clone() if r == -M else A[-r:].contiguous())


def parity_stage() -> bool:
    """kmv_cuda against kmv_plain at full width: rbf f32 at every main
    shape, bf16 and the other kernels at the round shapes, c = 1 and 4;
    a second call must give the same bits, and the kernel with its last
    m split left out must fail the check."""
    import torch
    from chip_smoke import TOL_BF16, TOL_KMV_F32, allclose_ratio
    from repro_torch.core.kernels import KernelConfig
    from repro_torch.kernels._launch import check_inputs, sm_count
    from repro_torch.kernels.kmv import kmv_cuda, kmv_plain, kmv_plan, launch
    torch.backends.cuda.matmul.allow_tf32 = False
    _, A, X4 = _data(torch, 0)
    cfgs = {"rbf": KernelConfig("rbf", sigma=1.0),
            "linear": KernelConfig("linear"),
            "polynomial": KernelConfig("polynomial", degree=3, coef0=1.0)}
    ok = True
    for label, r in SHAPES:
        B = _b(A, r)
        r = abs(r)
        for kname, cfg in cfgs.items():
            for dtype in (torch.float32, torch.bfloat16):
                if (kname != "rbf" or dtype != torch.float32) and r > 256:
                    continue
                Ad, Bd = A.to(dtype), B.to(dtype)
                tol = TOL_KMV_F32 if dtype == torch.float32 else TOL_BF16
                for X in (X4[:, 0], X4) if r <= 1024 else (X4[:, 0],):
                    got = kmv_cuda(Ad, Bd, X, cfg)
                    again = kmv_cuda(Ad, Bd, X, cfg)
                    want = kmv_plain(Ad, Bd, X, cfg)
                    ratio, err = allclose_ratio(got, want, tol,
                                                kname == "polynomial")
                    same = bool(torch.equal(got, again))
                    ok &= ratio <= 1.0 and same
                    print(f"[parity] {label} r={r} {kname} {dtype} c="
                          f"{1 if X.ndim == 1 else X.shape[1]}: max abs err "
                          f"{err:.3e} ({ratio:.3f}x tol), repeat "
                          f"{'same bits' if same else 'OTHER BITS'}",
                          flush=True)
        plan = kmv_plan(M, r, 1, sm_count(0), B is A)
        if plan.splits > 1:
            Xc = X4[:, :1].contiguous()
            bad = launch(A, B, Xc, cfgs["rbf"], plan._replace(
                splits=plan.splits - 1), check_inputs("kmv", A, B))
            ratio, err = allclose_ratio(bad, kmv_plain(A, B, Xc,
                                                       cfgs["rbf"]),
                                        TOL_KMV_F32)
            ok &= ratio > 1.0
            print(f"[parity] {label} {plan}: the last split left out reads "
                  f"{ratio:.1f}x tol (must fail)", flush=True)
    return ok & stream_parity(A, X4, cfgs)


def stream_parity(A, X4, cfgs) -> bool:
    """The symmetric streamed full matvec at full width against its plain
    pair loop (rbf f32 at c = 1 and 4, bf16, linear and polynomial at
    c = 1): a second call's bits, and its two wrong variants (one pair's
    mirror product left out, the tail chunk's pair with chunk 0 left out)
    must fail."""
    import torch
    from chip_smoke import TOL_BF16, TOL_KMV_F32, allclose_ratio
    from repro_torch.core.kernels import _chunk
    from repro_torch.kernels.kmv_stream import (full_launch,
                                                kmv_stream_full_cuda,
                                                kmv_stream_full_plain)
    ok = True
    cr = STREAM_CHUNK_ROWS
    for dtype in (torch.float32, torch.bfloat16):
        Xc = _chunk(A.cpu().to(dtype), cr, pin=True)
        tol = TOL_KMV_F32 if dtype == torch.float32 else TOL_BF16
        for kname, cfg in cfgs.items():
            if kname != "rbf" and dtype != torch.float32:
                continue
            for c in (1, 4) if kname == "rbf" else (1,):
                Xvc = _chunk(X4[:, :c].contiguous(), cr)
                got = kmv_stream_full_cuda(Xc, Xvc, cfg, m=M)
                same = bool(torch.equal(got, kmv_stream_full_cuda(
                    Xc, Xvc, cfg, m=M)))
                want = kmv_stream_full_plain(Xc, Xvc, cfg, m=M)
                ratio, err = allclose_ratio(got, want, tol,
                                            kname == "polynomial")
                ok &= ratio <= 1.0 and same
                print(f"[parity] streamed full matvec {kname} {dtype} c={c}"
                      f": max abs err {err:.3e} ({ratio:.3f}x tol), repeat "
                      f"{'same bits' if same else 'OTHER BITS'}", flush=True)
                if dtype == torch.float32 and kname == "rbf" and c == 1:
                    for drop, what in ((1, "pair (0, 1) without its mirror"),
                                       (2, "pair (0, tail) left out")):
                        bad = full_launch(Xc, Xvc, cfg, M, drop=drop)
                        ratio, err = allclose_ratio(bad, want, tol)
                        ok &= ratio > 1.0
                        print(f"[parity] streamed full matvec, {what}: "
                              f"{ratio:.1f}x tol (must fail)", flush=True)
    return ok


def time_stage() -> bool:
    """Device times of the package on sys.path: KMV at the main shapes and
    RMSNorm at the LM's, queued behind a spin kernel (device time) and
    back to back (host included), beside F.rms_norm; the streamed full
    matvec over pinned 2048-row chunks, back to back."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import time_cuda, time_queued
    from repro_torch.core.kernels import KernelConfig, StreamingGramOperator
    from repro_torch.kernels.kmv import kmv_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    gen, A, X4 = _data(torch, 1)
    cfg = KernelConfig("rbf", sigma=1.0)
    X = X4[:, 0].contiguous()
    src = Path(sys.modules["repro_torch"].__file__).parents[1]
    for label, r in SHAPES:
        B = _b(A, r)
        r = abs(r)
        iters = 20 if r <= 256 else (5 if r <= 1024 else 2)
        q = time_queued(lambda: kmv_cuda(A, B, X, cfg), iters) \
            if r <= 1024 else None
        e = time_cuda(lambda: kmv_cuda(A, B, X, cfg), iters)
        flop = 2 * M * r * N
        print(f"[time] {src} kmv {label} r={r}: queued "
              f"{'-' if q is None else f'{q:.4f}'} ms, eager {e:.4f} ms "
              f"({flop / (q or e) / 1e9:.1f} TFLOP/s in the products)",
              flush=True)
    op = StreamingGramOperator.from_dense(A, cfg, STREAM_CHUNK_ROWS,
                                          device="cuda")
    e = time_cuda(lambda: op.full_matvec(X), 3)
    print(f"[time] {src} streamed full matvec, {op.n_chunks} pinned chunks "
          f"of {STREAM_CHUNK_ROWS}: {e:.2f} ms", flush=True)
    del A, op
    for rows, D in RMS_SHAPES:
        x = torch.randn((rows, D), generator=gen, device="cuda").bfloat16()
        s = torch.randn((D,), generator=gen, device="cuda")
        s16 = s.bfloat16()
        k_q = time_queued(lambda: rmsnorm_cuda(x, s), 50)
        k_e = time_cuda(lambda: rmsnorm_cuda(x, s), 50)
        lib = lambda: F.rms_norm(x, (D,), s16, 1e-6)  # noqa: E731
        l_q, l_e = time_queued(lib, 50), time_cuda(lib, 50)
        print(f"[time] {src} rmsnorm ({rows}, {D}) bf16: queued {k_q:.4f} "
              f"ms, eager {k_e:.4f} | F.rms_norm queued {l_q:.4f}, eager "
              f"{l_e:.4f}", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", nargs="?", choices=("parity", "time"))
    ap.add_argument("--src", action="append", default=[],
                    help="another checkout's src directory to time")
    args = ap.parse_args(argv)
    if args.stage:                              # one stage, in a child
        sys.path[:0] = [str(ROOT)]
        if args.src:
            sys.path[:0] = args.src
            from repro_torch.kernels import build
            keep = ("kmv", "kmv_stream", "rmsnorm")
            every = build.sources
            build.sources = lambda: {k: v for k, v in every().items()
                                     if k in keep}
        return 0 if {"parity": parity_stage,
                     "time": time_stage}[args.stage]() else 1
    import torch
    if not torch.cuda.is_available():
        print("kmv_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    info = build.build_all()
    for lib in ("kmv", "kmv_stream", "gram", "rmsnorm"):
        print(f"[build] {lib}: {info[lib]['seconds']:.1f} s")
        for line in info[lib]["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "warning",
                                       "error")):
                print(f"[build]   {line.strip()}")
    # in turns: the others, this checkout twice, the others again
    others = [("time", s) for s in args.src]
    runs = [("parity", None)] + others + [("time", None)] * 2 + others[::-1]
    failed = []
    for stage, src in runs:
        cmd = [sys.executable, str(Path(__file__).resolve()), stage]
        cmd += ["--src", src] if src else []
        try:
            rc = subprocess.run(cmd, timeout=STAGE_SECONDS).returncode
        except subprocess.TimeoutExpired:
            rc = "timed out"
        print(f"[stage] {stage} {src or 'this checkout'}: {rc}", flush=True)
        if rc != 0:
            failed.append(stage)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

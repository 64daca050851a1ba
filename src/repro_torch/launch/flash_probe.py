"""A short first call of the tensor-core flash kernels (forward, dkv, dq)
on the card: build them, show the compiler's register and spill report
and their SASS (HGMMA, UTMALDG), hold them against their plain versions
at small and ragged shapes, and time them beside the FP32-FMA kernels
and SDPA.

    PYTHONPATH=src python -m repro_torch.launch.flash_probe

Each stage runs in a child process with a time limit, so a kernel that
hangs (an mbarrier that never completes) ends that stage, not the run;
the exit code is non-zero if a stage failed or timed out.  Needs a CUDA
card; ``chip_smoke.py`` is the full check of the same kernels on the
LM's path.
"""
from __future__ import annotations

import subprocess
import sys

import torch

STAGE_SECONDS = 150
SHAPES = [(2, 128, 128, 128, True), (2, 256, 256, 128, False),
          (2, 256, 256, 128, True), (2, 17, 17, 128, True),
          (2, 100, 40, 128, False), (2, 100, 40, 128, True),
          (2, 40, 100, 128, True), (4, 512, 512, 64, True),
          (2, 100, 40, 64, False), (8, 2048, 2048, 128, True)]


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def fwd_stage() -> bool:
    """The tensor-core forward against the plain version (the derived
    bound on o, the f32 limits on lse) and the plain version that rounds
    p to bf16."""
    from repro_torch.kernels.flash_attention import (flash_fwd_cuda,
                                                     flash_fwd_plain)
    from repro_torch.kernels.ref import flash_fwd_bf16_tolerance
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for BH, S, T, hd, causal in SHAPES:
        q, k, v = _bf16(gen, BH, S, hd), _bf16(gen, BH, T, hd), _bf16(
            gen, BH, T, hd)
        n0 = flash_fwd_cuda.launches_wgmma
        o, lse = flash_fwd_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_p, lse_p = flash_fwd_plain(q, k, v, causal=causal)
        o_r, _ = flash_fwd_plain(q, k, v, causal=causal, round_p=True)
        e = (o.float() - o_p.float()).abs()
        r_o = float((e / flash_fwd_bf16_tolerance(q, k, v, o_p,
                                                  causal)).max())
        r_l = float(((lse - lse_p).abs()
                     / (2e-5 + 2e-4 * lse_p.abs())).max())
        ok &= r_o <= 1 and r_l <= 1 and flash_fwd_cuda.launches_wgmma == \
            n0 + 1
        print(f"[fwd] {(BH, S, T, hd)} causal={causal}: o max "
              f"{float(e.max()):.3e} ({r_o:.3f}x bound), vs bf16-p plain "
              f"{float((o.float() - o_r.float()).abs().max()):.3e}; lse "
              f"{r_l:.3f}x the f32 limits", flush=True)
    return ok


def dkv_stage() -> bool:
    """The tensor-core dkv kernel against the plain version (the derived
    bounds on dk and dv) and the plain version that rounds p and ds to
    bf16; a second call must give the same bits."""
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_bwd_plain,
                                                     flash_delta,
                                                     flash_fwd_plain)
    from repro_torch.kernels.ref import flash_dkv_bf16_tolerance
    gen = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    for BH, S, T, hd, causal in SHAPES:
        q, k, v, do = (_bf16(gen, BH, n, hd) for n in (S, T, T, S))
        o, lse = flash_fwd_plain(q, k, v, causal=causal)
        delta = flash_delta(o, do)
        got = flash_bwd_cuda(q, k, v, do, lse, delta, causal=causal)
        torch.cuda.synchronize()
        want = flash_bwd_plain(q, k, v, do, lse, delta, causal)
        rounded = flash_bwd_plain(q, k, v, do, lse, delta, causal,
                                  round_p=True)
        tols = flash_dkv_bf16_tolerance(q, k, v, do, lse, delta, want[1],
                                        want[2], causal)
        again = flash_bwd_cuda(q, k, v, do, lse, delta, causal=causal)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        reads = []
        for i, name in ((1, "dk"), (2, "dv")):
            e = (got[i].float() - want[i].float()).abs()
            e_r = (got[i].float() - rounded[i].float()).abs()
            ratio = float((e / tols[i - 1]).max())
            ok &= ratio <= 1
            reads.append(f"{name} max {float(e.max()):.3e} ({ratio:.3f}x "
                         f"bound), vs bf16-p plain {float(e_r.max()):.3e}")
        ok &= same
        print(f"[dkv] {(BH, S, T, hd)} causal={causal}: " + "; ".join(reads)
              + f"; repeats bit for bit: {same}", flush=True)
    return ok


def dq_stage() -> bool:
    """The tensor-core dq kernel against the plain version (the derived
    bound on dq) and the plain version that rounds ds to bf16; a second
    call must give the same bits."""
    from repro_torch.kernels.flash_attention import (flash_bwd_cuda,
                                                     flash_bwd_plain,
                                                     flash_delta,
                                                     flash_fwd_plain)
    from repro_torch.kernels.ref import flash_dq_bf16_tolerance
    gen = torch.Generator(device="cuda").manual_seed(3)
    ok = True
    for BH, S, T, hd, causal in SHAPES:
        q, k, v, do = (_bf16(gen, BH, n, hd) for n in (S, T, T, S))
        o, lse = flash_fwd_plain(q, k, v, causal=causal)
        delta = flash_delta(o, do)
        n0 = flash_bwd_cuda.launches_dq_wgmma
        dq = flash_bwd_cuda(q, k, v, do, lse, delta, causal=causal)[0]
        again = flash_bwd_cuda(q, k, v, do, lse, delta, causal=causal)[0]
        torch.cuda.synchronize()
        want = flash_bwd_plain(q, k, v, do, lse, delta, causal)[0]
        rounded = flash_bwd_plain(q, k, v, do, lse, delta, causal,
                                  round_dq=True)[0]
        tol = flash_dq_bf16_tolerance(q, k, v, do, lse, delta, want, causal)
        e = (dq.float() - want.float()).abs()
        ratio = float((e / tol).max())
        same = torch.equal(dq, again)
        ok &= ratio <= 1 and same and \
            flash_bwd_cuda.launches_dq_wgmma == n0 + 2
        print(f"[dq] {(BH, S, T, hd)} causal={causal}: max "
              f"{float(e.max()):.3e} ({ratio:.3f}x bound), vs bf16-ds plain "
              f"{float((dq.float() - rounded.float()).abs().max()):.3e}; "
              f"repeats bit for bit: {same}", flush=True)
    return ok


def time_stage() -> bool:
    """CUDA-event means at the LM's shapes (bf16, causal, hd 128): the
    tensor-core forward at BH 64 and 32, dkv and dq at BH 32, beside the
    FP32-FMA kernels at the same shapes and SDPA's forward."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_delta
    gen = torch.Generator(device="cuda").manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn, iters=20):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    S, hd, scale = 2048, 128, 128 ** -0.5
    fwd_w, fwd_f = (build.launcher(n) for n in ("flash_fwd_wgmma",
                                                "flash_fwd"))
    dkv_w, dq_w, bwd_f = (build.launcher(n) for n in (
        "flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma", "flash_bwd"))
    for BH in (64, 32):
        q, k, v, do = (_bf16(gen, BH, S, hd) for _ in range(4))
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        lse = torch.empty((BH, S), device="cuda")
        p = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        t_w = ms(lambda: fwd_w(*p, o.data_ptr(), lse.data_ptr(), BH, S, S,
                               hd, 1, scale, stream))
        t_f = ms(lambda: fwd_f(*p, o.data_ptr(), lse.data_ptr(), BH, S, S,
                               hd, hd, 1, 1, scale, stream), 5)
        q4, k4, v4 = (t.view(BH // 16, 16, S, hd) for t in (q, k, v))
        t_s = ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                        is_causal=True))
        flops = 4 * BH * hd * S * (S + 1) / 2
        print(f"[time] flash_fwd ({BH}, {S}, {hd}): tensor-core {t_w:.4f} "
              f"ms ({flops / t_w / 1e9:.1f} TFLOP/s) | FP32-FMA {t_f:.4f} "
              f"| SDPA {t_s:.4f}", flush=True)
        if BH == 32:
            delta = flash_delta(o, do)
            a = p + (do.data_ptr(), lse.data_ptr(), delta.data_ptr())
            t_dw = ms(lambda: dkv_w(*a, dk.data_ptr(), dv.data_ptr(), BH, S,
                                    S, hd, 1, scale, stream))
            t_df = ms(lambda: bwd_f(*a, dq.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), BH, S, S, hd, hd, 1, 1,
                                    scale, 1, stream), 5)
            # four products to the forward's two
            print(f"[time] flash_bwd_dkv ({BH}, {S}, {hd}): tensor-core "
                  f"{t_dw:.4f} ms ({2 * flops / t_dw / 1e9:.1f} TFLOP/s) | "
                  f"FP32-FMA {t_df:.4f}", flush=True)
            t_qw = ms(lambda: dq_w(*a, dq.data_ptr(), BH, S, S, hd, 1,
                                   scale, stream))
            t_qf = ms(lambda: bwd_f(*a, dq.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), BH, S, S, hd, hd, 1, 1,
                                    scale, 0, stream), 5)
            # three products
            print(f"[time] flash_bwd_dq ({BH}, {S}, {hd}): tensor-core "
                  f"{t_qw:.4f} ms ({1.5 * flops / t_qw / 1e9:.1f} TFLOP/s) "
                  f"| FP32-FMA {t_qf:.4f}", flush=True)
    return True


STAGES = {"fwd": fwd_stage, "dkv": dkv_stage, "dq": dq_stage,
          "time": time_stage}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    if argv:                                  # one stage, in a child
        return 0 if STAGES[argv[0]]() else 1
    from repro_torch.kernels import build
    info = build.build_all()
    for lib in ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_bwd_dq_wgmma"):
        print(f"[build] {lib}: {info[lib]['seconds']:.1f} s")
        for line in info[lib]["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print(f"[build]   {line.strip()}")
        for name, ops in build.sass_counts(lib).items():
            print(f"[sass] {lib} {name}: {ops}")
    failed = []
    for stage in STAGES:
        try:
            rc = subprocess.run([sys.executable, "-m",
                                 "repro_torch.launch.flash_probe", stage],
                                timeout=STAGE_SECONDS).returncode
        except subprocess.TimeoutExpired:
            rc = "timed out"
        print(f"[stage] {stage}: {rc}", flush=True)
        if rc != 0:
            failed.append(stage)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""``python -m repro_torch.obs`` — record, audit, and export telemetry
from self-contained demo workloads (the counterpart of ``python -m
repro.obs``).

    python -m repro_torch.obs report              # instrumented solve -> audit
    python -m repro_torch.obs trace --out t.json  # solve + serving -> trace
    python -m repro_torch.obs scrape              # serving -> Prometheus text

Every subcommand fits/serves a small synthetic problem with telemetry
enabled, on the card unless ``--device cpu``; pass --m/--iters to scale
the demo.
"""
from __future__ import annotations

import argparse
import os
import sys


def _data(m: int, seed: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, 16)).astype(np.float32)
    y = (A @ rng.standard_normal(16)).astype(np.float32)
    return torch.tensor(A, device=device), torch.tensor(y, device=device)


def _demo_fit(m: int, iters: int, device):
    from repro_torch.api import KernelRidge, SolverOptions
    from repro_torch.obs import Telemetry

    A, y = _data(m, 0, device)
    tel = Telemetry()
    opts = SolverOptions(method="sstep", s=8, b=8, tol=1e-8,
                         check_every=4, max_iters=iters, guard=True,
                         recompute_every=8, telemetry=tel)
    kr = KernelRidge(lam=1.0, kernel="rbf", options=opts, device=device)
    result = kr.fit(A, y)
    return result, tel


def _demo_serve(m: int, iters: int, tickets: int, device):
    import numpy as np

    from repro_torch.api import KernelRidge, SolverOptions
    from repro_torch.obs import Telemetry
    from repro_torch.serve import ModelRegistry, ServingEngine

    A, y = _data(m, 1, device)
    kr = KernelRidge(lam=1.0, kernel="rbf", device=device,
                     options=SolverOptions(method="sstep", s=8, b=8,
                                           max_iters=iters))
    kr.fit(A, y)
    reg = ModelRegistry(predict_batch=32, device=device)
    reg.register("krr", kr)
    tel = Telemetry()
    engine = ServingEngine(reg, slots=32, telemetry=tel)
    engine.warmup()
    Q = np.random.default_rng(2).standard_normal((tickets, 16)).astype(
        np.float32)
    for i in range(tickets):
        engine.submit("krr", Q[i])
        if (i + 1) % 8 == 0:
            engine.step()
    engine.run_until_idle()
    return engine, tel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="telemetry demos: audit report, Perfetto trace, "
                    "Prometheus scrape")
    # shared demo knobs live on a parent so they parse AFTER the
    # subcommand too (python -m repro_torch.obs report --m 256)
    shared = argparse.ArgumentParser(add_help=False)
    shared.add_argument("--m", type=int, default=192,
                        help="demo problem rows")
    shared.add_argument("--iters", type=int, default=256,
                        help="demo solve iteration budget")
    shared.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("report", parents=[shared],
                   help="instrumented demo solve -> "
                        "modeled-vs-measured audit table")
    p_trace = sub.add_parser("trace", parents=[shared],
                             help="record a solve + serving window, "
                                  "export Chrome trace")
    p_trace.add_argument("--out", default="repro_trace.json",
                         help="output trace path")
    p_scrape = sub.add_parser("scrape", parents=[shared],
                              help="serving drive -> Prometheus text "
                                   "exposition")
    p_scrape.add_argument("--tickets", type=int, default=64)
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)

    if args.cmd == "report":
        from repro_torch.obs.audit import audit_fit
        result, _tel = _demo_fit(args.m, args.iters, device)
        print(audit_fit(result).render())
        return 0

    if args.cmd == "trace":
        from repro_torch.obs.export import save_trace
        result, tel = _demo_fit(args.m, args.iters, device)
        engine, stel = _demo_serve(args.m, args.iters, 32, device)
        # both windows ride one trace: merge the serving log into the
        # solve handle (timestamps share the perf_counter clock)
        tel.spans.extend(stel.spans)
        tel.marks.extend(stel.marks)
        path = save_trace(os.path.abspath(args.out), tel)
        print(f"wrote {path} ({len(tel.spans)} spans, "
              f"{len(tel.marks)} marks) — open in ui.perfetto.dev")
        return 0

    # scrape
    engine, tel = _demo_serve(args.m, args.iters, args.tickets, device)
    sys.stdout.write(tel.metrics.to_prometheus_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())

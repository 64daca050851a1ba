"""``python -m repro_torch.analysis``: run the analyzers and exit 1 on
any unsuppressed finding (the counterpart of ``python -m
repro.analysis``).

    python -m repro_torch.analysis                 # every analyzer
    python -m repro_torch.analysis --only kernel   # a subset
    python -m repro_torch.analysis --list-checks   # the check catalog
    python -m repro_torch.analysis --json          # findings as JSON

On a machine with a CUDA card the kernel analyzer launches every
registered entry point for real; without one it records the plans its
stub launchers are handed (``analysis.registry``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from . import ANALYZERS, CHECKS, render_report, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel sanitizer + capture lint + collective auditor")
    ap.add_argument("--only", action="append", choices=ANALYZERS,
                    help="run a subset (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of the report")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the check catalog and exit")
    args = ap.parse_args(argv)

    if args.list_checks:
        for check, (analyzer, sev, what, jax) in sorted(CHECKS.items()):
            print(f"{check:10s} {analyzer:7s} {sev:8s} {what} "
                  f"(JAX: {jax})")
        return 0

    findings = run_all(only=args.only)
    if args.json:
        print(json.dumps([dataclasses.asdict(f) for f in findings],
                         indent=2))
    else:
        print(render_report(findings))
    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())

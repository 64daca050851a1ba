"""Modeled-vs-measured reconciler (the counterpart of
``repro/obs/audit.py``).

``audit_fit`` takes a ``FitResult`` whose solve recorded telemetry and
reconciles where the time actually went against where
``perf_model.modeled_fit_cost`` said it would go, as a per-phase report.

Phase mapping (modeled bucket <- measured evidence):

  setup       ``comm["setup_time"]`` (Nystrom build; 0 for exact)
              <- host spans with phase "setup" (representation_build)
  compute     ``t_comp - setup_time`` (gram slab + epilogue flops)
              <- solve-phase span time minus the in-loop check/correct
              intervals paired from the marks
  collective  ``t_band + t_lat`` <- not separable on a single device;
              reported modeled-only, measured merged into compute
  check       unpriced by the model (tolerance checks are a protocol
              choice, not an algorithm cost) <- paired "metric_check"
              begin/end marks
  correct     ``guard_overhead(...) * compute`` at the resolved
              cadence <- paired "drift_correction" marks

Each phase's MEASURED SHARE of the measured total is compared with its
MODELED SHARE of the modeled total; a phase whose measured evidence
exists and deviates more than ``tol`` (absolute share points) is
FLAGGED.  The report also carries the total measured/modeled ratio.

On the card the check and correction intervals are device times of
their own captured graphs (``obs/spans.py``); on the CPU they are host
times around the eager calls.  The model's machine constants are the
reference's (``perf_model.Machine``), so the ratio says how far the
card is from them, not how good the model is.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.perf_model import guard_overhead

CHECK_SPAN = "metric_check"
CORRECT_SPAN = "drift_correction"


@dataclasses.dataclass
class PhaseRow:
    """One reconciled phase: seconds and shares on both sides, the
    share deviation (measured - modeled), and the flag.  ``measured_s``
    is None when the run produced no separable evidence for the phase
    (then the row is informational and never flagged)."""

    phase: str
    modeled_s: float
    modeled_share: float
    measured_s: Optional[float]
    measured_share: Optional[float]
    deviation: Optional[float]
    flagged: bool
    note: str = ""


@dataclasses.dataclass
class AuditReport:
    """The per-phase reconciliation ``audit_fit`` returns."""

    rows: List[PhaseRow]
    measured_total_s: float
    modeled_total_s: float
    tol: float

    @property
    def ratio(self) -> float:
        """measured / modeled total time."""
        if self.modeled_total_s <= 0:
            return float("nan")
        return self.measured_total_s / self.modeled_total_s

    @property
    def flagged(self) -> List[PhaseRow]:
        return [r for r in self.rows if r.flagged]

    def to_dict(self) -> dict:
        return {"rows": [dataclasses.asdict(r) for r in self.rows],
                "measured_total_s": self.measured_total_s,
                "modeled_total_s": self.modeled_total_s,
                "ratio": self.ratio, "tol": self.tol,
                "flagged": [r.phase for r in self.flagged]}

    def render(self) -> str:
        hdr = (f"{'phase':<12} {'modeled_s':>10} {'share':>7} "
               f"{'measured_s':>11} {'share':>7} {'dev':>7}  flag")
        lines = [hdr, "-" * len(hdr)]
        for r in self.rows:
            ms = "-" if r.measured_s is None else f"{r.measured_s:.4g}"
            sh = "-" if r.measured_share is None \
                else f"{r.measured_share:.1%}"
            dv = "-" if r.deviation is None else f"{r.deviation:+.1%}"
            lines.append(
                f"{r.phase:<12} {r.modeled_s:>10.4g} "
                f"{r.modeled_share:>7.1%} {ms:>11} {sh:>7} {dv:>7}  "
                f"{'FLAG' if r.flagged else ''}")
        lines.append(f"total: measured {self.measured_total_s:.4g}s vs "
                     f"modeled {self.modeled_total_s:.4g}s "
                     f"(ratio {self.ratio:.2f}, tol {self.tol:.0%})")
        return "\n".join(lines)


def _fit_window(tel):
    """The last recorded top-level "fit" span — one handle can record
    several solves; the audit reads the most recent."""
    fits = [s for s in tel.spans if s.phase == "fit"]
    return fits[-1] if fits else None


def _within(spans, window):
    if window is None:
        return list(spans)
    return [s for s in spans if s.t0 >= window.t0 - 1e-9
            and s.t1 <= window.t1 + 1e-9]


def audit_fit(result, telemetry=None, *, tol: float = 0.25
              ) -> AuditReport:
    """Reconcile ``result`` (a ``FitResult``) against its recorded
    telemetry (``result.telemetry`` unless an explicit handle is
    passed).  Raises ``ValueError`` when the run recorded nothing —
    fit with ``SolverOptions(telemetry=True)`` first."""
    tel = telemetry if telemetry is not None else \
        getattr(result, "telemetry", None)
    if tel is None or (not tel.spans and not tel.marks):
        raise ValueError(
            "audit_fit needs a recorded solve: fit with "
            "SolverOptions(telemetry=True) (or telemetry=<Telemetry>) "
            "and pass the resulting FitResult")

    window = _fit_window(tel)
    spans = _within(tel.spans, window)
    paired = _within(tel.paired_marks(), window)

    measured_setup = sum(s.duration for s in spans
                         if s.phase == "setup")
    solve_s = sum(s.duration for s in spans if s.phase == "solve")
    check_s = sum(s.duration for s in paired if s.name == CHECK_SPAN)
    correct_s = sum(s.duration for s in paired if s.name == CORRECT_SPAN)
    # in-loop intervals are inside the solve spans; keep buckets disjoint
    compute_s = max(solve_s - check_s - correct_s, 0.0)
    measured_total = (window.duration if window is not None
                      else max(getattr(result, "wall_time_s", 0.0),
                               measured_setup + solve_s))

    comm = result.comm
    modeled_setup = float(comm.get("setup_time", 0.0))
    modeled_compute = max(float(comm["t_comp"]) - modeled_setup, 0.0)
    modeled_coll = float(comm.get("t_band", 0.0)) \
        + float(comm.get("t_lat", 0.0))
    opts = getattr(result, "options", None)
    modeled_correct = 0.0
    rec = getattr(opts, "recompute_every", 0) if opts is not None else 0
    if isinstance(rec, int) and rec >= 1 and "m" in comm:
        frac = guard_overhead(
            int(comm["m"]), int(comm["n"]), comm.get("kernel", "rbf"),
            b=int(comm.get("b", 1)), s=int(comm.get("s", 1)),
            P=int(comm.get("P", 1)), recompute_every=rec,
            approx=comm.get("approx"),
            landmarks=int(comm.get("landmarks", 0)))
        modeled_correct = frac * modeled_compute
    modeled_total = (modeled_setup + modeled_compute + modeled_coll
                     + modeled_correct)

    def share(x, total):
        return x / total if total > 0 else 0.0

    rows = []
    for phase, mod_s, meas_s, note in (
            ("setup", modeled_setup, measured_setup, ""),
            ("compute", modeled_compute, compute_s,
             "measured includes unseparable collectives"),
            ("collective", modeled_coll, None,
             "not separable on one device; merged into measured compute"),
            ("check", 0.0, check_s, "unpriced by the model"),
            ("correct", modeled_correct, correct_s, "")):
        mshare = share(mod_s, modeled_total)
        if meas_s is None:
            rows.append(PhaseRow(phase, mod_s, mshare, None, None, None,
                                 False, note))
            continue
        pshare = share(meas_s, measured_total)
        dev = pshare - mshare
        rows.append(PhaseRow(phase, mod_s, mshare, meas_s, pshare, dev,
                             abs(dev) > tol, note))
    return AuditReport(rows=rows, measured_total_s=measured_total,
                       modeled_total_s=modeled_total, tol=tol)

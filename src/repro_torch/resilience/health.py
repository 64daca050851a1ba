"""Structured health records of guarded solves (the counterpart of
``repro/resilience/health.py``).

``SolveHealth`` is the host-side ledger ``fit`` attaches to
``FitResult.health`` when ``SolverOptions.guard`` is on: the relative
residual drift observed at every correction, every divergence and
fallback event the escalation ladder walked, and the checkpoint and
resume bookkeeping.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# What the guard observed (HealthEvent.kind).
KIND_NONFINITE = "nonfinite"       # NaN/Inf appeared in the carry
KIND_METRIC = "metric"             # gap/residual blow-up or non-finite
KIND_RESUME = "resume"             # solve restored from a checkpoint


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One guard observation and the action taken on it.

    kind:      "nonfinite" | "metric" | "resume".
    round_idx: 0-based outer round (within the whole solve) of the first
               unhealthy round: its update was discarded and the solve
               went on from the carry before it.
    iter_idx:  the matching inner-iteration offset into the schedule.
    action:    what the executor did: "halve_s:16->8" | "classical" |
               "f64" | "resume".
    detail:    free-form context (the checkpoint path, ...).
    """

    kind: str
    round_idx: int
    iter_idx: int
    action: str
    detail: str = ""


@dataclasses.dataclass
class SolveHealth:
    """Everything the guarded executor observed across one ``fit``.

    guarded:          the guard was on.
    recompute_every:  the resolved drift-correction cadence in outer
                      rounds (0 = correction off).
    drift:            (n_corrections,) relative drift at each residual
                      replacement, across segments and fallbacks in
                      execution order.
    corrections:      == len(drift).
    events:           every HealthEvent in execution order.
    checkpoints:      snapshots written by this fit.
    resumed_from:     the checkpoint directory the solve restored from,
                      or None.
    """

    guarded: bool = False
    recompute_every: int = 0
    drift: Optional[np.ndarray] = None
    corrections: int = 0
    events: Tuple[HealthEvent, ...] = ()
    checkpoints: int = 0
    resumed_from: Optional[str] = None

    @property
    def max_drift(self) -> float:
        """Largest observed relative residual drift (0.0 when no
        correction ran)."""
        if self.drift is None or len(self.drift) == 0:
            return 0.0
        return float(np.max(self.drift))

    @property
    def fallbacks(self) -> Tuple[HealthEvent, ...]:
        """The events where the escalation ladder fired."""
        return tuple(e for e in self.events
                     if e.kind in (KIND_NONFINITE, KIND_METRIC))

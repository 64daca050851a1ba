"""The device half of guarded solves (the counterpart of
``repro/resilience/guard.py``).

``core.loop.run_rounds(guard=GuardSpec(...))`` consumes these: the
health predicate runs after every round on the new carry (an unhealthy
update is discarded and the loop freezes on the last good state), and
the correction closure replaces the recurrence-maintained residual
``f`` with an exact ``f = K @ alpha`` through the operator (one full
KMV, never a stored gram), recording the relative drift.

The escalation ladder is the host-side policy the facade walks when a
guarded run reports divergence: halve s (down to s = 1), then the
classical method, then f64 accumulation.  Every rung solves the same
problem, so a fallback resumes from the last good state.
"""
from __future__ import annotations

from typing import Tuple

import torch


class DivergenceError(RuntimeError):
    """A guarded solve diverged and the escalation ladder was exhausted
    (or fallback was disabled).  ``events`` holds the ``HealthEvent``s
    the run observed before giving up."""

    def __init__(self, message: str, events: tuple = ()):
        super().__init__(message)
        self.events = events


def finite_health(state) -> torch.Tensor:
    """0-dim bool tensor: every leaf of the carry is finite.  Device
    reductions only; nothing is read on the host, so a captured round
    can run it."""
    leaves = (state,) if isinstance(state, torch.Tensor) else tuple(state)
    ok = torch.isfinite(leaves[0]).all()
    for leaf in leaves[1:]:
        ok = ok & torch.isfinite(leaf).all()
    return ok


def init_residual(op, alpha0: torch.Tensor) -> torch.Tensor:
    """``f_0 = K @ alpha_0`` through the operator.  A cold start (alpha_0
    all zero) skips the matvec; this reads alpha_0 on the host once,
    before the rounds, as the JAX package does."""
    if not bool(alpha0.any()):
        return torch.zeros_like(alpha0)
    return op.full_matvec(alpha0)


def make_correct_fn(op):
    """``correct_fn(state) -> (state', drift)`` for ``GuardSpec``:
    residual replacement.  ``drift`` is the relative error of the
    recurrence-maintained residual against the exact recompute."""

    def correct_fn(state):
        alpha, f = state
        f_exact = op.full_matvec(alpha)
        drift = (torch.linalg.vector_norm(f - f_exact)
                 / (torch.linalg.vector_norm(f_exact) + 1e-30))
        return (alpha, f_exact), drift

    return correct_fn


# Escalation-ladder rungs, in the order the facade tries them.
LADDER_HALVE_S = "halve_s"
LADDER_CLASSICAL = "classical"
LADDER_F64 = "f64"


def next_fallback(s: int, method: str, x64: bool
                  ) -> Tuple[str, int, str, bool]:
    """One rung down the ladder from the current (s, method, x64) state:
    ``(action, s', method', x64')``.  Raises ``DivergenceError`` when the
    ladder is exhausted (already classical and f64).  s halves down to 1,
    then the method drops to classical, then accumulation widens to
    f64."""
    if method == "sstep" and s > 1:
        s2 = max(1, s // 2)
        return (f"{LADDER_HALVE_S}:{s}->{s2}", s2, method, x64)
    if method == "sstep":
        return (LADDER_CLASSICAL, 1, "classical", x64)
    if not x64:
        return (LADDER_F64, s, method, True)
    raise DivergenceError(
        "escalation ladder exhausted: classical method in f64 "
        "accumulation still diverges — the problem data or "
        "regularization is pathological")

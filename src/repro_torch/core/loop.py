"""Shared round-protocol loop for the solvers (the counterpart of
``repro/core/loop.py``).

Every solver is a state (alpha), a per-round transition
``round_fn(state, xs_k) -> state`` and a schedule of per-round data
``xs``.  ``run_rounds`` drives them:

  * fast path (``metric_fn=None``): a plain loop over the rounds,
    optionally stacking per-round states (the ``lax.scan`` of the JAX
    package);
  * tolerance path (``metric_fn`` given): evaluates ``metric_fn(state)``
    every ``check_every`` rounds and at the final round, records it into
    a fixed-size history, and stops once the metric falls to ``tol``
    (the ``lax.while_loop``).  The metric is read on the host only at
    those checks; rounds in between never synchronise.

``pad_rounds`` pads a ragged schedule to whole s-step rounds with a
validity mask, so the final short round makes exactly-zero updates.
The guarded and fleet drivers are later slices of the port.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.device import as_tensor

NO_TOL = float("-inf")        # sentinel: record the metric, never stop early

Rounds = Union[torch.Tensor, Sequence[torch.Tensor]]


class LoopResult(NamedTuple):
    """Output of ``run_rounds``.

    state:       final solver state (alpha).
    state_hist:  per-round stacked states (fast path + record_state) or
                 None.
    metric_hist: (n_check_slots,) metric values (tolerance path; only the
                 first ``checks_run`` slots were evaluated) or None.
    checks_run:  number of metric evaluations performed.
    rounds_run:  number of rounds executed.
    converged:   metric <= tol at some check.
    """

    state: Any
    state_hist: Optional[torch.Tensor]
    metric_hist: Optional[torch.Tensor]
    checks_run: int
    rounds_run: int
    converged: bool

    def metric_history(self) -> Optional[torch.Tensor]:
        """The evaluated prefix ``metric_hist[:checks_run]``, or None when
        no metric was recorded (fast path)."""
        if self.metric_hist is None:
            return None
        return self.metric_hist[:self.checks_run]


def pad_rounds(schedule: torch.Tensor, s: int):
    """Reshape an (H, ...) schedule into ((R, s, ...), (R, s)) rounds plus
    validity mask with R = ceil(H/s); padded slots carry index 0 and
    valid 0.0, so the masked round functions make them exact no-ops."""
    H = schedule.shape[0]
    R = -(-H // s)
    pad = R * s - H
    if pad:
        schedule = torch.cat([schedule, schedule.new_zeros(
            (pad,) + tuple(schedule.shape[1:]))])
    valid = (torch.arange(R * s, device=schedule.device) < H).to(
        torch.float32)
    return (schedule.reshape((R, s) + tuple(schedule.shape[1:])),
            valid.reshape(R, s))


def _n_rounds(xs: Rounds) -> int:
    return (xs if isinstance(xs, torch.Tensor) else xs[0]).shape[0]


def _round(xs: Rounds, k: int):
    if isinstance(xs, torch.Tensor):
        return xs[k]
    return tuple(x[k] for x in xs)


def run_rounds(round_fn: Callable, state0: Any, xs: Rounds, *,
               tol: float = NO_TOL, check_every: int = 1,
               metric_fn: Optional[Callable] = None,
               record_state: bool = False) -> LoopResult:
    """Drive ``R = len(xs)`` rounds of ``round_fn`` (module docstring).

    ``xs`` is a tensor, or a tuple of tensors, with a shared leading
    round axis.  ``metric_fn(state)`` returns a 0-dim tensor; pass
    ``tol=NO_TOL`` to record it without ever stopping.
    """
    R = _n_rounds(xs)
    state = state0

    if metric_fn is None:
        hist = []
        for k in range(R):
            state = round_fn(state, _round(xs, k))
            if record_state:
                hist.append(state)
        state_hist = torch.stack(hist) if (record_state and hist) else None
        return LoopResult(state, state_hist, None, 0, R, False)

    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    n_checks = -(-R // check_every)
    hist = None
    nchk, k, converged = 0, 0, False
    while k < R and not converged:
        state = round_fn(state, _round(xs, k))
        k += 1
        if k % check_every == 0 or k == R:
            v = metric_fn(state)
            if hist is None:
                hist = torch.full((n_checks,), float("inf"),
                                  dtype=v.dtype, device=v.device)
            hist[nchk] = v
            nchk += 1
            converged = bool(v <= tol)          # the check's host sync
    if hist is None:                            # empty schedule: no checks
        hist = torch.zeros(0)
    return LoopResult(state, None, hist, nchk, k, converged)


def as_schedule(schedule, device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """A coordinate schedule as int64 indices on ``device`` — the JAX
    package's schedules are int32, torch indexing takes int64.  Arrays
    are copied (a JAX array's numpy view is read-only)."""
    return as_tensor(schedule).to(device=device, dtype=torch.long)
